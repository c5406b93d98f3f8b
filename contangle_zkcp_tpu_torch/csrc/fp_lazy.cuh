// Lazily reduced Montgomery arithmetic on 32-bit words, in PTX carry
// chains, for the two point-add kernels K3 (k3_sw_add.cu) and K5c
// (k5c_sw_add_mma.cu).  K1, K2 and K4 keep mont.cuh.
//
// Layout as mont.cuh (load_elem / store_elem): W 32-bit words, little-
// endian, Montgomery form with R = 2^(32 W).
//
// Two arithmetics, a template flag S of the kernels (false: lazy, true:
// strict), which the wrapper (ops/curve_add.py kernel_b3) picks from p
// alone: lazy when 4p < R, strict otherwise.
//
// Strict (S = true): every value canonical in [0, p) after each add,
// subtract and multiply, with mont.cuh's mont_mul, mod_add and mod_sub,
// which keep the carry out of the top word and so are right for any
// p < R: the Pasta fields (255-bit primes at W = 8, 2p < R < 4p) and
// fields with 2p >= R such as secp256k1's.  K5c's tensor-core multiply
// keeps the carry out of (T + m p) / R and subtracts p once
// (k5c_sw_add_mma.cu group_reduce).  No output needs `canon`.
//
// Lazy reduction (S = false).  Between operations a value lies in
// [0, 2p), not in [0, p).  That is sound when 4p < R, which holds for
// BLS12-381 Fq (p < 2^381, W = 12) and BN254 Fq (p < 2^254, W = 8), the
// G1 fields of the Groth16 path.  Step by step:
//   mul  a, b < 2p.  Row i of CIOS leaves T_i = (T_{i-1} + a b_i + m_i p)
//        / 2^32 < a + p < 3p, by induction: (a + p + (a + p)(2^32 - 1))
//        / 2^32 = a + p; before the shift T_{i-1} + a b_i + m_i p <
//        3p 2^32 < 2^32 R, so it fits W + 1 words.  The result (a b +
//        m p) / R < 4p^2 / R + p < 2p: no final subtract.
//   add  a, b < 2p: a + b < 4p < R fits W words; 2p is subtracted when
//        the sum reaches it.
//   sub  a, b < 2p: a - b lies in (-2p, 2p); 2p is added on a borrow.
//   add_nr  a, b < p (canonical limbs, as loaded): a + b < 2p, no
//        subtract.
//   canon  [0, 2p) -> [0, p): one conditional subtract of p, once per
//        output coordinate, just before its store, so the stored limbs
//        are the unique canonical ones.
//   mul_small<K>  K y mod p for 3b = K in {9, 12} as a chain of `add`s,
//        each in [0, 2p): 12 y = ((y + y) + y) 4, 9 y = 8 y + y.  The same
//        residue as the Montgomery product of 3b R mod p and y.
// The formula's sequence (RCB Algorithm 7, a = 0) in these terms, inputs
// canonical (< p):
//   t0, t1, t2 = X1 X2, Y1 Y2, Z1 Z2                    mul of < p: < 2p
//   t3 = sub((X1 + Y1)(X2 + Y2), add(t0, t1))           add_nr, mul: < 2p
//   t4 = sub((Y1 + Z1)(Y2 + Z2), add(t1, t2))           likewise
//   y3p = sub((X1 + Z1)(X2 + Z2), add(t0, t2))          likewise
//   t2b, y3b = 3b t2, 3b y3p                           mul_small or mul
//   Z3p, t1p = add(t1, t2b), sub(t1, t2b)
//   t0p = add(add(t0, t0), t0)
//   X3 = canon(sub(t3 t1p, t4 y3b)), Y3 = canon(add(t1p Z3p, y3b t0p)),
//   Z3 = canon(add(Z3p t4, t0p t3))
// so every operand of every operation is below 2p.
// tests/test_torch_curve_lazy.py replays this schedule, and mul's rows
// word by word, in Python integers and checks each bound.
//
// The multiply is CIOS with the row products split into an even and an
// odd accumulator (the products a_j b_i for even j land on disjoint word
// pairs, as do those for odd j), so each row is two independent carry
// chains of W multiply-adds; the two accumulators trade places every row
// (see mul_row).

#pragma once

#include <cstdint>

#include "mont.cuh"

template <int W>
struct LazyConst {
  uint32_t p[W];   // modulus
  uint32_t p2[W];  // 2p (< R)
  uint32_t n0;     // -p^-1 mod 2^32
};

template <int W>
__host__ inline LazyConst<W> make_lazy(const uint32_t* p, uint32_t n0) {
  LazyConst<W> F;
  uint32_t carry = 0;
  for (int j = 0; j < W; ++j) {
    F.p[j] = p[j];
    F.p2[j] = (p[j] << 1) | carry;
    carry = p[j] >> 31;
  }
  F.n0 = n0;
  return F;
}

// ---------------------------------------------------------------- PTX
// One instruction each, volatile so that a chain keeps its order in the
// PTX; ptxas renames the carry flag and schedules the chains.
#define ZK_ASM2(name, op)                                                  \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {       \
    uint32_t r;                                                            \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));            \
    return r;                                                              \
  }
#define ZK_ASM3(name, op)                                                  \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,         \
                                           uint32_t c) {                   \
    uint32_t r;                                                            \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                              \
  }
ZK_ASM2(add_cc, "add.cc.u32")
ZK_ASM2(addc_cc, "addc.cc.u32")
ZK_ASM2(addc, "addc.u32")
ZK_ASM2(sub_cc, "sub.cc.u32")
ZK_ASM2(subc_cc, "subc.cc.u32")
ZK_ASM2(subc, "subc.u32")
ZK_ASM3(mad_lo_cc, "mad.lo.cc.u32")
ZK_ASM3(madc_lo_cc, "madc.lo.cc.u32")
ZK_ASM3(madc_hi_cc, "madc.hi.cc.u32")
ZK_ASM3(madc_hi, "madc.hi.u32")
#undef ZK_ASM2
#undef ZK_ASM3

// ------------------------------------------------------------ add, sub
// r = a + b, no reduction (callers: a + b < R).
template <int W>
__device__ __forceinline__ void add_nr(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                       uint32_t (&r)[W]) {
  r[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) r[j] = addc_cc(a[j], b[j]);
  r[W - 1] = addc(a[W - 1], b[W - 1]);
}

// r = x - c if x >= c else x, for x < 2c (c = p or 2p).
template <int W>
__device__ __forceinline__ void csub(const uint32_t (&x)[W], const uint32_t (&c)[W],
                                     uint32_t (&r)[W]) {
  uint32_t d[W];
  d[0] = sub_cc(x[0], c[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) d[j] = subc_cc(x[j], c[j]);
  const uint32_t borrow = subc(0u, 0u);  // 0, or all ones when x < c
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = borrow ? x[j] : d[j];
}

// r = a + b mod 2p-lazily: a, b < 2p -> r < 2p.
template <int W>
__device__ __forceinline__ void add(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                    uint32_t (&r)[W], const LazyConst<W>& F) {
  uint32_t s[W];
  add_nr<W>(a, b, s);
  csub<W>(s, F.p2, r);
}

// r = a - b, plus 2p on a borrow: a, b < 2p -> r < 2p.
template <int W>
__device__ __forceinline__ void sub(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                    uint32_t (&r)[W], const LazyConst<W>& F) {
  uint32_t d[W];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t mask = subc(0u, 0u);
  r[0] = add_cc(d[0], F.p2[0] & mask);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) r[j] = addc_cc(d[j], F.p2[j] & mask);
  r[W - 1] = addc(d[W - 1], F.p2[W - 1] & mask);
}

// [0, 2p) -> canonical [0, p).
template <int W>
__device__ __forceinline__ void canon(uint32_t (&x)[W], const LazyConst<W>& F) {
  csub<W>(x, F.p, x);
}


// ------------------------------------------------------------ multiply
// The accumulator of CIOS is E + 2^32 O: E (W words) at word offset 0,
// O (W words) at offset 1.  A row adds a b_i (even j into E, odd j into
// O), m p likewise with m = E[0] n0, which clears word 0, and divides
// by 2^32.  After the division O sits at offset 0 and becomes the next
// row's E; the old E sits at offset -1 with E[0] = 0: its word E[1]
// (now at offset 0) is folded into the new E[0], and the rest, E[2..],
// moves down two words to become the next O, inside the chain that adds
// the next odd products.  Carries out of an odd chain are zero (the
// value bound in the header comment); those out of an even chain, at
// most 1 each, go into the top word of O, which sits at the same
// position.

// m p for m = E[0] n0, and the even chain's carry into O's top word.
template <int W>
__device__ __forceinline__ void mul_reduce(uint32_t (&E)[W], uint32_t (&O)[W],
                                           const LazyConst<W>& F) {
  const uint32_t m = E[0] * F.n0;
  O[0] = mad_lo_cc(F.p[1], m, O[0]);
  O[1] = madc_hi_cc(F.p[1], m, O[1]);
#pragma unroll
  for (int j = 2; j < W - 2; j += 2) {
    O[j] = madc_lo_cc(F.p[j + 1], m, O[j]);
    O[j + 1] = madc_hi_cc(F.p[j + 1], m, O[j + 1]);
  }
  O[W - 2] = madc_lo_cc(F.p[W - 1], m, O[W - 2]);
  O[W - 1] = madc_hi(F.p[W - 1], m, O[W - 1]);
  // E[0] + lo(m p0) = 0 mod 2^32, with a carry exactly when E[0] != 0
  (void)add_cc(E[0], 0xffffffffu);
  E[1] = madc_hi_cc(F.p[0], m, E[1]);
#pragma unroll
  for (int j = 2; j < W; j += 2) {
    E[j] = madc_lo_cc(F.p[j], m, E[j]);
    E[j + 1] = madc_hi_cc(F.p[j], m, E[j + 1]);
  }
  O[W - 1] = addc(O[W - 1], 0u);
}

// Row 0: E, O = the even and odd products of a b0.
template <int W>
__device__ __forceinline__ void mul_row0(uint32_t (&E)[W], uint32_t (&O)[W],
                                         const uint32_t (&a)[W], uint32_t b0,
                                         const LazyConst<W>& F) {
#pragma unroll
  for (int j = 0; j < W; j += 2) {
    E[j] = a[j] * b0;
    E[j + 1] = __umulhi(a[j], b0);
    O[j] = a[j + 1] * b0;
    O[j + 1] = __umulhi(a[j + 1], b0);
  }
  mul_reduce<W>(E, O, F);
}

// Row i >= 1: E enters as the previous O, O as the previous E (the
// previous row's division by 2^32 is done here, see above).
template <int W>
__device__ __forceinline__ void mul_row(uint32_t (&E)[W], uint32_t (&O)[W],
                                        const uint32_t (&a)[W], uint32_t bi,
                                        const LazyConst<W>& F) {
  E[0] = add_cc(E[0], O[1]);
#pragma unroll
  for (int j = 0; j < W - 2; j += 2) {
    O[j] = madc_lo_cc(a[j + 1], bi, O[j + 2]);
    O[j + 1] = madc_hi_cc(a[j + 1], bi, O[j + 3]);
  }
  O[W - 2] = madc_lo_cc(a[W - 1], bi, 0u);
  O[W - 1] = madc_hi(a[W - 1], bi, 0u);
  E[0] = mad_lo_cc(a[0], bi, E[0]);
  E[1] = madc_hi_cc(a[0], bi, E[1]);
#pragma unroll
  for (int j = 2; j < W; j += 2) {
    E[j] = madc_lo_cc(a[j], bi, E[j]);
    E[j + 1] = madc_hi_cc(a[j], bi, E[j + 1]);
  }
  O[W - 1] = addc(O[W - 1], 0u);
  mul_reduce<W>(E, O, F);
}

// r = a b R^-1 mod p, lazily: a, b < 2p -> r < 2p.  r may alias a or b.
template <int W>
__device__ __forceinline__ void mul(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                    uint32_t (&r)[W], const LazyConst<W>& F) {
  static_assert(W % 2 == 0, "W even: the rows pair up");
  uint32_t x[W], y[W];
  mul_row0<W>(x, y, a, b[0], F);
#pragma unroll
  for (int i = 1; i < W; i += 2) {
    mul_row<W>(y, x, a, b[i], F);
    if (i + 1 < W) mul_row<W>(x, y, a, b[i + 1], F);
  }
  // after row W - 1 (odd): E = y at offset 0 (y[0] = 0), O = x at offset
  // 1; divide by 2^32
  r[0] = add_cc(x[0], y[1]);
#pragma unroll
  for (int k = 1; k < W - 1; ++k) r[k] = addc_cc(x[k], y[k + 1]);
  r[W - 1] = addc(x[W - 1], 0u);
}

// ------------------------------------------- the kernels' operations
// Each picks the lazy or the strict arithmetic by S (see the top).

// r = a b R^-1 mod p.
template <int W, bool S>
__device__ __forceinline__ void fmul(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                     uint32_t (&r)[W], const LazyConst<W>& F) {
  if constexpr (S) mont_mul<W>(a, b, r, F); else mul<W>(a, b, r, F);
}

// r = a + b mod p.
template <int W, bool S>
__device__ __forceinline__ void fadd(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                     uint32_t (&r)[W], const LazyConst<W>& F) {
  if constexpr (S) mod_add<W>(a, b, r, F); else add<W>(a, b, r, F);
}

// r = a - b mod p.
template <int W, bool S>
__device__ __forceinline__ void fsub(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                     uint32_t (&r)[W], const LazyConst<W>& F) {
  if constexpr (S) mod_sub<W>(a, b, r, F); else sub<W>(a, b, r, F);
}

// r = a + b for canonical a, b (inputs as loaded): below 2p unreduced
// when lazy, reduced when strict.
template <int W, bool S>
__device__ __forceinline__ void fadd_in(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                        uint32_t (&r)[W], const LazyConst<W>& F) {
  if constexpr (S) mod_add<W>(a, b, r, F); else add_nr<W>(a, b, r);
}

// An output coordinate made canonical before its store (strict: it is).
template <int W, bool S>
__device__ __forceinline__ void fcanon(uint32_t (&x)[W], const LazyConst<W>& F) {
  if constexpr (!S) canon<W>(x, F);
}

// r = K y mod p for K = 3b in {9, 12}, as a chain of adds.
template <int W, int K, bool S>
__device__ __forceinline__ void mul_small(const uint32_t (&y)[W], uint32_t (&r)[W],
                                          const LazyConst<W>& F) {
  static_assert(K == 9 || K == 12, "addition chains exist for 3b = 9 and 12");
  uint32_t t[W];
  fadd<W, S>(y, y, t, F);  // 2y
  if (K == 12) {
    fadd<W, S>(t, y, t, F);  // 3y
    fadd<W, S>(t, t, t, F);  // 6y
    fadd<W, S>(t, t, r, F);  // 12y
  } else {
    fadd<W, S>(t, t, t, F);  // 4y
    fadd<W, S>(t, t, t, F);  // 8y
    fadd<W, S>(t, y, r, F);  // 9y
  }
}

// 3b y: the addition chain when 3b is 9 or 12 (B3), else the Montgomery
// product with 3b R mod p (B3 = 0).
template <int W, int B3, bool S>
__device__ __forceinline__ void mul_b3(const uint32_t (&b3m)[W], const uint32_t (&y)[W],
                                       uint32_t (&r)[W], const LazyConst<W>& F) {
  if constexpr (B3 == 0) {
    fmul<W, S>(b3m, y, r, F);
  } else {
    mul_small<W, B3, S>(y, r, F);
  }
}

// x - p when x + 2^(32 W) top >= p, else x: a product (T + m p) / R of
// canonical operands, below 2p, whose bit 32 W is `top`.
template <int W>
__device__ __forceinline__ void csub_top(uint32_t (&x)[W], uint32_t top, const LazyConst<W>& F) {
  uint32_t d[W];
  d[0] = sub_cc(x[0], F.p[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) d[j] = subc_cc(x[j], F.p[j]);
  const uint32_t borrow = subc(0u, 0u);
  const bool take = top || !borrow;
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = take ? d[j] : x[j];
}

// An element loaded again (the first load's registers were let go): a
// volatile load, so the compiler neither merges it with the first one
// nor keeps the first alive for it.
template <int W>
__device__ __forceinline__ void reload_elem(const int32_t* __restrict__ src, uint32_t (&x)[W]) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    int4 v;
    asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(src + 4 * i));
    x[2 * i] = (uint32_t)(v.x & 0xffff) | ((uint32_t)v.y << 16);
    x[2 * i + 1] = (uint32_t)(v.z & 0xffff) | ((uint32_t)v.w << 16);
  }
}
