// Montgomery field arithmetic for one CUDA thread, shared by the three
// kernels of this directory (k1_mont_mul.cu, k2_butterfly.cu,
// k3_sw_add.cu).
//
// Boundary layout (the JAX package's, fields/fp.py): an element is L
// 16-bit limbs, little-endian, canonical in [0, p), Montgomery form with
// R = 2^(16 L), one limb per int32.  Inside a thread the element is W = L/2
// 32-bit words: limb pairs packed on load, unpacked on store.  R is the
// same 2^(32 W), so the product a*b*R^-1 mod p is bit-equal to the
// reference's.
//
// The multiply is word-serial CIOS (Koc, Acar, Kaliski 1996) with 64-bit
// accumulators, which nvcc lowers to mad.lo/mad.hi carry chains; W is a
// template constant, so every loop unrolls and the words stay in registers.

#pragma once

#include <cstdint>

template <int W>
struct FieldConst {
  uint32_t p[W];   // modulus, 32-bit words, little-endian
  uint32_t n0;     // -p^-1 mod 2^32
};

template <int W>
__device__ __forceinline__ void load_elem(const int32_t* __restrict__ src,
                                          uint32_t (&x)[W]) {
  // 2W int32 limbs = 8W bytes; rows are 16-byte aligned for even W
  // (the wrappers check the base pointer).
  const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const int4 v = s4[i];
    x[2 * i] = (uint32_t)(v.x & 0xffff) | ((uint32_t)v.y << 16);
    x[2 * i + 1] = (uint32_t)(v.z & 0xffff) | ((uint32_t)v.w << 16);
  }
}

template <int W>
__device__ __forceinline__ void store_elem(int32_t* __restrict__ dst,
                                           const uint32_t (&x)[W]) {
  int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    int4 v;
    v.x = (int32_t)(x[2 * i] & 0xffff);
    v.y = (int32_t)(x[2 * i] >> 16);
    v.z = (int32_t)(x[2 * i + 1] & 0xffff);
    v.w = (int32_t)(x[2 * i + 1] >> 16);
    d4[i] = v;
  }
}

// r = a * b * R^-1 mod p, canonical, for canonical a, b.  C is any
// constant block with the modulus words p[W] and n0 (FieldConst, or the
// point adds' LazyConst); r may alias a or b.
template <int W, class C = FieldConst<W>>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[W],
                                         const uint32_t (&b)[W],
                                         uint32_t (&r)[W],
                                         const C& F) {
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[W] + c;
    t[W] = (uint32_t)s;
    t[W + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F.n0;
    s = (uint64_t)m * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < W; ++j) {
      s = (uint64_t)m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[W] + c;
    t[W - 1] = (uint32_t)s;
    t[W] = t[W + 1] + (uint32_t)(s >> 32);
  }
  // t < 2p: one conditional subtract.
  uint32_t d[W];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t s = (uint64_t)t[j] - F.p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool take = (t[W] != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = take ? d[j] : t[j];
}

// r = a + b mod p (canonical in, canonical out; p < 2^(32W - 1) is not
// assumed: the carry out of the top word is kept).
template <int W, class C = FieldConst<W>>
__device__ __forceinline__ void mod_add(const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        uint32_t (&r)[W],
                                        const C& F) {
  uint32_t s[W];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t v = (uint64_t)a[j] + b[j] + carry;
    s[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
  uint32_t d[W];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t v = (uint64_t)s[j] - F.p[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool take = carry || !borrow;
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = take ? d[j] : s[j];
}

// r = a - b mod p.
template <int W, class C = FieldConst<W>>
__device__ __forceinline__ void mod_sub(const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        uint32_t (&r)[W],
                                        const C& F) {
  uint32_t d[W];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  uint32_t carry = 0;
  uint32_t e[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t v = (uint64_t)d[j] + F.p[j] + carry;
    e[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = borrow ? e[j] : d[j];
}

template <int W>
__host__ inline FieldConst<W> make_field(const uint32_t* p, uint32_t n0) {
  FieldConst<W> F;
  for (int j = 0; j < W; ++j) F.p[j] = p[j];
  F.n0 = n0;
  return F;
}

inline unsigned grid_for(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}
