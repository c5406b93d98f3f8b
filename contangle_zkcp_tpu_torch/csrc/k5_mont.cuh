// Montgomery multiply with its two constant products on Hopper's int8
// tensor cores, redesigned: the multiply under K5a (k5a_mont_mul_mma.cu)
// and the NTT passes of K5b (k5b_ntt_mma.cu).  k5_mma.cuh's first design
// stays under K5c and the one-stage K5b butterfly.
//
// The same algorithm as k5_mma.cuh (the reference's matrix-unit mode,
// contangle_zkcp_tpu/ops/pallas_mont.py mont_mul_kernel_body with mxu):
// T = a b on the integer pipe, then m = (T mod R) N' mod R and T + m p, the
// two products by a constant, as Toeplitz matrices of the constant's bytes
// times the byte planes of the variable operand, on
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32 (exact: every column sum is
// below 4W * 255^2 < 2^23).  What changed, and why:
//
//   * Every m-tile of a constant product goes to shared memory in ONE
//     staging round, with one warp barrier, instead of one round and two
//     barriers per m-tile: 4 __syncwarp a multiply (Fr: 14 before).
//   * The B fragments (the variable operand's words, 4 groups x KS k-steps
//     x 2 registers) are read from the staged rows once a product and kept
//     in registers across its m-tiles, not read again for each m-tile.
//   * The A rows of a tile are ordered so that the two rows a lane holds,
//     g and g + 8, are the output bytes 2g and 2g + 1: the lane adds them
//     into one halfword sum (c0 + c2 2^8 < 2^32), so half as many values
//     cross shared memory (8 a lane an m-tile, 32-bit stores that hit 32
//     distinct banks), and the owner reads them back as whole int4 rows.
//     The host builds this table (ops/mont_mma.py mma_fragments_hw),
//     beside K5c's.
//   * Each lane keeps its A fragments of the used tiles in registers
//     (load_tiles: 16 bytes a tile from device memory, once a thread,
//     before the kernel's grid-stride loop), shared by the warp's four
//     groups: no block-wide copy to shared memory, no __syncthreads, and
//     no shared-memory load an mma.
//   * The a b schoolbook, the fold of the sums and the final subtract run
//     as PTX carry chains (mad.lo.cc / madc.hi.cc, add.cc / addc) instead
//     of 64-bit arithmetic that nvcc emulates word by word.
//
// Layout.  A warp owns 32 elements, one per lane.  The owner stages its
// operand's W words (zero-padded to KW) in its row of the warp's B area;
// lane (g, t) then holds words 8ks + t and 8ks + t + 4 of element 8j + g
// (group j = 0..3, the n = 8 columns of the mma) for each k-step.  The
// C fragment of group j gives lane (g, t) the halfword sums g of elements
// 8j + 2t and 8j + 2t + 1, which it stores to those elements' rows of the
// C area; after the barrier each owner folds its row, low to high.
//
// mma.sync is warp-collective: every lane of the warp runs every product,
// lanes past the end of the batch on zeros, and only the stores are
// masked.  Nothing here may return early.

#pragma once

#include <cstdint>

#include "k5_mma.cuh"  // mma_u8, tile_used, load_live, k5_smem_attr (unchanged)

template <int W>
struct MontMma {
  static constexpr int KW = (W + 7) / 8 * 8;  // input words, padded to whole k-steps
  static constexpr int KS = KW / 8;           // k-steps of 32 bytes
  static constexpr int MT_NP = W / 4;         // m-tiles of (T mod R) * N' mod R: 4W bytes
  static constexpr int MT_P = W / 2;          // m-tiles of m * p: 8W bytes
  static constexpr int TILES = (MT_NP + MT_P) * KS;
  static constexpr int BS = KW + 4;           // staged word row (words): 16-byte rows, no conflicts
  static constexpr int CS = 8 * MT_P + 4;     // halfword-sum row (words), = 4 mod 16
  static constexpr int WARP_WORDS = 32 * (BS + CS);
  static_assert(CS % 16 == 4, "C rows of 4 mod 16 words keep the stores conflict-free");
};

// Shared memory of a block of `warps` warps, in bytes.
template <int W>
constexpr size_t mont_mma_smem(int warps) {
  return (size_t)warps * MontMma<W>::WARP_WORDS * sizeof(uint32_t);
}

// Whether tile k of the table (the N' product's MT_NP x KS tiles, then
// p's MT_P x KS) holds a nonzero entry.
template <int W>
__host__ __device__ constexpr bool table_tile_used(int k) {
  using S = MontMma<W>;
  return k < S::MT_NP * S::KS ? tile_used(k / S::KS, k % S::KS, W)
                              : tile_used((k - S::MT_NP * S::KS) / S::KS, k % S::KS, W);
}

// The lane's A fragments of the used tiles, from the host-built table
// (ops/mont_mma.py mma_fragments_hw); the others stay unread.
template <int W>
__device__ __forceinline__ void load_tiles(const uint4* __restrict__ frag,
                                           uint4 (&A)[MontMma<W>::TILES]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < MontMma<W>::TILES; ++k)
    A[k] = table_tile_used<W>(k) ? __ldg(frag + k * 32 + lane) : make_uint4(0, 0, 0, 0);
}

// Per-warp view: its B and C areas in the block's shared memory (at `base`,
// 16-byte aligned, warps side by side), the lane, and the lane's A
// fragments (load_tiles' array: indexed with constants only, so it stays
// in registers).
template <int W>
struct MontWarp {
  uint32_t* B;
  uint32_t* C;
  const uint4* A;
  int lane;

  __device__ MontWarp(uint32_t* base, const uint4 (&tiles)[MontMma<W>::TILES])
      : B(base + (threadIdx.x >> 5) * MontMma<W>::WARP_WORDS),
        C(base + (threadIdx.x >> 5) * MontMma<W>::WARP_WORDS + 32 * MontMma<W>::BS),
        A(tiles), lane((int)(threadIdx.x & 31)) {}
};

// Blocks for n elements, one a lane, 128 a block: at most 16 blocks an
// SM, more than the registers let run at once, so that a grid-stride loop
// runs once a thread at the paths' sizes while every thread's fragment
// loads still serve all the elements it takes.
inline unsigned k5_mont_grid(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long blocks = (n + K5_THREADS - 1) / K5_THREADS;
  const long long cap = 16LL * sms;
  return (unsigned)(blocks < cap ? blocks : cap);
}

// ---------------------------------------------------------- carry chains
// One asm statement an instruction, volatile so that the compiler keeps
// their order: the carry flag lives between them.

// T = a * b, 2W words: row i adds a * b[i] at word i, its low halves on
// one carry chain and its high halves on a second, one word up.  The
// running sum of rows 0..i fits in W + i + 1 words, so the second chain
// never carries out of word i + W.
template <int W>
__device__ __forceinline__ void mul_wide(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                         uint32_t (&T)[2 * W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) asm("mul.lo.u32 %0, %1, %2;" : "=r"(T[j]) : "r"(a[j]), "r"(b[0]));
  T[W] = 0;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(T[1]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int j = 1; j < W - 1; ++j)
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(T[j + 1]) : "r"(a[j]), "r"(b[0]));
  asm volatile("madc.hi.u32 %0, %1, %2, %0;" : "+r"(T[W]) : "r"(a[W - 1]), "r"(b[0]));
#pragma unroll
  for (int i = 1; i < W; ++i) {
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(T[i]) : "r"(a[0]), "r"(b[i]));
#pragma unroll
    for (int j = 1; j < W; ++j)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(T[i + j]) : "r"(a[j]), "r"(b[i]));
    asm volatile("addc.u32 %0, 0, 0;" : "=r"(T[i + W]));
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(T[i + 1]) : "r"(a[0]), "r"(b[i]));
#pragma unroll
    for (int j = 1; j < W - 1; ++j)
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(T[i + j + 1]) : "r"(a[j]), "r"(b[i]));
    asm volatile("madc.hi.u32 %0, %1, %2, %0;" : "+r"(T[i + W]) : "r"(a[W - 1]), "r"(b[i]));
  }
}

// d = a - b; returns the borrow out (0 or 1).
template <int W>
__device__ __forceinline__ uint32_t sub_words(const uint32_t (&a)[W], const uint32_t* b,
                                              uint32_t (&d)[W]) {
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int j = 1; j < W; ++j)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d[j]) : "r"(a[j]), "r"(b[j]));
  uint32_t borrow;
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(borrow));
  return borrow & 1;
}

// s = a + b; returns the carry out (0 or 1).
template <int W>
__device__ __forceinline__ uint32_t add_words(const uint32_t (&a)[W], const uint32_t* b,
                                              uint32_t (&s)[W]) {
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(s[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int j = 1; j < W; ++j)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(s[j]) : "r"(a[j]), "r"(b[j]));
  uint32_t carry;
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(carry));
  return carry;
}

// r = a + b mod p and r = a - b mod p, canonical in and out (mont.cuh's
// mod_add and mod_sub on the carry chains).
template <int W>
__device__ __forceinline__ void add_mod(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                        uint32_t (&r)[W], const FieldConst<W>& F) {
  uint32_t s[W], d[W];
  const uint32_t carry = add_words<W>(a, b, s);
  const uint32_t borrow = sub_words<W>(s, F.p, d);
  const bool take = carry || !borrow;
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = take ? d[j] : s[j];
}

template <int W>
__device__ __forceinline__ void sub_mod(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                        uint32_t (&r)[W], const FieldConst<W>& F) {
  uint32_t d[W], e[W];
  const uint32_t borrow = sub_words<W>(a, b, d);
  add_words<W>(d, F.p, e);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = borrow ? e[j] : d[j];
}

// word = h0 + h1 2^16 + add + carry, its low 32 bits; carry becomes the
// rest (h0, h1 < 2^32, so the carry stays below 2^17 + 3).
__device__ __forceinline__ uint32_t fold_word(uint32_t h0, uint32_t h1, uint32_t add,
                                              uint32_t& carry) {
  uint32_t lo, hi;
  asm("{\n\t"
      ".reg .u32 s, r;\n\t"
      "shl.b32 s, %3, 16;\n\t"
      "shr.u32 r, %3, 16;\n\t"
      "add.cc.u32 %0, %2, s;\n\t"
      "addc.u32 %1, r, 0;\n\t"
      "add.cc.u32 %0, %0, %4;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "add.cc.u32 %0, %0, %5;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "}"
      : "=&r"(lo), "=&r"(hi)
      : "r"(h0), "r"(h1), "r"(add), "r"(carry));
  carry = hi;
  return lo;
}

// ------------------------------------------------------ constant products

// The owner writes the low W words of x (zero-padded to KW) to its B row.
template <int W, int N>
__device__ __forceinline__ void stage_row(const MontWarp<W>& w, const uint32_t (&x)[N]) {
  using S = MontMma<W>;
  uint4* row = reinterpret_cast<uint4*>(w.B + w.lane * S::BS);
#pragma unroll
  for (int q = 0; q < S::KW / 4; ++q) {
    const int j = 4 * q;
    row[q] = make_uint4(j < W ? x[j] : 0u, j + 1 < W ? x[j + 1] : 0u,
                        j + 2 < W ? x[j + 2] : 0u, j + 3 < W ? x[j + 3] : 0u);
  }
}

// The B fragments of the staged rows: bf[j][ks] = words 8ks + t and
// 8ks + t + 4 of element 8j + g.
template <int W>
__device__ __forceinline__ void load_b(const MontWarp<W>& w,
                                       uint32_t (&bf)[4][MontMma<W>::KS][2]) {
  using S = MontMma<W>;
  const int g = w.lane >> 2, t = w.lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int ks = 0; ks < S::KS; ++ks) {
      const uint32_t* col = w.B + (8 * j + g) * S::BS + 8 * ks + t;
      bf[j][ks][0] = col[0];
      bf[j][ks][1] = col[4];
    }
}

// The halfword sums of (constant * staged operand), MT m-tiles from the
// table's tile TILE0, into the C rows: slot 8 mt + g of an element's row
// is the sum for its output bytes 16 mt + 2g and 16 mt + 2g + 1.
template <int W, int MT, int TILE0>
__device__ __forceinline__ void const_sums(const MontWarp<W>& w,
                                           const uint32_t (&bf)[4][MontMma<W>::KS][2]) {
  using S = MontMma<W>;
  const int g = w.lane >> 2, t = w.lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks)
        if (tile_used(mt, ks, W))
          mma_u8(acc, w.A[TILE0 + mt * S::KS + ks], bf[j][ks][0], bf[j][ks][1]);
      // rows g, g + 8 = output bytes 2g, 2g + 1; columns 2t, 2t + 1
      uint32_t* c = w.C + (8 * j + 2 * t) * S::CS + 8 * mt + g;
      c[0] = (uint32_t)acc[0] + ((uint32_t)acc[2] << 8);
      c[S::CS] = (uint32_t)acc[1] + ((uint32_t)acc[3] << 8);
    }
  }
}

// out = the owner's folded sums (+ add), N = 4 MT words, low to high;
// returns the carry out of the top word.
template <int W, int MT, int N, bool ADD>
__device__ __forceinline__ uint32_t fold_row(const MontWarp<W>& w, const uint32_t (&add)[N],
                                             uint32_t (&out)[N]) {
  static_assert(4 * MT == N, "one word of output per 4 output bytes");
  const uint4* mine = reinterpret_cast<const uint4*>(w.C + w.lane * MontMma<W>::CS);
  uint32_t carry = 0;
#pragma unroll
  for (int q = 0; q < 2 * MT; ++q) {
    const uint4 v = mine[q];  // halfwords 4q .. 4q + 3: words 2q, 2q + 1
    out[2 * q] = fold_word(v.x, v.y, ADD ? add[2 * q] : 0u, carry);
    out[2 * q + 1] = fold_word(v.z, v.w, ADD ? add[2 * q + 1] : 0u, carry);
  }
  return carry;
}

// r = a * b * R^-1 mod p, canonical, for canonical a, b (K1's value, bit
// for bit); r may alias a or b.  Warp-collective: every lane must call it.
template <int W>
__device__ __forceinline__ void mont_mul_tc(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                            uint32_t (&r)[W], const FieldConst<W>& F,
                                            const MontWarp<W>& w) {
  using S = MontMma<W>;
  uint32_t T[2 * W];
  mul_wide<W>(a, b, T);
  uint32_t bf[4][S::KS][2];
  stage_row<W>(w, T);  // T mod R
  __syncwarp();
  load_b<W>(w, bf);
  const_sums<W, S::MT_NP, 0>(w, bf);
  __syncwarp();
  uint32_t m[W];
  fold_row<W, S::MT_NP, W, false>(w, m, m);  // m = (T mod R) N' mod R
  stage_row<W>(w, m);
  __syncwarp();
  load_b<W>(w, bf);
  const_sums<W, S::MT_P, S::MT_NP * S::KS>(w, bf);
  __syncwarp();
  uint32_t u[2 * W];
  const uint32_t top = fold_row<W, S::MT_P, 2 * W, true>(w, T, u);
  // u = T + m p = 0 mod R, and u / R < 2p: one conditional subtract.
  uint32_t hi[W], d[W];
#pragma unroll
  for (int j = 0; j < W; ++j) hi[j] = u[W + j];
  const uint32_t borrow = sub_words<W>(hi, F.p, d);
  const bool take = top || !borrow;
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = take ? d[j] : hi[j];
}
