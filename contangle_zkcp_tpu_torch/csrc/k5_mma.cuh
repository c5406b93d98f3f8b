// Montgomery multiply with its two constant products on Hopper's int8
// tensor cores, shared by the K5 kernels (k5a_mont_mul_mma.cu,
// k5b_butterfly_mma.cu, k5c_sw_add_mma.cu).
//
// The reference's matrix-unit mode (contangle_zkcp_tpu/ops/pallas_mont.py
// _const_byte_planes / _toeplitz_cat / _mxu_const_product_cols, used by
// mont_mul_kernel_body when mxu is set): of the three products of a
// Montgomery multiply, m = (T mod R) * N' mod R and m * p have a constant
// operand.  A product by a constant is a Toeplitz matrix of the
// constant's bytes applied to the byte planes of the variable operand, so
// both run as matrix products; the a*b schoolbook and the carries stay on
// the integer pipe.  Here the matrix product is
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32: unsigned bytes, exact 32-bit
// integer accumulation (every column sum is below 4W * 255^2 < 2^22).
//
// Layout.  A warp owns 32 elements, one per lane, as K1 does; the matrix
// product works on 8 elements at a time (the n = 8 columns of B).
//   A (16 x 32 bytes, rows = output bytes, columns = input bytes): the
//     constant's Toeplitz tiles, arranged in fragment order by the host
//     (ops/mont_mma.py mma_fragments) and copied to shared memory once per
//     block: fragment [tile][lane] is one 16-byte load.
//   B (32 x 8 bytes, column n = element n): in natural byte order the
//     fragment registers are whole 32-bit words of the element (lane
//     (g, t) holds words t and t + 4 of element g of the k-slice), so each
//     owner stages its words in a per-warp shared row and the four lanes
//     of its column read them back.
//   C (16 x 8 s32): rows are output bytes, columns elements; each m-tile's
//     sums are staged per warp and every owner folds its own 16 sums into
//     4 words of its result, low to high, so carries run in order and
//     no more than one m-tile of sums is ever held.
// Row strides of the staging areas are padded so that the stores and the
// fragment reads hit 32 distinct banks.
//
// mma.sync is warp-collective: every lane of the warp runs every product,
// lanes past the end of the batch on zeros, and only the stores are
// masked.  Nothing here may return early.

#pragma once

#include <cstdint>

#include "mont.cuh"

constexpr int K5_WARPS = 4;  // warps per block
constexpr int K5_THREADS = 32 * K5_WARPS;

template <int W>
struct MmaShape {
  static constexpr int KW = (W + 7) / 8 * 8;  // input words, padded to whole k-steps
  static constexpr int KS = KW / 8;           // k-steps of 32 bytes
  static constexpr int MT_NP = W / 4;         // m-tiles of (T mod R) * N' mod R: 4W bytes
  static constexpr int MT_P = W / 2;          // m-tiles of m * p: 8W bytes
  static constexpr int TILES = (MT_NP + MT_P) * KS;
  static constexpr int BS = KW + 4;           // staged word row stride (words)
  static constexpr int CS = 20;               // staged column-sum row stride (16 used)
};

template <int W>
struct MmaSmem {
  uint4 A[MmaShape<W>::TILES * 32];
  uint32_t B[K5_WARPS][32 * MmaShape<W>::BS];
  int32_t C[K5_WARPS][32 * MmaShape<W>::CS];
};

// Per-warp view of the block's shared memory.
template <int W>
struct MmaWarp {
  const uint4* A;
  uint32_t* B;
  int32_t* C;
  int lane;
};

// A 16 x 32 tile of a Toeplitz matrix of 4W constant bytes by 4W input
// bytes holds a nonzero entry (structural zeros are skipped at compile
// time: the mod-R product is lower triangular, and Fq's padded k-step only
// meets the top rows).
__host__ __device__ constexpr bool tile_used(int mt, int ks, int W) {
  return 32 * ks < 4 * W && 16 * mt + 15 >= 32 * ks &&
         16 * mt - (32 * ks + 31 < 4 * W - 1 ? 32 * ks + 31 : 4 * W - 1) < 4 * W;
}

__device__ __forceinline__ void mma_u8(int32_t (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Copy the host-built fragments (TILES * 32 uint4) into shared memory;
// the caller synchronises the block afterwards.
template <int W>
__device__ __forceinline__ void load_fragments(uint4* dst, const uint4* __restrict__ src) {
  for (int i = threadIdx.x; i < MmaShape<W>::TILES * 32; i += blockDim.x) dst[i] = src[i];
}

template <int W>
__device__ __forceinline__ MmaWarp<W> warp_view(MmaSmem<W>& sm) {
  const int warp = threadIdx.x >> 5;
  return MmaWarp<W>{sm.A, sm.B[warp], sm.C[warp], (int)(threadIdx.x & 31)};
}

// The owner writes the low W words of x (zero-padded to KW) to its row.
template <int W, int N>
__device__ __forceinline__ void stage_words(const MmaWarp<W>& w, const uint32_t (&x)[N]) {
  using S = MmaShape<W>;
  uint4* row = reinterpret_cast<uint4*>(w.B + w.lane * S::BS);
#pragma unroll
  for (int q = 0; q < S::KW / 4; ++q) {
    const int j = 4 * q;
    row[q] = make_uint4(j < W ? x[j] : 0u, j + 1 < W ? x[j + 1] : 0u,
                        j + 2 < W ? x[j + 2] : 0u, j + 3 < W ? x[j + 3] : 0u);
  }
}

// out = (constant * staged operand) + add, word by word, for the lane's
// own element; MT m-tiles of 16 output bytes give 4 MT words; TILE0 is
// the constant's first tile in the fragment table.  Returns the carry out
// of the top word.
template <int W, int MT, int TILE0, int N, bool ADD>
__device__ __forceinline__ uint32_t const_product(const MmaWarp<W>& w,
                                                  const uint32_t (&add)[N],
                                                  uint32_t (&out)[N]) {
  using S = MmaShape<W>;
  static_assert(4 * MT == N, "one word of output per 4 output bytes");
  const int g = w.lane >> 2, t = w.lane & 3;
  uint64_t carry = 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the warp's 4 groups of 8 elements
      int32_t acc[4] = {0, 0, 0, 0};
      const uint32_t* col = w.B + (8 * j + g) * S::BS + t;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks)
        if (tile_used(mt, ks, W))
          mma_u8(acc, w.A[(TILE0 + mt * S::KS + ks) * 32 + w.lane], col[8 * ks],
                 col[8 * ks + 4]);
      // C fragment: rows g and g + 8, columns 2t and 2t + 1
      int32_t* c = w.C + (8 * j + 2 * t) * S::CS + g;
      c[0] = acc[0];
      c[S::CS] = acc[1];
      c[8] = acc[2];
      c[S::CS + 8] = acc[3];
    }
    __syncwarp();
    const int4* mine = reinterpret_cast<const int4*>(w.C + w.lane * S::CS);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 v = mine[q];  // output bytes 16 mt + 4q .. + 3, each < 2^22
      uint64_t s = carry + (uint64_t)(uint32_t)v.x + ((uint64_t)(uint32_t)v.y << 8) +
                   ((uint64_t)(uint32_t)v.z << 16) + ((uint64_t)(uint32_t)v.w << 24);
      if (ADD) s += add[4 * mt + q];
      out[4 * mt + q] = (uint32_t)s;
      carry = s >> 32;
    }
    __syncwarp();
  }
  return (uint32_t)carry;
}

// Full product T = a * b, 2W words (operand scanning on the integer pipe).
template <int W>
__device__ __forceinline__ void mul_full(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                         uint32_t (&T)[2 * W]) {
#pragma unroll
  for (int j = 0; j < 2 * W; ++j) T[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t s = (uint64_t)a[j] * b[i] + T[i + j] + c;
      T[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    T[i + W] = (uint32_t)c;
  }
}

// r = a * b * R^-1 mod p, canonical, for canonical a, b (the same value
// as mont.cuh mont_mul).  Warp-collective: every lane must call it.
template <int W>
__device__ __forceinline__ void mont_mul_mma(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                             uint32_t (&r)[W], const FieldConst<W>& F,
                                             const MmaWarp<W>& w) {
  using S = MmaShape<W>;
  uint32_t T[2 * W];
  mul_full<W>(a, b, T);
  stage_words<W>(w, T);  // T mod R
  __syncwarp();
  uint32_t m[W];
  const_product<W, S::MT_NP, 0, W, false>(w, m, m);  // m = (T mod R) N' mod R
  stage_words<W>(w, m);
  __syncwarp();
  uint32_t u[2 * W];
  const uint32_t top = const_product<W, S::MT_P, S::MT_NP * S::KS, 2 * W, true>(w, T, u);
  // u = T + m p = 0 mod R, and u / R < 2p: one conditional subtract.
  uint32_t d[W];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t s = (uint64_t)u[W + j] - F.p[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool take = top || !borrow;
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = take ? d[j] : u[W + j];
}

template <int W>
__device__ __forceinline__ void load_live(const int32_t* __restrict__ src, bool live,
                                          uint32_t (&x)[W]) {
  if (live) {
    load_elem<W>(src, x);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = 0;
  }
}

// Allow a kernel `bytes` of dynamic shared memory (MmaSmem<W> is 52,224
// bytes at W = 24, past the 48 KB a launch gets without asking); the
// launchers call it once per instantiation.
template <class K>
inline cudaError_t k5_smem_attr(K* kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
             : cudaSuccess;
}

// Blocks for n elements: one warp iteration covers 32, and the grid is
// capped at 8 blocks per SM so that each block's fragment copy serves
// several iterations.
inline unsigned k5_grid(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long blocks = (n + K5_THREADS - 1) / K5_THREADS;
  const long long cap = 8LL * sms;
  return (unsigned)(blocks < cap ? blocks : cap);
}
