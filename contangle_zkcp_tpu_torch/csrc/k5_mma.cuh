// The int8 tensor-core pieces of the K5 kernels: the tiling of a
// Montgomery multiply's two constant products (MmaShape, tile_used), the
// mma itself, and the launch helpers.  K5c (k5c_sw_add_mma.cu) builds its
// grouped products from them with the natural-order table; K5a and K5b's
// multiply (k5_mont.cuh) takes the tiling and the mma.
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
// integer accumulation (every column sum is below 4W * 255^2 < 2^23).
//
// Layout.  A warp owns 32 elements, one per lane, as K1 does; the matrix
// product works on 8 elements at a time (the n = 8 columns of B).
//   A (16 x 32 bytes, rows = output bytes, columns = input bytes): the
//     constant's Toeplitz tiles, arranged in fragment order by the host
//     (ops/mont_mma.py mma_fragments): fragment [tile][lane] is one
//     16-byte load.
//   B (32 x 8 bytes, column n = element n): in natural byte order the
//     fragment registers are whole 32-bit words of the element (lane
//     (g, t) holds words t and t + 4 of element g of the k-slice), so each
//     owner stages its words in a per-warp shared row and the four lanes
//     of its column read them back.
//   C (16 x 8 s32): rows are output bytes, columns elements; the sums are
//     staged per warp and every owner folds its own, low to high, so
//     carries run in order.
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
__device__ __forceinline__ void load_live(const int32_t* __restrict__ src, bool live,
                                          uint32_t (&x)[W]) {
  if (live) {
    load_elem<W>(src, x);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = 0;
  }
}

// Allow a kernel `bytes` of dynamic shared memory (past the 48 KB a launch
// gets without asking); the launchers call it once per instantiation.
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
