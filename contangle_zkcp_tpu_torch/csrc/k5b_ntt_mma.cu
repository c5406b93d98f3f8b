// K5b, redesigned: several stages of the radix-2 NTT a launch, the array's
// tile in shared memory, every field multiply with its two constant
// products on the int8 tensor cores; the bit reversal and the coset and
// 1/n scalings fused into the first and last pass.  The matrix-unit
// counterpart of k2_ntt.cu (K2's passes), equal to it limb for limb.
//
// Replaces the TPU kernel contangle_zkcp_tpu/ops/pallas_mont.py:325
// MontMulLanes._bf_kernel_mxu (MontMulLanes.butterfly_t with mxu set),
// launched once a stage by the reference's NTT in the matrix-unit mode,
// for ALL the stages of the port's transform under ZKCP_MXU=1
// (ops/ntt.py, through ops/mont_mma.py ntt_pass_mma; its plain torch
// version is ntt_pass_mma_plain).  One launch runs stages s0 .. s0+t-1
// over the whole array (or a batch of B arrays) with ntt_tile.cuh's tiles,
// index maps and launch geometry, the same as K2's: the first pass gathers
// through the bit reversal and may multiply by pre[src] (g^src of
// coset_forward), the last may multiply by post[i] or the scalar post[0]
// (n^-1, n^-1 g^-i), so the output equals the stage loop followed by F.mul.
//
// What bounds it on an H100: the integer pipe, as K2.  A butterfly is one
// Montgomery product (the W^2 multiply-adds of a*b, the fold of 3W words
// of column sums, 6 mma.sync per 8 products at W = 8: far below the int8
// rate) plus a modular add and subtract.  Design: K2's pass structure, with
// the work of a stage dealt to warps in rounds of 32 butterflies, since
// mma.sync is warp-collective: every lane of a block's warps runs every
// multiply, lanes past the end of a round (n = 2 and 4, and the pre- and
// post-scales of small tiles) on zeros, never storing; up to 4 warps a
// block; the multiply is k5_mont.cuh's (per-warp B and C areas after the
// tile in shared memory, each lane's constant fragments in registers for
// the whole launch, the carries on PTX chains), and the add and subtract
// are its carry chains too.  W = 8 only, as K2.

#include <cuda_runtime.h>

#include "k5_mont.cuh"
#include "ntt_tile.cuh"

namespace {

constexpr int K5B_NTT_WARPS = 4;  // warps a block at most (a round: 32 butterflies a warp)

template <int W>
__global__ void __launch_bounds__(32 * K5B_NTT_WARPS)
k5b_ntt_kernel(NttPass P, FieldConst<W> F, const uint4* __restrict__ frag) {
  extern __shared__ __align__(16) uint32_t sm[];
  const NttTile T(P);
  const int S = T.S;
  uint4 A[MontMma<W>::TILES];
  load_tiles<W>(frag, A);
  const MontWarp<W> w(sm + W * S, A);  // W * S words: a multiple of 4
  const int warp0 = threadIdx.x & ~31;  // rounds are warp-uniform: blockDim is a multiple of 32

  ntt_load_tile<W>(P, T, sm);
  __syncthreads();

  // x = x * scale for every slot of the tile (pre: by source index, post:
  // by index, or the one row)
  auto scale = [&](const uint32_t* __restrict__ by, bool pre) {
    for (int base = warp0; base < T.tile; base += blockDim.x) {
      const int e = base + w.lane;
      const bool live = e < T.tile;
      uint32_t x[W], y[W];
      if (live) {
        smem_get<W>(sm, S, e, x);
        const long long row = pre ? T.source(T.index(e)) : (P.post_vec ? T.index(e) : 0LL);
        load_words<W>(by + row * W, y);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) x[k] = y[k] = 0;
      }
      mont_mul_tc<W>(x, y, x, F, w);
      if (live) smem_put<W>(sm, S, e, x);
    }
    __syncthreads();
  };

  if (P.pre) scale(P.pre, true);

  for (int ls = 0; ls < T.t; ++ls) {
    for (int base = warp0; base < T.tile / 2; base += blockDim.x) {
      const int b = base + w.lane;
      const bool live = b < T.tile / 2;
      int pu = 0, pv = 0;
      uint32_t x[W], y[W], tw[W], vw[W];
      if (live) {
        long long j;
        T.butterfly(b, ls, pu, pv, j);
        load_words<W>(P.table + j * W, tw);
        smem_get<W>(sm, S, pv, y);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) y[k] = tw[k] = 0;
      }
      mont_mul_tc<W>(y, tw, vw, F, w);
      if (live) {
        smem_get<W>(sm, S, pu, x);
        add_mod<W>(x, vw, y, F);
        smem_put<W>(sm, S, pu, y);
        sub_mod<W>(x, vw, y, F);
        smem_put<W>(sm, S, pv, y);
      }
    }
    __syncthreads();
  }

  if (P.post) scale(P.post, false);

  ntt_store_tile<W>(P, T, sm);
}

template <int W>
constexpr size_t k5b_ntt_smem(int tile_log) {
  return ntt_tile_smem<W>(tile_log) + mont_mma_smem<W>(K5B_NTT_WARPS);
}

template <int W>
int launch_k5b_ntt(NttPass P, long long n, long long batch, const uint32_t* p, uint32_t n0,
                   const void* frag, cudaStream_t s) {
  static const cudaError_t sized = cudaFuncSetAttribute(  // once: above 48 KB is dynamic
      k5b_ntt_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)k5b_ntt_smem<W>(NTT_TILE_LOG));
  if (sized != cudaSuccess) return (int)sized;
  const int tile_log = ntt_geometry(P, n, batch);
  if (tile_log < 0) return (int)cudaErrorInvalidValue;
  const int rounds = (1 << (tile_log - 1)) / 32;  // butterflies a stage over 32
  const int warps = rounds < 1 ? 1 : (rounds < K5B_NTT_WARPS ? rounds : K5B_NTT_WARPS);
  const unsigned blocks = (unsigned)(batch << P.nblk_log);  // B x (n >> tile_log)
  k5b_ntt_kernel<W><<<blocks, 32 * warps, k5b_ntt_smem<W>(tile_log), s>>>(
      P, make_field<W>(p, n0), (const uint4*)frag);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k5b_ntt_pass(const void* a, void* out, const void* table, const void* pre,
                            const void* post, int post_vec, long long n, long long batch, int s0,
                            int t, int gather, int nwords, const uint32_t* p, uint32_t n0,
                            const void* frag, void* stream) {
  const NttPass P{(const int32_t*)a, (int32_t*)out, (const uint32_t*)table,
                  (const uint32_t*)pre, (const uint32_t*)post, post_vec, 0, s0, t, 0, gather};
  switch (nwords) {
    case 8: return launch_k5b_ntt<8>(P, n, batch, p, n0, frag, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
