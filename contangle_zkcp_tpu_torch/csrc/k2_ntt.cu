// K2, redesigned: several stages of the radix-2 NTT a launch, the array's
// tile in shared memory; the bit reversal and the coset and 1/n scalings
// fused into the first and last pass.
//
// Replaces the TPU kernel contangle_zkcp_tpu/ops/pallas_mont.py:371
// MontMulLanes.butterfly_t (_bf_kernel), launched once a stage by the
// reference's NTT, for ALL the stages of the port's transform
// (ops/ntt.py): one launch runs stages s0 .. s0+t-1 of the decimation-in-
// time loop over the whole n-element array (ops/mont.py ntt_pass_plain is
// the same function in plain torch).  ops/ntt.py pass_plan splits the
// log2 n stages into 1-3 such passes.  The tiles, the index maps and the
// launch geometry are ntt_tile.cuh's, shared with k5b_ntt_mma.cu; a launch
// may run a batch of B transforms (the four-step NTT's columns and rows,
// parallel/ntt_sharded.py), one grid of B x (n >> tile_log) blocks.
//
// The first pass (gather) reads element i from position brev(i) (the
// bit reversal) and may multiply it by pre[src]
// (the coset powers g^src of coset_forward); the last pass may multiply
// each result by post[i] or by the scalar post[0] (n^-1 of inverse, or
// n^-1 g^-i of coset_inverse).  They are exact field multiplies, so the
// output is equal limb for limb to the stage loop followed by F.mul.
//
// What bounds it on an H100: integer operations.  A butterfly is one
// Montgomery product (2 W^2 + W 32x32->64-bit multiply-adds) plus a modular
// add and subtract, (n/2) log2 n of them a transform, against 2 n 8W bytes
// a pass; at n = 2^18 the multiply-adds take about twice as long as two
// passes' traffic.  Design: the stages of a pass never touch device
// memory; the boundary layout is converted once at the load and once at
// the store; the tile is word-major in shared memory; the twiddles come
// from one table of w^j, j < n/2, packed into 32-bit words (32 bytes an
// entry, L2-resident).  Arithmetic: mont.cuh's
// canonical multiply, add and subtract (fp_lazy.cuh's [0, 2p) form needs
// 4p < R, which neither BLS12-381 Fr nor Pasta Fp meets).  W = 8 only: the
// repo's fields with large power-of-two roots of unity all have 16 limbs.
// What holds it back as built: that arithmetic's 64-bit carry emulation
// issues about 700 SASS instructions a butterfly where 304 are counted
// (scripts/kernel_sass.py, k2_kernel<8>: 121 IMAD.WIDE.U32, 121 IMAD.X,
// 214 IADD3, 157 selects, shifts and logic), and at n <= 2^15 (one warp a
// scheduler) the latency of the same chains.

#include <cuda_runtime.h>

#include "ntt_tile.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(NTT_THREADS)
k2_ntt_kernel(NttPass P, FieldConst<W> F) {
  extern __shared__ __align__(16) uint32_t sm[];
  const NttTile T(P);
  const int S = T.S;

  ntt_load_tile<W>(P, T, sm);
  __syncthreads();

  if (P.pre) {
    for (int e = threadIdx.x; e < T.tile; e += blockDim.x) {
      uint32_t x[W], y[W];
      smem_get<W>(sm, S, e, x);
      load_words<W>(P.pre + T.source(T.index(e)) * W, y);
      mont_mul<W>(x, y, x, F);
      smem_put<W>(sm, S, e, x);
    }
    __syncthreads();
  }

  for (int ls = 0; ls < T.t; ++ls) {
    for (int b = threadIdx.x; b < T.tile / 2; b += blockDim.x) {
      int pu, pv;
      long long j;
      T.butterfly(b, ls, pu, pv, j);
      uint32_t x[W], y[W], w[W], vw[W];
      load_words<W>(P.table + j * W, w);
      smem_get<W>(sm, S, pv, y);
      mont_mul<W>(y, w, vw, F);
      smem_get<W>(sm, S, pu, x);
      mod_add<W>(x, vw, y, F);
      smem_put<W>(sm, S, pu, y);
      mod_sub<W>(x, vw, y, F);
      smem_put<W>(sm, S, pv, y);
    }
    __syncthreads();
  }

  if (P.post) {
    for (int e = threadIdx.x; e < T.tile; e += blockDim.x) {
      uint32_t x[W], y[W];
      smem_get<W>(sm, S, e, x);
      load_words<W>(P.post + (P.post_vec ? T.index(e) : 0LL) * W, y);
      mont_mul<W>(x, y, x, F);
      smem_put<W>(sm, S, e, x);
    }
    __syncthreads();
  }

  ntt_store_tile<W>(P, T, sm);
}

template <int W>
int launch_k2_ntt(NttPass P, long long n, long long batch, const uint32_t* p, uint32_t n0,
                  cudaStream_t s) {
  static const cudaError_t sized = cudaFuncSetAttribute(  // once: above 48 KB is dynamic
      k2_ntt_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ntt_tile_smem<W>(NTT_TILE_LOG));
  if (sized != cudaSuccess) return (int)sized;
  const int tile_log = ntt_geometry(P, n, batch);
  if (tile_log < 0) return (int)cudaErrorInvalidValue;
  const int threads = (1 << (tile_log - 1)) < NTT_THREADS ? 1 << (tile_log - 1) : NTT_THREADS;
  const unsigned blocks = (unsigned)(batch << P.nblk_log);  // B x (n >> tile_log)
  k2_ntt_kernel<W><<<blocks, threads, ntt_tile_smem<W>(tile_log), s>>>(P, make_field<W>(p, n0));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k2_ntt_pass(const void* a, void* out, const void* table, const void* pre,
                           const void* post, int post_vec, long long n, long long batch, int s0,
                           int t, int gather, int nwords, const uint32_t* p, uint32_t n0,
                           void* stream) {
  const NttPass P{(const int32_t*)a, (int32_t*)out, (const uint32_t*)table,
                  (const uint32_t*)pre, (const uint32_t*)post, post_vec, 0, s0, t, 0, gather};
  switch (nwords) {
    case 8: return launch_k2_ntt<8>(P, n, batch, p, n0, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
