// K5b: fused radix-2 NTT butterfly, (hi, lo) = (u + v*tw, u - v*tw) mod p,
// with the Montgomery multiply's constant products on the int8 tensor
// cores (K2's result, bit for bit).
//
// Replaces the TPU kernel contangle_zkcp_tpu/ops/pallas_mont.py
// MontMulLanes._bf_kernel_mxu (MontMulLanes.butterfly_t with mxu set):
// one NTT stage at butterfly_t's own boundary (ops/mont_mma.py
// butterfly_mma; ops/mont.py butterfly under ZKCP_MXU=1).
//
// What bounds it on an H100: device memory, as K2 (three operands read,
// two results written, 8W bytes each); the constant products are 6
// mma.sync per 8 butterflies of Fr.  Design: K5a's (k5_mont.cuh's
// multiply for v*tw, a grid-stride loop, each lane's constant fragments
// in registers); the modular add and subtract stay in the owner lane's
// registers, so v*tw never reaches device memory.  The NTT runs
// k5b_ntt_mma.cu's passes instead (several stages a launch); this
// one-stage entry is on no path.

#include <cuda_runtime.h>

#include "k5_mont.cuh"

template <int W>
__global__ void __launch_bounds__(K5_THREADS)
k5b_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
           const int32_t* __restrict__ tw, int32_t* __restrict__ hi,
           int32_t* __restrict__ lo, long long n, FieldConst<W> F,
           const uint4* __restrict__ frag) {
  extern __shared__ __align__(16) uint32_t k5b_smem[];
  uint4 A[MontMma<W>::TILES];
  load_tiles<W>(frag, A);
  const MontWarp<W> w(k5b_smem, A);
  const long long stride = (long long)gridDim.x * K5_THREADS;
  for (long long base = (long long)blockIdx.x * K5_THREADS + (threadIdx.x & ~31); base < n;
       base += stride) {  // warp-uniform: all 32 lanes run every iteration
    const long long i = base + w.lane;
    const bool live = i < n;
    uint32_t a[W], x[W], t[W], vw[W], r[W];
    load_live<W>(v + i * 2 * W, live, x);
    load_live<W>(tw + i * 2 * W, live, t);
    mont_mul_tc<W>(x, t, vw, F, w);
    load_live<W>(u + i * 2 * W, live, a);
    add_mod<W>(a, vw, r, F);
    if (live) store_elem<W>(hi + i * 2 * W, r);
    sub_mod<W>(a, vw, r, F);
    if (live) store_elem<W>(lo + i * 2 * W, r);
  }
}

template <int W>
static int launch_k5b(const void* u, const void* v, const void* tw, void* hi, void* lo,
                      long long n, const uint32_t* p, uint32_t n0, const void* frag,
                      cudaStream_t s) {
  constexpr size_t smem = mont_mma_smem<W>(K5_WARPS);
  static const cudaError_t e = k5_smem_attr(k5b_kernel<W>, smem);
  if (e != cudaSuccess) return (int)e;
  if (n > 0)
    k5b_kernel<W><<<k5_mont_grid(n), K5_THREADS, smem, s>>>(
        (const int32_t*)u, (const int32_t*)v, (const int32_t*)tw, (int32_t*)hi,
        (int32_t*)lo, n, make_field<W>(p, n0), (const uint4*)frag);
  return (int)cudaGetLastError();
}

extern "C" int k5b_butterfly_mma(const void* u, const void* v, const void* tw, void* hi,
                                 void* lo, long long n, int nwords, const uint32_t* p,
                                 uint32_t n0, const void* frag, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nwords) {
    case 8: return launch_k5b<8>(u, v, tw, hi, lo, n, p, n0, frag, s);
    case 12: return launch_k5b<12>(u, v, tw, hi, lo, n, p, n0, frag, s);
    case 24: return launch_k5b<24>(u, v, tw, hi, lo, n, p, n0, frag, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
