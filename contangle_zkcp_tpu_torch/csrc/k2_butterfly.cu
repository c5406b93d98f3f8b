// K2: fused radix-2 NTT butterfly, (hi, lo) = (u + v*tw, u - v*tw) mod p.
//
// Replaces the TPU kernel contangle_zkcp_tpu/ops/pallas_mont.py
// MontMulLanes.butterfly_t (_bf_kernel / _bf_common): one stage of every
// NTT of the port (ops/ntt.py), one Montgomery multiply plus one modular
// add and one modular subtract per pair, with v*tw never written to
// device memory.
//
// What bounds it on an H100: device memory, as in K1 (2 W^2 + W
// multiply-adds for W = 8 words of BLS12-381 Fr against 5 x 8W bytes of
// traffic: three operands read, two results written).  Design: one
// thread per butterfly, everything in registers, each operand read once
// and each result written once, same packing as K1.

#include <cuda_runtime.h>

#include "mont.cuh"

template <int W>
__global__ void __launch_bounds__(256)
k2_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
          const int32_t* __restrict__ tw, int32_t* __restrict__ hi,
          int32_t* __restrict__ lo, long long n, FieldConst<W> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[W], x[W], w[W], vw[W], r[W];
  load_elem<W>(v + i * 2 * W, x);
  load_elem<W>(tw + i * 2 * W, w);
  mont_mul<W>(x, w, vw, F);
  load_elem<W>(u + i * 2 * W, a);
  mod_add<W>(a, vw, r, F);
  store_elem<W>(hi + i * 2 * W, r);
  mod_sub<W>(a, vw, r, F);
  store_elem<W>(lo + i * 2 * W, r);
}

template <int W>
static int launch_k2(const void* u, const void* v, const void* tw, void* hi,
                     void* lo, long long n, const uint32_t* p, uint32_t n0,
                     cudaStream_t s) {
  const int block = 256;
  if (n > 0)
    k2_kernel<W><<<grid_for(n, block), block, 0, s>>>(
        (const int32_t*)u, (const int32_t*)v, (const int32_t*)tw,
        (int32_t*)hi, (int32_t*)lo, n, make_field<W>(p, n0));
  return (int)cudaGetLastError();
}

extern "C" int k2_butterfly(const void* u, const void* v, const void* tw,
                            void* hi, void* lo, long long n, int nwords,
                            const uint32_t* p, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nwords) {
    case 8: return launch_k2<8>(u, v, tw, hi, lo, n, p, n0, s);
    case 12: return launch_k2<12>(u, v, tw, hi, lo, n, p, n0, s);
    case 24: return launch_k2<24>(u, v, tw, hi, lo, n, p, n0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
