// K5a: batched Montgomery multiply with the constant products on the int8
// tensor cores, out[i] = a[i] * b[i] * R^-1 mod p (K1's result, bit for
// bit).
//
// Replaces the TPU kernel contangle_zkcp_tpu/ops/pallas_mont.py
// MontMulLanes._kernel_mxu (MontMulLanes.mul_t with mxu set, the
// ZKCP_MXU=1 configuration): every Fp.mul of the port in that
// configuration (ops/mont_mma.py mont_mul_mma).
//
// What bounds it on an H100: as K1, device memory by the published peaks
// (three operands of 8W bytes against one product); the matrix products
// are 6 (Fr) or 13 (Fq) mma.sync per 8 elements, a few hundredths of the
// int8 rate, and the a*b schoolbook (W^2 multiply-adds, two instructions
// each) is left on the integer pipe.  Design: one element a lane (16-byte
// vector loads, registers only), a grid-stride loop over 128-element
// chunks on at most 16 blocks an SM (k5_mont_grid); the multiply is
// k5_mont.cuh's (the constant products staged through shared memory once a
// product, the lane's constant fragments in registers for the whole loop,
// the carries on PTX chains).

#include <cuda_runtime.h>

#include "k5_mont.cuh"

// The blocks an SM that __launch_bounds__ makes the registers leave room
// for, which sets the registers a thread: W = 8, seven (72 registers);
// W = 12, four (128, where nvcc alone takes 164 and fits three); W = 24,
// two (255).  Timed on an H100 against eight (64 registers) and one (121)
// at W = 8, and nvcc's own choice at W = 12.
template <int W>
constexpr int k5a_min_blocks() {
  return W == 8 ? 7 : (W == 12 ? 4 : 2);
}

template <int W>
__global__ void __launch_bounds__(K5_THREADS, k5a_min_blocks<W>())
k5a_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           int32_t* __restrict__ out, long long n, FieldConst<W> F,
           const uint4* __restrict__ frag) {
  extern __shared__ __align__(16) uint32_t k5a_smem[];
  uint4 A[MontMma<W>::TILES];
  load_tiles<W>(frag, A);
  const MontWarp<W> w(k5a_smem, A);
  const long long stride = (long long)gridDim.x * K5_THREADS;
  for (long long base = (long long)blockIdx.x * K5_THREADS + (threadIdx.x & ~31); base < n;
       base += stride) {  // warp-uniform: all 32 lanes run every iteration
    const long long i = base + w.lane;
    const bool live = i < n;
    uint32_t x[W], y[W], r[W];
    load_live<W>(a + i * 2 * W, live, x);
    load_live<W>(b + i * 2 * W, live, y);
    mont_mul_tc<W>(x, y, r, F, w);
    if (live) store_elem<W>(out + i * 2 * W, r);
  }
}

template <int W>
static int launch_k5a(const void* a, const void* b, void* out, long long n,
                      const uint32_t* p, uint32_t n0, const void* frag, cudaStream_t s) {
  constexpr size_t smem = mont_mma_smem<W>(K5_WARPS);
  static const cudaError_t e = k5_smem_attr(k5a_kernel<W>, smem);
  if (e != cudaSuccess) return (int)e;
  if (n > 0)
    k5a_kernel<W><<<k5_mont_grid(n), K5_THREADS, smem, s>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n, make_field<W>(p, n0),
        (const uint4*)frag);
  return (int)cudaGetLastError();
}

extern "C" int k5a_mont_mul_mma(const void* a, const void* b, void* out, long long n,
                                int nwords, const uint32_t* p, uint32_t n0,
                                const void* frag, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nwords) {
    case 8: return launch_k5a<8>(a, b, out, n, p, n0, frag, s);
    case 12: return launch_k5a<12>(a, b, out, n, p, n0, frag, s);
    case 24: return launch_k5a<24>(a, b, out, n, p, n0, frag, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
