// K1: batched Montgomery multiply, out[i] = a[i] * b[i] * R^-1 mod p.
//
// Replaces the TPU kernel contangle_zkcp_tpu/ops/pallas_mont.py
// MontMulLanes.mul_t (body mont_mul_kernel_body): the canonical Montgomery
// product under every Fp.mul of the port (ops/mont.py mont_mul).
//
// What bounds it on an H100: device memory.  One product reads two
// operands and writes one, 8W bytes each (W = 8 words for BLS12-381 Fr,
// 12 for Fq, 24 for BW6-761 Fq; the boundary keeps one 16-bit limb per int32, which doubles
// the bytes), against 2 W^2 + W 32x32-bit multiply-adds: about 1.4 (Fr)
// and 2.1 (Fq) multiply-add operations per byte, far below the card's
// ~20 operations per byte of bandwidth.  Design: one thread per element,
// 16-byte vector loads, the W-word operands and the CIOS accumulator in
// registers, no shared memory, so each byte crosses the bus once; limb
// pairs are packed into 32-bit words on load, so the multiply runs on full
// 32-bit words instead of the reference's 16-bit VPU lanes.

#include <cuda_runtime.h>

#include "mont.cuh"

template <int W>
__global__ void __launch_bounds__(256)
k1_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
          int32_t* __restrict__ out, long long n, FieldConst<W> F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[W], y[W], r[W];
  load_elem<W>(a + i * 2 * W, x);
  load_elem<W>(b + i * 2 * W, y);
  mont_mul<W>(x, y, r, F);
  store_elem<W>(out + i * 2 * W, r);
}

template <int W>
static int launch_k1(const void* a, const void* b, void* out, long long n,
                     const uint32_t* p, uint32_t n0, cudaStream_t s) {
  const int block = 256;
  if (n > 0)
    k1_kernel<W><<<grid_for(n, block), block, 0, s>>>(
        (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n,
        make_field<W>(p, n0));
  return (int)cudaGetLastError();
}

extern "C" int k1_mont_mul(const void* a, const void* b, void* out,
                           long long n, int nwords, const uint32_t* p,
                           uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nwords) {
    case 8: return launch_k1<8>(a, b, out, n, p, n0, s);
    case 12: return launch_k1<12>(a, b, out, n, p, n0, s);
    case 24: return launch_k1<24>(a, b, out, n, p, n0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4: the row-major entry of the same kernel.  Replaces the TPU kernel
// contangle_zkcp_tpu/ops/pallas_field.py PallasFieldOps._mul (the round-1
// multiply on (N, L) limbs, body mont_mul_block), reached through
// ops/field_mul.py make(F).mul.  The Pallas kernel needed a second
// algorithm for its limbs-on-lanes layout; here K1 already reads (n, L)
// row-major limbs, so K4 is K1's template under its own name and launch
// count, with K1's bound.
extern "C" int k4_field_mul(const void* a, const void* b, void* out, long long n,
                            int nwords, const uint32_t* p, uint32_t n0, void* stream) {
  return k1_mont_mul(a, b, out, n, nwords, p, n0, stream);
}
