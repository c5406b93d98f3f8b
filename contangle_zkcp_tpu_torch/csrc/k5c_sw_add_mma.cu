// K5c: complete projective point addition on y^2 = x^3 + b (a = 0),
// Renes-Costello-Batina 2015 Algorithm 7, with the constant products of
// all 12 Montgomery multiplies on the int8 tensor cores (K3's result, bit
// for bit).
//
// Replaces the TPU kernel contangle_zkcp_tpu/ops/pallas_curve.py
// PallasSWAdd._kernel_mxu (PallasSWAdd.add_t with mxu set): every G1 add
// of the port in the ZKCP_MXU=1 configuration (ops/curve_add.py
// sw_add_mma), that is every MSM bucket add, fixed-base setup add and the
// verifier's input MSM.
//
// What bounds it on an H100: the integer pipe, as K3: the 12 a*b
// schoolbooks (12 x 2 W^2 integer multiply-adds, W = 12 for BLS12-381 Fq)
// and the ~17 modular adds stay there against 9 x 8W bytes of traffic;
// the constant products move to 13 mma.sync per multiply per 8 points.
// Design: K3's straight-line formula, one point pair per lane, with each
// multiply warp-collective (k5_mma.cuh); the staging buffers are in
// shared memory, not in the lane's registers, which already hold ~15
// field elements.

#include <cuda_runtime.h>

#include "k5_mma.cuh"

template <int W>
struct CurveConstMma {
  FieldConst<W> F;
  uint32_t b3[W];  // 3*b in Montgomery form
};

template <int W>
__global__ void __launch_bounds__(K5_THREADS)
k5c_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
           const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
           const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
           int32_t* __restrict__ x3, int32_t* __restrict__ y3, int32_t* __restrict__ z3,
           long long n, CurveConstMma<W> C, const uint4* __restrict__ frag) {
  __shared__ __align__(16) MmaSmem<W> sm;
  load_fragments<W>(sm.A, frag);
  __syncthreads();
  const MmaWarp<W> w = warp_view<W>(sm);
  const FieldConst<W>& F = C.F;
  const long long stride = (long long)gridDim.x * K5_THREADS;
  for (long long base = (long long)blockIdx.x * K5_THREADS + (threadIdx.x & ~31); base < n;
       base += stride) {
    const long long i = base + w.lane;
    const bool live = i < n;
    const long long off = i * 2 * W;
    uint32_t X1[W], Y1[W], Z1[W], X2[W], Y2[W], Z2[W];
    load_live<W>(x1 + off, live, X1);
    load_live<W>(y1 + off, live, Y1);
    load_live<W>(z1 + off, live, Z1);
    load_live<W>(x2 + off, live, X2);
    load_live<W>(y2 + off, live, Y2);
    load_live<W>(z2 + off, live, Z2);
    uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], s[W], q[W];
    mont_mul_mma<W>(X1, X2, t0, F, w);
    mont_mul_mma<W>(Y1, Y2, t1, F, w);
    mont_mul_mma<W>(Z1, Z2, t2, F, w);
    // t3 = (X1+Y1)(X2+Y2) - (t0+t1) = X1Y2 + X2Y1
    mod_add<W>(X1, Y1, s, F);
    mod_add<W>(X2, Y2, q, F);
    mont_mul_mma<W>(s, q, t3, F, w);
    mod_add<W>(t0, t1, s, F);
    mod_sub<W>(t3, s, t3, F);
    // t4 = (Y1+Z1)(Y2+Z2) - (t1+t2) = Y1Z2 + Y2Z1
    mod_add<W>(Y1, Z1, s, F);
    mod_add<W>(Y2, Z2, q, F);
    mont_mul_mma<W>(s, q, t4, F, w);
    mod_add<W>(t1, t2, s, F);
    mod_sub<W>(t4, s, t4, F);
    // y3p = (X1+Z1)(X2+Z2) - (t0+t2) = X1Z2 + X2Z1
    uint32_t y3p[W];
    mod_add<W>(X1, Z1, s, F);
    mod_add<W>(X2, Z2, q, F);
    mont_mul_mma<W>(s, q, y3p, F, w);
    mod_add<W>(t0, t2, s, F);
    mod_sub<W>(y3p, s, y3p, F);
    uint32_t t2b[W], y3b[W];
    mont_mul_mma<W>(C.b3, t2, t2b, F, w);
    mont_mul_mma<W>(C.b3, y3p, y3b, F, w);
    uint32_t Z3p[W], t1p[W], t0p[W];
    mod_add<W>(t1, t2b, Z3p, F);
    mod_sub<W>(t1, t2b, t1p, F);
    mod_add<W>(t0, t0, t0p, F);
    mod_add<W>(t0p, t0, t0p, F);  // 3 * X1X2
    uint32_t m1[W], m2[W], out[W];
    // X3 = t3*t1p - t4*y3b
    mont_mul_mma<W>(t4, y3b, m1, F, w);
    mont_mul_mma<W>(t3, t1p, m2, F, w);
    mod_sub<W>(m2, m1, out, F);
    if (live) store_elem<W>(x3 + off, out);
    // Y3 = t1p*Z3p + y3b*t0p
    mont_mul_mma<W>(y3b, t0p, m1, F, w);
    mont_mul_mma<W>(t1p, Z3p, m2, F, w);
    mod_add<W>(m2, m1, out, F);
    if (live) store_elem<W>(y3 + off, out);
    // Z3 = Z3p*t4 + t0p*t3
    mont_mul_mma<W>(t0p, t3, m1, F, w);
    mont_mul_mma<W>(Z3p, t4, m2, F, w);
    mod_add<W>(m2, m1, out, F);
    if (live) store_elem<W>(z3 + off, out);
  }
}

template <int W>
static int launch_k5c(const void* const* in, void* const* out, long long n,
                      const uint32_t* p, uint32_t n0, const uint32_t* b3, const void* frag,
                      cudaStream_t s) {
  CurveConstMma<W> C;
  C.F = make_field<W>(p, n0);
  for (int j = 0; j < W; ++j) C.b3[j] = b3[j];
  if (n > 0)
    k5c_kernel<W><<<k5_grid(n), K5_THREADS, 0, s>>>(
        (const int32_t*)in[0], (const int32_t*)in[1], (const int32_t*)in[2],
        (const int32_t*)in[3], (const int32_t*)in[4], (const int32_t*)in[5],
        (int32_t*)out[0], (int32_t*)out[1], (int32_t*)out[2], n, C, (const uint4*)frag);
  return (int)cudaGetLastError();
}

extern "C" int k5c_sw_add_mma(const void* x1, const void* y1, const void* z1,
                              const void* x2, const void* y2, const void* z2, void* x3,
                              void* y3, void* z3, long long n, int nwords, const uint32_t* p,
                              uint32_t n0, const uint32_t* b3, const void* frag,
                              void* stream) {
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {x3, y3, z3};
  cudaStream_t s = (cudaStream_t)stream;
  switch (nwords) {
    case 8: return launch_k5c<8>(in, out, n, p, n0, b3, frag, s);
    case 12: return launch_k5c<12>(in, out, n, p, n0, b3, frag, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
