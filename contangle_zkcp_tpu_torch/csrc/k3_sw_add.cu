// K3: complete projective point addition on y^2 = x^3 + b (a = 0),
// Renes-Costello-Batina 2015 Algorithm 7, for a batch of point pairs.
//
// Replaces the TPU kernel contangle_zkcp_tpu/ops/pallas_curve.py
// PallasSWAdd.add_t (_kernel / rcb_add_body): every G1 add of the port
// (curves/weierstrass.py SWDevice.add over a prime field), which is every
// MSM bucket add, fixed-base setup add and the verifier's input MSM.
//
// What bounds it on an H100: the integer pipe.  Per point 10 general
// Montgomery multiplies (4 W^2 + 5 W - 2 multiply-adds and adds each in
// fp_lazy.cuh mul, W = 12 words for BLS12-381 Fq) and some 60 W words of
// add/subtract chains, against 9 x 8W bytes read and written: about 8
// instructions per byte, where the card does ~5 per byte of its memory
// rate.  What keeps a kernel from it is latency: each CIOS row is a
// serial carry chain, which only other warps can hide, so the registers
// a thread holds (the live field elements) set the speed.
// Design: one thread per point pair, straight-line code on registers
// (identity, doubling and inverses need no branch: the law is complete);
// values lazily reduced in [0, 2p) and each output made canonical once,
// before its store (fp_lazy.cuh, which states the bounds), or, for a
// field without that headroom (the Pasta fields), kept canonical after
// every operation (template S, the strict arithmetic of fp_lazy.cuh); the two
// multiplies by 3b an addition chain when 3b is 9 or 12 (template B3,
// chosen by the wrapper from the curve constant); the formula ordered so
// that at most nine field elements are live at once (two of the inputs
// are loaded a second time rather than kept), and X3, Y3, Z3 each stored
// as soon as it is known.

#include <cuda_runtime.h>

#include "fp_lazy.cuh"

template <int W>
struct CurveConst {
  LazyConst<W> F;
  uint32_t b3[W];  // 3*b in Montgomery form (used when B3 = 0)
};

template <int W, int B3, bool S>
__global__ void __launch_bounds__(128)
k3_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
          const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
          const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
          int32_t* __restrict__ x3, int32_t* __restrict__ y3,
          int32_t* __restrict__ z3, long long n, CurveConst<W> C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LazyConst<W>& F = C.F;
  const long long off = i * 2 * W;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W];
  {
    uint32_t a[W], b[W], c[W], d[W];
    load_elem<W>(x1 + off, a);
    load_elem<W>(x2 + off, b);
    fmul<W, S>(a, b, t0, F);  // X1 X2
    load_elem<W>(y1 + off, c);
    load_elem<W>(y2 + off, d);
    fmul<W, S>(c, d, t1, F);  // Y1 Y2
    // t3 = (X1+Y1)(X2+Y2) - (t0+t1) = X1Y2 + X2Y1
    fadd_in<W, S>(a, c, a, F);
    fadd_in<W, S>(b, d, b, F);
    fmul<W, S>(a, b, t3, F);
    fadd<W, S>(t0, t1, a, F);
    fsub<W, S>(t3, a, t3, F);
    // t4 = (Y1+Z1)(Y2+Z2) - (t1+t2) = Y1Z2 + Y2Z1
    load_elem<W>(z1 + off, a);
    load_elem<W>(z2 + off, b);
    fadd_in<W, S>(c, a, c, F);
    fadd_in<W, S>(d, b, d, F);
    fmul<W, S>(c, d, t4, F);
    fmul<W, S>(a, b, t2, F);  // Z1 Z2
    fadd<W, S>(t1, t2, c, F);
    fsub<W, S>(t4, c, t4, F);
    // y3p = (X1+Z1)(X2+Z2) - (t0+t2) = X1Z2 + X2Z1, kept in t2's place
    // once t2 has given 3b t2
    reload_elem<W>(x1 + off, c);
    reload_elem<W>(x2 + off, d);
    fadd_in<W, S>(c, a, c, F);
    fadd_in<W, S>(d, b, d, F);
    fmul<W, S>(c, d, a, F);
    fadd<W, S>(t0, t2, b, F);
    fsub<W, S>(a, b, a, F);  // y3p
    mul_b3<W, B3, S>(C.b3, t2, t2, F);  // t2b = 3b t2
    mul_b3<W, B3, S>(C.b3, a, b, F);   // y3b = 3b y3p
    // Z3p = t1 + t2b, t1p = t1 - t2b, t0p = 3 t0
    fadd<W, S>(t1, t2, c, F);  // Z3p
    fsub<W, S>(t1, t2, t1, F);  // t1p
    fadd<W, S>(t0, t0, t2, F);
    fadd<W, S>(t2, t0, t0, F);  // t0p
    // live: t0 = t0p, t1 = t1p, t3, t4, b = y3b, c = Z3p
    // X3 = t3 t1p - t4 y3b
    fmul<W, S>(t3, t1, a, F);
    fmul<W, S>(t4, b, d, F);
    fsub<W, S>(a, d, a, F);
    fcanon<W, S>(a, F);
    store_elem<W>(x3 + off, a);
    // Y3 = t1p Z3p + y3b t0p
    fmul<W, S>(t1, c, a, F);
    fmul<W, S>(b, t0, d, F);
    fadd<W, S>(a, d, a, F);
    fcanon<W, S>(a, F);
    store_elem<W>(y3 + off, a);
    // Z3 = Z3p t4 + t0p t3
    fmul<W, S>(c, t4, a, F);
    fmul<W, S>(t0, t3, d, F);
    fadd<W, S>(a, d, a, F);
    fcanon<W, S>(a, F);
    store_elem<W>(z3 + off, a);
  }
}

template <int W, int B3, bool S>
static int launch_k3(const void* const* in, void* const* out, long long n,
                     const uint32_t* p, uint32_t n0, const uint32_t* b3,
                     cudaStream_t s) {
  const int block = 128;
  CurveConst<W> C;
  C.F = make_lazy<W>(p, n0);
  for (int j = 0; j < W; ++j) C.b3[j] = b3[j];
  if (n > 0)
    k3_kernel<W, B3, S><<<grid_for(n, block), block, 0, s>>>(
        (const int32_t*)in[0], (const int32_t*)in[1], (const int32_t*)in[2],
        (const int32_t*)in[3], (const int32_t*)in[4], (const int32_t*)in[5],
        (int32_t*)out[0], (int32_t*)out[1], (int32_t*)out[2], n, C);
  return (int)cudaGetLastError();
}

template <int W>
static int launch_k3_b3(const void* const* in, void* const* out, long long n,
                        const uint32_t* p, uint32_t n0, const uint32_t* b3, int b3small,
                        cudaStream_t s) {
  switch (b3small) {
    case 0: return launch_k3<W, 0, false>(in, out, n, p, n0, b3, s);
    case 9: return launch_k3<W, 9, false>(in, out, n, p, n0, b3, s);
    case 12: return launch_k3<W, 12, false>(in, out, n, p, n0, b3, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// b3 is 3b R mod p (words); b3small is the integer 3b when it is 9 or 12,
// else 0; strict is 1 for a field without the lazy headroom (4p >= R),
// whose instance is W = 8 with the general multiply by 3b (the Pasta
// fields).
extern "C" int k3_sw_add(const void* x1, const void* y1, const void* z1,
                         const void* x2, const void* y2, const void* z2,
                         void* x3, void* y3, void* z3, long long n,
                         int nwords, const uint32_t* p, uint32_t n0,
                         const uint32_t* b3, int b3small, int strict, void* stream) {
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {x3, y3, z3};
  cudaStream_t s = (cudaStream_t)stream;
  if (strict)
    return nwords == 8 && b3small == 0 ? launch_k3<8, 0, true>(in, out, n, p, n0, b3, s)
                                       : (int)cudaErrorInvalidValue;
  switch (nwords) {
    case 8: return launch_k3_b3<8>(in, out, n, p, n0, b3, b3small, s);
    case 12: return launch_k3_b3<12>(in, out, n, p, n0, b3, b3small, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
