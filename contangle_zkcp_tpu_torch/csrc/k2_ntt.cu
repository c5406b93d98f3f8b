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
// log2 n stages into 1-3 such passes.
//
// Stage s pairs (i, i + 2^s) for every i with bit s clear, with twiddle
// table[j << (log2 n - s - 1)], j = i mod 2^s: the element pairs of the
// stages s0 .. s0+t-1 never leave a group of 2^t elements whose indices
// differ only in bits s0 .. s0+t-1.  A block loads 2^lg such groups (a
// tile), runs the t stages in shared memory with a barrier between
// stages, and stores the tile: each element is read from and written to
// device memory once a pass.  Group g holds the indices
//   (g >> s0) << (s0 + t) | k << s0 | (g mod 2^s0),   k < 2^t,
// and block b the groups b 2^lg .. (b + 1) 2^lg - 1, which for s0 > 0 are
// neighbouring columns (indices i, i + 1, ...).  Local position e = k 2^lg + c
// (c the group within the block) is both the order of the loads and the
// shared-memory slot.
//
// The first pass (gather) reads element i from position brev(i) (the
// bit reversal, computed here with __brev) and may multiply it by pre[src]
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
// memory; the boundary layout (16-bit limbs in int32) is converted once at
// the load and once at the store; the tile is word-major in shared memory
// (word w of slot e at w * S + e, S = tile + 4), so a warp's loads and its
// butterflies' reads hit distinct banks (2-way at the smallest strides);
// the twiddles come from one table of w^j, j < n/2, packed into 32-bit
// words (32 bytes an entry, L2-resident).  Arithmetic: mont.cuh's
// canonical multiply, add and subtract (fp_lazy.cuh's [0, 2p) form needs
// 4p < R, which neither BLS12-381 Fr nor Pasta Fp meets).  W = 8 only: the
// repo's fields with large power-of-two roots of unity all have 16 limbs.
// What holds it back as built: that arithmetic's 64-bit carry emulation
// issues about 700 SASS instructions a butterfly where 304 are counted
// (scripts/kernel_sass.py, k2_kernel<8>: 121 IMAD.WIDE.U32, 121 IMAD.X,
// 214 IADD3, 157 selects, shifts and logic), and at n <= 2^15 (one warp a
// scheduler) the latency of the same chains.

#include <cuda_runtime.h>

#include "mont.cuh"

namespace {

// The launch geometry is decided here only (ops/mont.py passes n, s0, t;
// tests/test_torch_ntt_plan.py replays it with these constants).
constexpr int NTT_PAD = 4;          // words between shared-memory rows
constexpr int NTT_TILE_LOG = 12;    // at most 2^12 elements a block
constexpr int NTT_THREADS = 256;    // one thread a butterfly up to this
constexpr int NTT_MIN_BF_LOG = 6;   // at least 2^6 butterflies a block a stage, where n allows

struct NttPass {
  const int32_t* a;         // (n, 2W) int32 limbs in
  int32_t* out;             // (n, 2W) int32 limbs out (not a: the gather pass reads across tiles)
  const uint32_t* table;    // (n/2, W) words: w^j
  const uint32_t* pre;      // (n, W) words or null
  const uint32_t* post;     // (n, W) or (1, W) words, or null
  int post_vec;             // post indexed by position (else post[0])
  int logn, s0, t, lg, gather;  // logn and lg: set by the launcher
};

template <int W>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ src,
                                           uint32_t (&x)[W]) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 v = __ldg(s4 + i);
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

template <int W>
__device__ __forceinline__ void smem_get(const uint32_t* sm, int S, int e, uint32_t (&x)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) x[w] = sm[w * S + e];
}

template <int W>
__device__ __forceinline__ void smem_put(uint32_t* sm, int S, int e, const uint32_t (&x)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) sm[w * S + e] = x[w];
}

template <int W>
__global__ void __launch_bounds__(NTT_THREADS)
k2_ntt_kernel(NttPass P, FieldConst<W> F) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int t = P.t, lg = P.lg, s0 = P.s0;
  const int tile = 1 << (t + lg);
  const int S = tile + NTT_PAD;
  const int cmask = (1 << lg) - 1;
  const long long g0 = (long long)blockIdx.x << lg;
  const long long lomask = (1LL << s0) - 1;
  constexpr int Q = W / 2;  // int4 (four limbs, two words) an element

  // memory index of slot e, and where the gather pass reads it from
  auto index = [&](int e) -> long long {
    const long long g = g0 + (e & cmask);
    return ((g >> s0) << (s0 + t)) | ((long long)(e >> lg) << s0) | (g & lomask);
  };
  auto source = [&](long long i) -> long long {
    return P.gather ? (long long)(__brev((unsigned)i) >> (32 - P.logn)) : i;
  };

  for (int u = threadIdx.x; u < tile * Q; u += blockDim.x) {
    const int e = u / Q, q = u % Q;
    const int4 v = reinterpret_cast<const int4*>(P.a + source(index(e)) * 2 * W)[q];
    sm[2 * q * S + e] = (uint32_t)(v.x & 0xffff) | ((uint32_t)v.y << 16);
    sm[(2 * q + 1) * S + e] = (uint32_t)(v.z & 0xffff) | ((uint32_t)v.w << 16);
  }
  __syncthreads();

  if (P.pre) {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      uint32_t x[W], y[W];
      smem_get<W>(sm, S, e, x);
      load_words<W>(P.pre + source(index(e)) * W, y);
      mont_mul<W>(x, y, x, F);
      smem_put<W>(sm, S, e, x);
    }
    __syncthreads();
  }

  for (int ls = 0; ls < t; ++ls) {
    const int s = s0 + ls;
    const int h = 1 << ls;
    const int tw_shift = P.logn - s - 1;
    for (int b = threadIdx.x; b < tile / 2; b += blockDim.x) {
      const int c = b & cmask, r = b >> lg;
      const int ku = ((r >> ls) << (ls + 1)) | (r & (h - 1));
      const int pu = (ku << lg) | c, pv = pu + (h << lg);
      const long long j = ((long long)(ku & (h - 1)) << s0) | ((g0 + c) & lomask);
      uint32_t x[W], y[W], w[W], vw[W];
      load_words<W>(P.table + (j << tw_shift) * W, w);
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
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      uint32_t x[W], y[W];
      smem_get<W>(sm, S, e, x);
      load_words<W>(P.post + (P.post_vec ? index(e) : 0LL) * W, y);
      mont_mul<W>(x, y, x, F);
      smem_put<W>(sm, S, e, x);
    }
    __syncthreads();
  }

  for (int u = threadIdx.x; u < tile * Q; u += blockDim.x) {
    const int e = u / Q, q = u % Q;
    const uint32_t w0 = sm[2 * q * S + e], w1 = sm[(2 * q + 1) * S + e];
    int4 v;
    v.x = (int32_t)(w0 & 0xffff);
    v.y = (int32_t)(w0 >> 16);
    v.z = (int32_t)(w1 & 0xffff);
    v.w = (int32_t)(w1 >> 16);
    reinterpret_cast<int4*>(P.out + index(e) * 2 * W)[q] = v;
  }
}

template <int W>
constexpr size_t ntt_smem(int tile_log) {
  return (size_t)W * ((1 << tile_log) + NTT_PAD) * sizeof(uint32_t);
}

template <int W>
int launch_k2_ntt(NttPass P, long long n, const uint32_t* p, uint32_t n0, cudaStream_t s) {
  static const cudaError_t sized = cudaFuncSetAttribute(  // once: above 48 KB is dynamic
      k2_ntt_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ntt_smem<W>(NTT_TILE_LOG));
  if (sized != cudaSuccess) return (int)sized;
  if (n < 2 || (n & (n - 1)) || n > (1LL << 31)) return (int)cudaErrorInvalidValue;
  P.logn = 63 - __builtin_clzll((unsigned long long)n);
  if (P.t < 1 || P.s0 < 0 || P.s0 + P.t > P.logn || P.t > NTT_TILE_LOG ||
      (P.gather && P.s0 != 0))
    return (int)cudaErrorInvalidValue;
  // a block takes 2^lg groups of 2^t elements, so that it has at least
  // 2^NTT_MIN_BF_LOG butterflies a stage where n allows; t + lg <= NTT_TILE_LOG
  const int lg_want = NTT_MIN_BF_LOG + 1 - P.t;
  P.lg = lg_want < 0 ? 0 : (lg_want < P.logn - P.t ? lg_want : P.logn - P.t);
  const int tile_log = P.t + P.lg;
  const int threads = (1 << (tile_log - 1)) < NTT_THREADS ? 1 << (tile_log - 1) : NTT_THREADS;
  const unsigned blocks = (unsigned)(n >> tile_log);
  k2_ntt_kernel<W><<<blocks, threads, ntt_smem<W>(tile_log), s>>>(P, make_field<W>(p, n0));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k2_ntt_pass(const void* a, void* out, const void* table, const void* pre,
                           const void* post, int post_vec, long long n, int s0, int t,
                           int gather, int nwords, const uint32_t* p, uint32_t n0,
                           void* stream) {
  const NttPass P{(const int32_t*)a, (int32_t*)out, (const uint32_t*)table,
                  (const uint32_t*)pre, (const uint32_t*)post, post_vec, 0, s0, t, 0, gather};
  switch (nwords) {
    case 8: return launch_k2_ntt<8>(P, n, p, n0, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
