// The NTT passes' launch geometry and index maps, shared by the two pass
// kernels: k2_ntt.cu (K2, the integer pipe) and k5b_ntt_mma.cu (K5b, the
// constant products on the int8 tensor cores).
//
// One launch runs stages s0 .. s0+t-1 of the decimation-in-time loop over
// the whole n-element array (ops/ntt.py pass_plan splits the log2 n stages
// into 1-3 such passes).  Stage s pairs (i, i + 2^s) for every i with bit s
// clear, with twiddle table[j << (log2 n - s - 1)], j = i mod 2^s: the
// element pairs of the stages s0 .. s0+t-1 never leave a group of 2^t
// elements whose indices differ only in bits s0 .. s0+t-1.  A block loads
// 2^lg such groups (a tile), runs the t stages in shared memory with a
// barrier between stages, and stores the tile: each element is read from
// and written to device memory once a pass.  Group g holds the indices
//   (g >> s0) << (s0 + t) | k << s0 | (g mod 2^s0),   k < 2^t,
// and block b the groups b 2^lg .. (b + 1) 2^lg - 1, which for s0 > 0 are
// neighbouring columns (indices i, i + 1, ...).  Local position e = k 2^lg + c
// (c the group within the block) is both the order of the loads and the
// shared-memory slot.  The first pass (gather) reads element i from
// position brev(i), the bit reversal, computed with __brev.
//
// The tile is word-major in shared memory (word w of slot e at w * S + e,
// S = tile + NTT_PAD), so a warp's loads and its butterflies' reads hit
// distinct banks (2-way at the smallest strides).  The boundary layout
// (16-bit limbs in int32) is converted once at the load and once at the
// store.
//
// A launch may run a batch of B transforms of n elements each, stored one
// after another ((B, n) elements): blockIdx.x covers B x (n >> tile_log)
// blocks, transform b = blockIdx.x >> nblk_log; the index maps above are
// within the transform, a and out are offset by b n elements, and the
// table, pre and post are shared by the batch.  B = 1 launches exactly as
// one transform.
//
// The geometry is decided here only (ops/mont.py passes n, s0, t and B;
// tests/test_torch_ntt_plan.py replays it with these constants).

#pragma once

#include <cstdint>

#include "mont.cuh"

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
  int logn, s0, t, lg, gather;  // logn and lg: set by ntt_geometry
  int nblk_log;             // log2 of the blocks a transform: set by ntt_geometry
};

// Checks a pass and sets P.logn and P.lg: a block takes 2^lg groups of 2^t
// elements, so that it has at least 2^NTT_MIN_BF_LOG butterflies a stage
// where n allows; t + lg <= NTT_TILE_LOG; and P.nblk_log.  Returns log2 of
// the tile, or -1 for a pass the kernels do not take (batch: B >= 1, the
// grid's B x (n >> tile_log) blocks below 2^31).
inline int ntt_geometry(NttPass& P, long long n, long long batch) {
  if (n < 2 || (n & (n - 1)) || n > (1LL << 31) || batch < 1) return -1;
  P.logn = 63 - __builtin_clzll((unsigned long long)n);
  if (P.t < 1 || P.s0 < 0 || P.s0 + P.t > P.logn || P.t > NTT_TILE_LOG ||
      (P.gather && P.s0 != 0))
    return -1;
  const int lg_want = NTT_MIN_BF_LOG + 1 - P.t;
  P.lg = lg_want < 0 ? 0 : (lg_want < P.logn - P.t ? lg_want : P.logn - P.t);
  P.nblk_log = P.logn - P.t - P.lg;
  if (batch > ((1LL << 31) - 1) >> P.nblk_log) return -1;
  return P.t + P.lg;
}

// A block's view of its tile.
struct NttTile {
  int t, lg, s0, logn, tile, S, cmask;
  long long g0, lomask, boff;  // boff: the transform's first element
  bool gather;

  __device__ explicit NttTile(const NttPass& P)
      : t(P.t), lg(P.lg), s0(P.s0), logn(P.logn), tile(1 << (P.t + P.lg)),
        S((1 << (P.t + P.lg)) + NTT_PAD), cmask((1 << P.lg) - 1),
        g0((long long)(blockIdx.x & ((1u << P.nblk_log) - 1)) << P.lg),
        lomask((1LL << P.s0) - 1),
        boff((long long)(blockIdx.x >> P.nblk_log) << P.logn), gather(P.gather != 0) {}

  // memory index of slot e, within the transform
  __device__ __forceinline__ long long index(int e) const {
    const long long g = g0 + (e & cmask);
    return ((g >> s0) << (s0 + t)) | ((long long)(e >> lg) << s0) | (g & lomask);
  }
  // where the gather pass reads memory index i from
  __device__ __forceinline__ long long source(long long i) const {
    return gather ? (long long)(__brev((unsigned)i) >> (32 - logn)) : i;
  }
  // butterfly b of local stage ls: its slots pu, pv = pu + 2^ls 2^lg and
  // its twiddle's index into the table
  __device__ __forceinline__ void butterfly(int b, int ls, int& pu, int& pv, long long& tw) const {
    const int h = 1 << ls;
    const int c = b & cmask, r = b >> lg;
    const int ku = ((r >> ls) << (ls + 1)) | (r & (h - 1));
    pu = (ku << lg) | c;
    pv = pu + (h << lg);
    const long long j = ((long long)(ku & (h - 1)) << s0) | ((g0 + c) & lomask);
    tw = j << (logn - (s0 + ls) - 1);
  }
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

// The tile from device memory (through the bit reversal in the gather
// pass), limb pairs packed into words; any number of threads.
template <int W>
__device__ __forceinline__ void ntt_load_tile(const NttPass& P, const NttTile& T, uint32_t* sm) {
  constexpr int Q = W / 2;  // int4 (four limbs, two words) an element
  for (int u = threadIdx.x; u < T.tile * Q; u += blockDim.x) {
    const int e = u / Q, q = u % Q;
    const long long i = T.boff + T.source(T.index(e));
    const int4 v = reinterpret_cast<const int4*>(P.a + i * 2 * W)[q];
    sm[2 * q * T.S + e] = (uint32_t)(v.x & 0xffff) | ((uint32_t)v.y << 16);
    sm[(2 * q + 1) * T.S + e] = (uint32_t)(v.z & 0xffff) | ((uint32_t)v.w << 16);
  }
}

template <int W>
__device__ __forceinline__ void ntt_store_tile(const NttPass& P, const NttTile& T,
                                               const uint32_t* sm) {
  constexpr int Q = W / 2;
  for (int u = threadIdx.x; u < T.tile * Q; u += blockDim.x) {
    const int e = u / Q, q = u % Q;
    const uint32_t w0 = sm[2 * q * T.S + e], w1 = sm[(2 * q + 1) * T.S + e];
    int4 v;
    v.x = (int32_t)(w0 & 0xffff);
    v.y = (int32_t)(w0 >> 16);
    v.z = (int32_t)(w1 & 0xffff);
    v.w = (int32_t)(w1 >> 16);
    reinterpret_cast<int4*>(P.out + (T.boff + T.index(e)) * 2 * W)[q] = v;
  }
}

template <int W>
constexpr size_t ntt_tile_smem(int tile_log) {
  return (size_t)W * ((1 << tile_log) + NTT_PAD) * sizeof(uint32_t);
}
