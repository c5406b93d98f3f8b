// K5c: complete projective point addition on y^2 = x^3 + b (a = 0),
// Renes-Costello-Batina 2015 Algorithm 7, with the constant products of
// its Montgomery multiplies on the int8 tensor cores (K3's result, bit
// for bit).
//
// Replaces the TPU kernel contangle_zkcp_tpu/ops/pallas_curve.py
// PallasSWAdd._kernel_mxu (PallasSWAdd.add_t with mxu set): every G1 add
// of the port in the ZKCP_MXU=1 configuration (ops/curve_add.py
// sw_add_mma), that is every MSM bucket add, fixed-base setup add and the
// verifier's input MSM.
//
// What bounds it on an H100: by the published rates the bytes (9 x 8W a
// point) and the integer pipe about equally: the 10 a*b schoolbooks
// (2 W^2 + 2W - 1 instructions each, W = 12 for BLS12-381 Fq), the fold
// of each product's column sums and the add/subtract chains stay there;
// the constant products are 13 mma.sync per multiply per 8 points at
// W = 12.  What costs most in practice is moving words and column sums
// between the lane that owns a point and the fragment layout of the
// tensor cores, through shared memory, with the few warps that its
// registers and shared memory leave an SM.
// Design: one point pair per lane (a warp's 32 points share each mma),
// K3's lazily reduced arithmetic (fp_lazy.cuh) for the integer part, or
// its strict one for a field without the lazy headroom (template S), the
// two multiplies by 3b as addition chains when 3b is 9 or 12 (template
// B3) and so off the tensor cores (any other 3b: one more group, of two),
// and the ten general multiplies in four groups of three independent ones
// (X1X2, Y1Y2, Z1Z2; the three products of sums; two groups of the six
// output products, so that no more than six field elements and three
// products are live), each group sharing one staging round, one set of
// warp barriers and each loaded constant fragment.  A multiply keeps only
// T div R of its product T = a b in registers: T mod R goes to shared
// memory for the tensor cores, and the carry it gives T + m p is
// recovered from the folded low words (see group_mp).

#include <cuda_runtime.h>

#include "fp_lazy.cuh"
#include "k5_mma.cuh"

constexpr int K5C_G = 3;  // multiplies per group

template <int W>
struct CurveConstMma {
  LazyConst<W> F;
  uint32_t b3[W];  // 3*b in Montgomery form (used when B3 = 0)
};

// Per-warp staging: rows of KW words (stride BS) for T mod R and for m,
// and one m-tile of column sums (stride CS), for each of the group's G
// products.
template <int W>
struct GroupShape {
  using S = MmaShape<W>;
  static constexpr int ROWS = K5C_G * 32 * S::BS;
  static constexpr int SUMS = K5C_G * 32 * S::CS;
  static constexpr int WARP_WORDS = 2 * ROWS + SUMS;
  static constexpr size_t SMEM = sizeof(uint4) * S::TILES * 32 +
                                 sizeof(uint32_t) * (size_t)K5_WARPS * WARP_WORDS;
};

template <int W>
struct GroupWarp {
  const uint4* A;  // the block's constant fragments
  uint32_t* T;     // [G][32 BS]: T mod R of each product
  uint32_t* M;     // [G][32 BS]: m of each product
  int32_t* C;      // [G][32 CS]: one m-tile of column sums
  int lane;
};

// The G products of a group: T div R of each, replaced by the result.
template <int W>
struct Group {
  uint32_t hi[K5C_G][W];
};

// T = a b: T mod R to the lane's staging row k, T div R to hi.
// Schoolbook rows as two carry chains into two accumulators: U takes the
// products a_j b_i with i + j even at word i + j, V those with i + j odd
// at word i + j - 1, so that every product's two words land on an
// aligned register pair (ptxas fuses the pair into one IMAD.WIDE) and
// the chains of a row are independent; T = U + 2^32 V at the end.  Each
// pair of rows (2k - 1, 2k) adds its carries into one word past its
// chains, which no earlier chain reached, so those words stay below 3;
// the last carries into U[2W] and V[2W - 1] are zero (T < 2^(64 W)).
template <int W>
__device__ __forceinline__ void stage_product(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                              uint32_t (&hi)[W], const GroupWarp<W>& w, int k) {
  uint32_t U[2 * W + 1], V[2 * W];
#pragma unroll
  for (int j = 0; j < 2 * W; ++j) U[j] = V[j] = 0;
  U[2 * W] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int odd = i & 1, s = i + odd, t = i - odd;
    // j = i mod 2 (chain A): words i + j, i + j + 1 of U, from s
    U[s] = mad_lo_cc(a[odd], b[i], U[s]);
    U[s + 1] = madc_hi_cc(a[odd], b[i], U[s + 1]);
#pragma unroll
    for (int j = odd + 2; j < W; j += 2) {
      U[i + j] = madc_lo_cc(a[j], b[i], U[i + j]);
      U[i + j + 1] = madc_hi_cc(a[j], b[i], U[i + j + 1]);
    }
    U[s + W] = addc(U[s + W], 0u);
    // the other j (chain B): words i + j - 1, i + j of V, from t
    V[t] = mad_lo_cc(a[1 - odd], b[i], V[t]);
    V[t + 1] = madc_hi_cc(a[1 - odd], b[i], V[t + 1]);
#pragma unroll
    for (int j = 3 - odd; j < W; j += 2) {
      V[i + j - 1] = madc_lo_cc(a[j], b[i], V[i + j - 1]);
      V[i + j] = madc_hi_cc(a[j], b[i], V[i + j]);
    }
    V[t + W] = addc(V[t + W], 0u);
  }
  uint32_t T[2 * W];
  T[0] = U[0];
  T[1] = add_cc(U[1], V[0]);
#pragma unroll
  for (int j = 2; j < 2 * W - 1; ++j) T[j] = addc_cc(U[j], V[j - 1]);
  T[2 * W - 1] = addc(U[2 * W - 1], V[2 * W - 2]);
  using S = MmaShape<W>;
  uint4* row = reinterpret_cast<uint4*>(w.T + k * 32 * S::BS + w.lane * S::BS);
#pragma unroll
  for (int q = 0; q < W / 4; ++q) row[q] = make_uint4(T[4 * q], T[4 * q + 1], T[4 * q + 2], T[4 * q + 3]);
#pragma unroll
  for (int j = 0; j < W; ++j) hi[j] = T[W + j];
}

// Four column sums (output bytes 4q .. 4q + 3 of one word, each < 2^22)
// plus the carry: the word's value and the next carry.
__device__ __forceinline__ uint64_t fold4(const int4& v, uint64_t carry) {
  return carry + (uint32_t)v.x + ((uint64_t)(uint32_t)v.y << 8) +
         ((uint64_t)(uint32_t)v.z << 16) + ((uint64_t)(uint32_t)v.w << 24);
}

// One m-tile of a constant product for the group: mma over the staged
// rows `rows`, the C fragments to the per-warp sums area.  TILE is the
// constant's tile (m-tile, k-step 0) in the fragment table.
template <int W, int NG, int MT, int TILE>
__device__ __forceinline__ void group_tile(const GroupWarp<W>& w, const uint32_t* rows) {
  using S = MmaShape<W>;
  const int g = w.lane >> 2, t = w.lane & 3;
  uint4 a[S::KS];
#pragma unroll
  for (int ks = 0; ks < S::KS; ++ks)
    if (tile_used(MT, ks, W)) a[ks] = w.A[(TILE + ks) * 32 + w.lane];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    // the warp's 4 groups of 8 points, two at a time: unrolled fully the
    // kernel spills at W = 12
#pragma unroll 2
    for (int j = 0; j < 4; ++j) {
      int32_t acc[4] = {0, 0, 0, 0};
      const uint32_t* col = rows + k * 32 * S::BS + (8 * j + g) * S::BS + t;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks)
        if (tile_used(MT, ks, W)) mma_u8(acc, a[ks], col[8 * ks], col[8 * ks + 4]);
      // C fragment: rows g and g + 8, columns 2t and 2t + 1
      int32_t* c = w.C + k * 32 * S::CS + (8 * j + 2 * t) * S::CS + g;
      c[0] = acc[0];
      c[S::CS] = acc[1];
      c[8] = acc[2];
      c[S::CS + 8] = acc[3];
    }
  }
}

// The lane's own 16 sums of product k's current m-tile.
template <int W>
__device__ __forceinline__ const int4* own_sums(const GroupWarp<W>& w, int k) {
  using S = MmaShape<W>;
  return reinterpret_cast<const int4*>(w.C + k * 32 * S::CS + w.lane * S::CS);
}

// m = (T mod R) N' mod R for the group's NG products, to the M rows.
template <int W, int NG, int MT = 0>
__device__ __forceinline__ void group_m(const GroupWarp<W>& w, uint64_t (&carry)[K5C_G]) {
  using S = MmaShape<W>;
  if constexpr (MT < S::MT_NP) {
    if (MT == 0) {
#pragma unroll
      for (int k = 0; k < NG; ++k) carry[k] = 0;
    }
    group_tile<W, NG, MT, MT * S::KS>(w, w.T);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const int4* mine = own_sums<W>(w, k);
      uint32_t out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t s = fold4(mine[q], carry[k]);
        out[q] = (uint32_t)s;
        carry[k] = s >> 32;
      }
      reinterpret_cast<uint4*>(w.M + k * 32 * S::BS + w.lane * S::BS)[MT] =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
    __syncwarp();
    group_m<W, NG, MT + 1>(w, carry);
  }
}

// r = (T + m p) / R for the group: T + m p = 0 mod R.  With L the low 4W
// bytes' part of the column sums of m p, T mod R + L = 0 mod R and both
// T mod R < R and L mod R < R, so T mod R + (L mod R) is R when L mod R
// != 0 and 0 otherwise: the carry into T div R is floor(L / R) (the fold's
// own carry) plus one when any low word of L is nonzero.  Results < 2p
// (fp_lazy.cuh), in G.hi.
template <int W, int NG, int MT = 0>
__device__ __forceinline__ void group_mp(const GroupWarp<W>& w, Group<W>& G,
                                         uint64_t (&carry)[K5C_G], uint32_t (&nz)[K5C_G]) {
  using S = MmaShape<W>;
  if constexpr (MT < S::MT_P) {
    if (MT == 0) {
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        carry[k] = 0;
        nz[k] = 0;
      }
    }
    group_tile<W, NG, MT, (S::MT_NP + MT) * S::KS>(w, w.M);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const int4* mine = own_sums<W>(w, k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int word = 4 * MT + q;
        uint64_t s = fold4(mine[q], carry[k]);
        if (word < W) {
          nz[k] |= (uint32_t)s;
        } else {
          s += G.hi[k][word - W];
          if (word == W) s += (nz[k] != 0);
          G.hi[k][word - W] = (uint32_t)s;
        }
        carry[k] = s >> 32;
      }
    }
    __syncwarp();
    group_mp<W, NG, MT + 1>(w, G, carry, nz);
  }
}

// The Montgomery reduction of the group's NG staged products.  Lazy (S
// false): the results in [0, 2p) < R, the fold's last carry zero.
// Strict: canonical operands give results below 2p, which may reach R
// (2p >= R); the fold's last carry is bit 32 W, and one conditional
// subtract of p makes each result canonical.
template <int W, bool S, int NG = K5C_G>
__device__ __forceinline__ void group_reduce(const GroupWarp<W>& w, Group<W>& G,
                                             const LazyConst<W>& F) {
  uint64_t carry[K5C_G];
  uint32_t nz[K5C_G];
  __syncwarp();  // the staged T rows
  group_m<W, NG>(w, carry);
  group_mp<W, NG>(w, G, carry, nz);
  if constexpr (S) {
#pragma unroll
    for (int k = 0; k < NG; ++k) csub_top<W>(G.hi[k], (uint32_t)carry[k], F);
  }
}

template <int W>
__device__ __forceinline__ void copy_elem(const uint32_t (&x)[W], uint32_t (&r)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = x[j];
}

template <int W, int B3, bool S>
__global__ void __launch_bounds__(K5_THREADS, 2)
k5c_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
           const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
           const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
           int32_t* __restrict__ x3, int32_t* __restrict__ y3, int32_t* __restrict__ z3,
           long long n, CurveConstMma<W> C, const uint4* __restrict__ frag) {
  using GS = GroupShape<W>;
  extern __shared__ __align__(16) uint4 k5c_smem[];
  load_fragments<W>(k5c_smem, frag);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  uint32_t* base_w = reinterpret_cast<uint32_t*>(k5c_smem + MmaShape<W>::TILES * 32) +
                     warp * GS::WARP_WORDS;
  const GroupWarp<W> w{k5c_smem, base_w, base_w + GS::ROWS,
                       reinterpret_cast<int32_t*>(base_w + 2 * GS::ROWS), (int)(threadIdx.x & 31)};
  const LazyConst<W>& F = C.F;
  const long long stride = (long long)gridDim.x * K5_THREADS;
  for (long long base = (long long)blockIdx.x * K5_THREADS + (threadIdx.x & ~31); base < n;
       base += stride) {
    const long long i = base + w.lane;
    const bool live = i < n;
    const long long off = i * 2 * W;
    Group<W> G;
    uint32_t t0[W], t1[W], t2[W], t3[W], t4[W];
    {
      uint32_t X1[W], Y1[W], Z1[W], X2[W], Y2[W], Z2[W];
      load_live<W>(x1 + off, live, X1);
      load_live<W>(x2 + off, live, X2);
      stage_product<W>(X1, X2, G.hi[0], w, 0);
      load_live<W>(y1 + off, live, Y1);
      load_live<W>(y2 + off, live, Y2);
      stage_product<W>(Y1, Y2, G.hi[1], w, 1);
      load_live<W>(z1 + off, live, Z1);
      load_live<W>(z2 + off, live, Z2);
      stage_product<W>(Z1, Z2, G.hi[2], w, 2);
      // the sums of canonical inputs, below 2p: X1+Y1 into t3's place,
      // Y1+Z1 into Y1's, X1+Z1 into X1's (and the same for the second point)
      fadd_in<W, S>(X1, Y1, t3, F);
      fadd_in<W, S>(X2, Y2, t4, F);
      fadd_in<W, S>(Y1, Z1, Y1, F);
      fadd_in<W, S>(Y2, Z2, Y2, F);
      fadd_in<W, S>(X1, Z1, X1, F);
      fadd_in<W, S>(X2, Z2, X2, F);
      group_reduce<W, S>(w, G, F);
      copy_elem<W>(G.hi[0], t0);
      copy_elem<W>(G.hi[1], t1);
      copy_elem<W>(G.hi[2], t2);
      stage_product<W>(t3, t4, G.hi[0], w, 0);  // (X1+Y1)(X2+Y2)
      stage_product<W>(Y1, Y2, G.hi[1], w, 1);  // (Y1+Z1)(Y2+Z2)
      stage_product<W>(X1, X2, G.hi[2], w, 2);  // (X1+Z1)(X2+Z2)
    }
    group_reduce<W, S>(w, G, F);
    uint32_t s[W];
    fadd<W, S>(t0, t1, s, F);
    fsub<W, S>(G.hi[0], s, t3, F);  // t3 = X1Y2 + X2Y1
    fadd<W, S>(t1, t2, s, F);
    fsub<W, S>(G.hi[1], s, t4, F);  // t4 = Y1Z2 + Y2Z1
    fadd<W, S>(t0, t2, s, F);
    uint32_t y3b[W];
    fsub<W, S>(G.hi[2], s, y3b, F);  // y3p = X1Z2 + X2Z1
    if constexpr (B3 == 0) {  // t2b = 3b t2, y3b = 3b y3p: a group of two
      stage_product<W>(C.b3, t2, G.hi[0], w, 0);
      stage_product<W>(C.b3, y3b, G.hi[1], w, 1);
      group_reduce<W, S, 2>(w, G, F);
      copy_elem<W>(G.hi[0], t2);
      copy_elem<W>(G.hi[1], y3b);
    } else {
      mul_small<W, B3, S>(t2, t2, F);
      mul_small<W, B3, S>(y3b, y3b, F);
    }
    uint32_t Z3p[W];
    fadd<W, S>(t1, t2, Z3p, F);
    fsub<W, S>(t1, t2, t1, F);  // t1p
    fadd<W, S>(t0, t0, t2, F);
    fadd<W, S>(t2, t0, t0, F);  // t0p = 3 t0
    // X3 = t3 t1p - t4 y3b, Y3 = t1p Z3p + y3b t0p, Z3 = Z3p t4 + t0p t3
    stage_product<W>(t3, t1, G.hi[0], w, 0);
    stage_product<W>(t1, Z3p, G.hi[1], w, 1);
    stage_product<W>(Z3p, t4, G.hi[2], w, 2);
    group_reduce<W, S>(w, G, F);
    copy_elem<W>(G.hi[0], t1);
    copy_elem<W>(G.hi[1], t2);
    copy_elem<W>(G.hi[2], Z3p);
    stage_product<W>(t4, y3b, G.hi[0], w, 0);
    stage_product<W>(y3b, t0, G.hi[1], w, 1);
    stage_product<W>(t0, t3, G.hi[2], w, 2);
    group_reduce<W, S>(w, G, F);
    fsub<W, S>(t1, G.hi[0], t1, F);
    fcanon<W, S>(t1, F);
    if (live) store_elem<W>(x3 + off, t1);
    fadd<W, S>(t2, G.hi[1], t2, F);
    fcanon<W, S>(t2, F);
    if (live) store_elem<W>(y3 + off, t2);
    fadd<W, S>(Z3p, G.hi[2], Z3p, F);
    fcanon<W, S>(Z3p, F);
    if (live) store_elem<W>(z3 + off, Z3p);
  }
}

template <int W, int B3, bool S>
static int launch_k5c(const void* const* in, void* const* out, long long n,
                      const CurveConstMma<W>& C, const void* frag, cudaStream_t s) {
  const size_t smem = GroupShape<W>::SMEM;
  static bool sized = false;  // once per instantiation: > 48 KB of dynamic shared memory
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        k5c_kernel<W, B3, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  if (n > 0)
    k5c_kernel<W, B3, S><<<k5_grid(n), K5_THREADS, smem, s>>>(
        (const int32_t*)in[0], (const int32_t*)in[1], (const int32_t*)in[2],
        (const int32_t*)in[3], (const int32_t*)in[4], (const int32_t*)in[5],
        (int32_t*)out[0], (int32_t*)out[1], (int32_t*)out[2], n, C, (const uint4*)frag);
  return (int)cudaGetLastError();
}

template <int W>
static int launch_k5c_b3(const void* const* in, void* const* out, long long n,
                         const uint32_t* p, uint32_t n0, const uint32_t* b3, int b3small,
                         int strict, const void* frag, cudaStream_t s) {
  CurveConstMma<W> C;
  C.F = make_lazy<W>(p, n0);
  for (int j = 0; j < W; ++j) C.b3[j] = b3[j];
  if (strict) {  // the Pasta fields: W = 8, the general multiply by 3b
    if constexpr (W == 8)
      if (b3small == 0) return launch_k5c<W, 0, true>(in, out, n, C, frag, s);
    return (int)cudaErrorInvalidValue;
  }
  switch (b3small) {
    case 0: return launch_k5c<W, 0, false>(in, out, n, C, frag, s);
    case 9: return launch_k5c<W, 9, false>(in, out, n, C, frag, s);
    case 12: return launch_k5c<W, 12, false>(in, out, n, C, frag, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// b3 is 3b R mod p (words); b3small is the integer 3b when it is 9 or 12,
// else 0; strict is 1 for a field without the lazy headroom (4p >= R).
extern "C" int k5c_sw_add_mma(const void* x1, const void* y1, const void* z1,
                              const void* x2, const void* y2, const void* z2, void* x3,
                              void* y3, void* z3, long long n, int nwords, const uint32_t* p,
                              uint32_t n0, const uint32_t* b3, int b3small, int strict,
                              const void* frag, void* stream) {
  const void* in[6] = {x1, y1, z1, x2, y2, z2};
  void* out[3] = {x3, y3, z3};
  cudaStream_t s = (cudaStream_t)stream;
  switch (nwords) {
    case 8: return launch_k5c_b3<8>(in, out, n, p, n0, b3, b3small, strict, frag, s);
    case 12: return launch_k5c_b3<12>(in, out, n, p, n0, b3, b3small, strict, frag, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
