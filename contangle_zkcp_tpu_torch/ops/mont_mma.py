"""K5a (Montgomery multiply) and K5b (NTT butterfly, and several NTT stages
a launch) on the int8 tensor cores: the configuration switch, the
constant matrices, wrappers and twins.

Port of the matrix-unit mode of `contangle_zkcp_tpu/ops/pallas_mont.py`
(`MontMulLanes._kernel_mxu`, `_bf_kernel_mxu`; `_const_byte_planes`,
`_toeplitz_cat`, `_mxu_const_product_cols`; `_use_mxu`).  Of a Montgomery
multiply's three products, m = (T mod R) * N' mod R and m * p have a
constant operand; each is a Toeplitz matrix of the constant's bytes
applied to the byte planes of the variable operand.  The reference runs
them on the TPU's matrix unit in float32; the kernels (csrc/k5_mma.cuh,
csrc/k5_mont.cuh) run them as unsigned int8 tensor-core products with
int32 sums.  Every column sum is below 4W * 255^2 < 2^23, so both are
exact.

`ZKCP_MXU=1` selects this configuration, as in the reference: `mont_mul`,
`butterfly` (ops/mont.py) and `sw_add` (ops/curve_add.py) read it on
every call and route to K5a, K5b and K5c, and the NTT (ops/ntt.py) runs
its passes through `ntt_pass_mma` (K5b's k5b_ntt_pass).  A K5 wrapper launches its
kernel for a CUDA tensor and raises if it cannot (it never falls back to
K1-K3); it takes its twin only for a CPU tensor.  The twins are the
reference's algorithm in torch: the Toeplitz products in the reference's
"cat" byte order, as float64 matrix products (exact: every sum is below
2^22, and torch has no int64 matmul on the card).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import cuda_lib
from .mont import _carry_rows, _product_rows, _sub_rows, _words, add_rows, check_operands
from .mont import check_pass, from_cols, ntt_pass_plain, sub_rows, to_cols


def use_mxu() -> bool:
    """The tensor-core configuration (the reference's `_use_mxu`)."""
    return os.environ.get("ZKCP_MXU", "0") == "1"


# ------------------------------------------------- constant matrices (twin)


def const_byte_planes(limbs):
    """16-bit limbs -> their bytes, little-endian (int64)."""
    arr = np.asarray(limbs, np.int64)
    b = np.zeros(2 * len(arr), np.int64)
    b[0::2] = arr & 0xFF
    b[1::2] = arr >> 8
    return b


def toeplitz_cat(byte_planes, out16: int, L: int) -> np.ndarray:
    """(2 out16, 2L) matrix M with M @ cat_bytes(x) = cat_bytes(const * x)
    in the reference's "cat" order: rows [low output bytes; high output
    bytes], columns [low input bytes; high input bytes]; output byte k =
    sum over i + j = k of const byte i * input byte j."""
    nb = len(byte_planes)
    r = np.arange(2 * out16)
    c = np.arange(2 * L)
    br = np.where(r < out16, 2 * r, 2 * (r - out16) + 1)
    bc = np.where(c < L, 2 * c, 2 * (c - L) + 1)
    d = br[:, None] - bc[None, :]
    ok = (d >= 0) & (d < nb)
    return np.where(ok, np.asarray(byte_planes)[np.clip(d, 0, nb - 1)], 0).astype(np.float32)


def _matrices(F, device):
    """(M_np, M_p) as float64 tensors on `device`, cached on F."""
    cache = F.__dict__.setdefault("_mxu_mats", {})
    key = str(torch.device(device))
    if key not in cache:
        L = F.L
        mnp = toeplitz_cat(const_byte_planes(F.npinv_limbs), L, L)
        mp = toeplitz_cat(const_byte_planes(F.p_limbs), 2 * L, L)
        cache[key] = tuple(torch.from_numpy(m.astype(np.float64)).to(device) for m in (mnp, mp))
    return cache[key]


def const_product_cols(M, t16, out16: int):
    """Columns of const * t16 in the 16-bit basis: (out16, n) int64, each
    below 2^30, from (L, n) canonical limbs by one exact float64 product."""
    t8 = torch.cat([t16 & 0xFF, t16 >> 8]).to(torch.float64)
    c8 = (M @ t8).to(torch.int64)
    return c8[:out16] + (c8[out16:] << 8)


def mont_rows_mma(F, x, y):
    """x*y*R^-1 mod p on (L, n) int64 limbs, canonical: the reference's
    `mont_mul_kernel_body` with `mxu` (the a*b schoolbook, then both
    constant products as Toeplitz matrix products)."""
    L = F.L
    p = F.const("p", x.device).to(torch.int64)[:, None]
    m_np, m_p = _matrices(F, x.device)
    t, _ = _carry_rows(_product_rows(x, y, L))
    m, _ = _carry_rows(const_product_cols(m_np, t[:L], L))  # mod R
    u, top = _carry_rows(t + const_product_cols(m_p, m, 2 * L))
    res = u[L:]  # (T + m p) / R < 2p, bit 16L in `top`
    d, borrow = _sub_rows(res, p)
    return torch.where((borrow == 0) | (top != 0), d, res)


def mont_mul_mma_plain(F, a, b):
    """K5a's plain torch version on (n, L) limbs."""
    return from_cols(mont_rows_mma(F, to_cols(a), to_cols(b)))


def butterfly_mma_plain(F, u, v, tw):
    """K5b's plain torch version: (u + v*tw, u - v*tw) mod p."""
    p = F.const("p", u.device).to(torch.int64)[:, None]
    uc = to_cols(u)
    vw = mont_rows_mma(F, to_cols(v), to_cols(tw))
    return from_cols(add_rows(uc, vw, p)), from_cols(sub_rows(uc, vw, p))


def ntt_pass_mma_plain(F, a, table, s0: int, t: int, pre=None, post=None, gather: bool = False):
    """The plain torch version of one k5b_ntt_pass launch: ops/mont.py
    ntt_pass_plain with the stages through `butterfly_mma_plain` and the
    scalings through `mont_mul_mma_plain`."""
    return ntt_pass_plain(F, a, table, s0, t, pre, post, gather,
                          mul=mont_mul_mma_plain, bf=butterfly_mma_plain)


# ---------------------------------------------------- kernel fragments


def mma_shape(L: int):
    """The kernels' tiling (csrc/k5_mma.cuh MmaShape) for L 16-bit limbs:
    (words W, k-steps KS, m-tiles of the mod-R product, m-tiles of the
    product by p)."""
    W = L // 2
    return W, (W + 7) // 8, W // 4, W // 2


def tile_used(mt: int, ks: int, W: int) -> bool:
    """Whether the 16 x 32 tile (m-tile mt, k-step ks) of a Toeplitz
    matrix of 4W constant bytes by 4W input bytes holds a nonzero entry
    (csrc/k5_mma.cuh tile_used; the kernels skip the others)."""
    return 32 * ks < 4 * W and 16 * mt + 15 >= 32 * ks and 16 * mt - min(32 * ks + 31, 4 * W - 1) < 4 * W


def toeplitz_natural(const_limbs, rows: int, cols: int) -> np.ndarray:
    """(rows, cols) uint8 matrix A[r, c] = byte r - c of the constant, in
    natural byte order (the kernels' order), zero outside the constant."""
    cb = const_byte_planes(const_limbs)
    d = np.arange(rows)[:, None] - np.arange(cols)[None, :]
    ok = (d >= 0) & (d < len(cb))
    return np.where(ok, cb[np.clip(d, 0, len(cb) - 1)], 0).astype(np.uint8)


def fragment_words(A: np.ndarray, KS: int) -> np.ndarray:
    """The m16n8k32 A fragments of a (16 MT, 32 KS) byte matrix, as
    (MT * KS, 32 lanes, 4) uint32, tile = mt * KS + ks: lane (g, t) holds
    rows g and g + 8 by columns 4t..4t+3 and 16+4t..16+4t+3, four bytes
    to a register, low byte first (PTX ISA, mma.m16n8k32 .u8 fragments)."""
    MT = A.shape[0] // 16
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    q = np.arange(4)
    out = np.zeros((MT * KS, 32, 4), np.uint32)
    for mt in range(MT):
        for ks in range(KS):
            row = 16 * mt + g[:, None] + 8 * (q[None, :] & 1)  # (32, 4)
            col0 = 32 * ks + 4 * t[:, None] + 16 * (q[None, :] >> 1)
            word = np.zeros((32, 4), np.uint32)
            for k in range(4):
                word |= A[row, col0 + k].astype(np.uint32) << np.uint32(8 * k)
            out[mt * KS + ks] = word
    return out


def hw_rows() -> np.ndarray:
    """The output byte (within an m-tile) of each of the 16 A rows in
    csrc/k5_mont.cuh's order: rows g and g + 8, which the C fragment gives
    one lane, are bytes 2g and 2g + 1, one halfword."""
    r = np.arange(16)
    return np.where(r < 8, 2 * r, 2 * (r - 8) + 1)


def mma_fragments(F, rows=None) -> np.ndarray:
    """The kernels' constant table: the fragments of the mod-R Toeplitz
    matrix of N' (4W output bytes) then of p (8W output bytes), both by
    32 KS input bytes; flat int32.  `rows` orders the 16 rows of every
    m-tile (natural order by default: K5c's table)."""
    W, KS, mt_np, mt_p = mma_shape(F.L)
    cols = 32 * KS
    a_np = toeplitz_natural(F.npinv_limbs, 16 * mt_np, cols)
    a_p = toeplitz_natural(F.p_limbs, 16 * mt_p, cols)
    a_np[:, 4 * W :] = 0  # input bytes past the element are padding
    a_p[:, 4 * W :] = 0
    if rows is not None:
        a_np, a_p = (a.reshape(-1, 16, cols)[:, rows].reshape(-1, cols) for a in (a_np, a_p))
    frags = np.concatenate([fragment_words(a_np, KS), fragment_words(a_p, KS)])
    return frags.reshape(-1).view(np.int32)


def mma_fragments_hw(F) -> np.ndarray:
    """K5a's and K5b's table (csrc/k5_mont.cuh): `mma_fragments` with each
    m-tile's rows in `hw_rows` order."""
    return mma_fragments(F, hw_rows())


def _cached_table(F, device, attr, make):
    cache = F.__dict__.setdefault(attr, {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = torch.from_numpy(make(F).copy()).to(device)
    return cache[key]


def fragments(F, device):
    """`mma_fragments(F)` as a tensor on `device`, cached on F."""
    return _cached_table(F, device, "_mma_frags", mma_fragments)


def fragments_hw(F, device):
    """`mma_fragments_hw(F)` as a tensor on `device`, cached on F."""
    return _cached_table(F, device, "_mma_frags_hw", mma_fragments_hw)


# ------------------------------------------------------------- wrappers


def mont_mul_mma(F, a, b):
    """K5a: out = a*b*R^-1 mod p for (n, L) int32 limb tensors."""
    n = check_operands(F, a, b)
    if not a.is_cuda:
        return mont_mul_mma_plain(F, a, b)
    out = torch.empty_like(a)
    if n == 0:
        return out
    p, n0 = _words(F)
    rc = cuda_lib.lib().k5a_mont_mul_mma(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, F.L // 2, p, n0,
        fragments_hw(F, a.device).data_ptr(), cuda_lib.stream_ptr(a),
    )
    cuda_lib.LAUNCHES["k5a_mont_mul_mma"] += 1
    cuda_lib.check(rc, "k5a_mont_mul_mma")
    return out


def butterfly_mma(F, u, v, tw):
    """K5b: (u + v*tw, u - v*tw) mod p for (n, L) int32 limb tensors."""
    n = check_operands(F, u, v, tw)
    if not u.is_cuda:
        return butterfly_mma_plain(F, u, v, tw)
    hi = torch.empty_like(u)
    lo = torch.empty_like(u)
    if n == 0:
        return hi, lo
    p, n0 = _words(F)
    rc = cuda_lib.lib().k5b_butterfly_mma(
        u.data_ptr(), v.data_ptr(), tw.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        n, F.L // 2, p, n0, fragments_hw(F, u.device).data_ptr(), cuda_lib.stream_ptr(u),
    )
    cuda_lib.LAUNCHES["k5b_butterfly_mma"] += 1
    cuda_lib.check(rc, "k5b_butterfly_mma")
    return hi, lo


def ntt_pass_mma(F, a, table, s0: int, t: int, pre=None, post=None, gather: bool = False):
    """K5b, redesigned: stages s0 .. s0+t-1 of the NTT in one launch of
    k5b_ntt_pass (csrc/k5b_ntt_mma.cu) for a CUDA array, its multiplies'
    constant products on the tensor cores; `ntt_pass_mma_plain` for a CPU
    one.  Operands as ops/mont.py ntt_pass (a batch (B, n, L) in one
    launch).  Returns a new array."""
    B, n = check_pass(F, a, table, s0, t, pre, post, gather)
    if not a.is_cuda:
        return ntt_pass_mma_plain(F, a, table, s0, t, pre, post, gather)
    p, n0 = _words(F)
    out = torch.empty_like(a)
    rc = cuda_lib.lib().k5b_ntt_pass(  # the kernel's launcher picks its tile and warps
        a.data_ptr(), out.data_ptr(), table.data_ptr(),
        None if pre is None else pre.data_ptr(), None if post is None else post.data_ptr(),
        int(post is not None and post.shape[0] == n), n, B, s0, t, int(gather),
        F.L // 2, p, n0, fragments_hw(F, a.device).data_ptr(), cuda_lib.stream_ptr(a),
    )
    cuda_lib.LAUNCHES["k5b_ntt_pass"] += 1
    cuda_lib.check(rc, "k5b_ntt_pass")
    return out
