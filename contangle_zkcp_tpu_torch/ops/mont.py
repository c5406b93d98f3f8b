"""K1 (Montgomery multiply) and K2 (NTT butterfly): wrappers and twins.

Under `ZKCP_MXU=1` both wrappers route to their tensor-core variants K5a
and K5b (ops/mont_mma.py), as the reference's engines do.

Port of `contangle_zkcp_tpu/ops/pallas_mont.py` (`MontMulLanes.mul_t`,
`MontMulLanes.butterfly_t`).  Operands are `(n, L)` int32 tensors of
16-bit limbs, canonical, Montgomery form (R = 2^(16 L)), batch-major: the
layout of the JAX package's public functions.  The kernels pack limb pairs
into 32-bit words themselves (csrc/mont.cuh).

A wrapper launches its CUDA kernel for a CUDA tensor and raises if it
cannot; it takes the plain torch twin only for a tensor on the CPU.  The
twins repeat the reference's wide/SOS reduction (`fields/fp.py
_mul_xla`) in int64 and are what the CPU tests run; on the card they
serve only as the yardstick `chip_smoke.py` holds the kernels against.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields import limbs as lb
from . import cuda_lib

# ---------------------------------------------------------------- twins
#
# The twins work on limb-major (L, n) int64 "columns", so each carry step
# is one vector op over the batch: products accumulate limb rows, and
# carries run limb by limb.


def to_cols(t):
    """(n, L) int32 limbs -> (L, n) int64."""
    return t.to(torch.int64).T.contiguous()


def from_cols(c):
    """(L, n) int64 limbs -> (n, L) int32."""
    return c.T.to(torch.int32).contiguous()


def _product_rows(x, y, L: int, low_only: bool = False):
    """Schoolbook columns of x*y for (L, n) int64 limbs (y may be (L, 1)):
    (2L, n) column sums, each < L * 2^32; low_only forms columns < L."""
    out = torch.zeros((2 * L,) + x.shape[1:], dtype=torch.int64, device=x.device)
    for i in range(L):
        j = L - i if low_only else L
        rows = out[i : i + j]
        rows.addcmul_(x[i].expand_as(rows), y[:j].expand_as(rows))
    return out


def _carry_rows(cols):
    """(C, n) non-negative int64 columns -> (16-bit limbs (C, n), carry
    out of the top column (n,))."""
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[0])
    for k in range(cols.shape[0]):
        v = cols[k] + carry
        out[k] = v & lb.LIMB_MASK
        carry = v >> lb.LIMB_BITS
    return out, carry


def _sub_rows(x, y):
    """(x - y) limbwise with borrow: (limbs, borrow out (n,) in {0, 1})."""
    out = torch.empty_like(x)
    borrow = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        v = x[k] - y[k] - borrow
        out[k] = v & lb.LIMB_MASK
        borrow = -(v >> lb.LIMB_BITS)
    return out, borrow


def add_rows(x, y, p):
    """(x + y) mod p on (L, n) canonical limbs; p is (L, 1)."""
    s, carry = _carry_rows(x + y)
    d, borrow = _sub_rows(s, p)
    return torch.where((carry != 0) | (borrow == 0), d, s)


def sub_rows(x, y, p):
    """(x - y) mod p on (L, n) canonical limbs."""
    d, borrow = _sub_rows(x, y)
    e, _ = _carry_rows(d + p)
    return torch.where(borrow != 0, e, d)


def mont_rows(F, x, y):
    """x*y*R^-1 mod p on (L, n) int64 limbs, canonical.

    The reference's wide/SOS reduction (`fields/fp.py _mul_xla`):
    T = x*y;  m = (T mod R) * N' mod R;  (T + m*p) / R < 2p, then one
    conditional subtract of p."""
    L = F.L
    p = F.const("p", x.device).to(torch.int64)[:, None]
    npinv = F.const("npinv", x.device).to(torch.int64)[:, None]
    t, _ = _carry_rows(_product_rows(x, y, L))  # value < p^2 < R^2
    m, _ = _carry_rows(_product_rows(t[:L], npinv, L, low_only=True)[:L])
    u, top = _carry_rows(t + _product_rows(m, p, L))
    res = u[L:]  # (T + m p) / R < 2p, bit 16L in `top`
    d, borrow = _sub_rows(res, p)
    return torch.where((borrow == 0) | (top != 0), d, res)


def mont_mul_plain(F, a, b):
    """Plain torch Montgomery product a*b*R^-1 mod p of (n, L) limbs."""
    return from_cols(mont_rows(F, to_cols(a), to_cols(b)))


def butterfly_plain(F, u, v, tw):
    """Plain torch (u + v*tw, u - v*tw) mod p."""
    p = F.const("p", u.device).to(torch.int64)[:, None]
    uc = to_cols(u)
    vw = mont_rows(F, to_cols(v), to_cols(tw))
    return from_cols(add_rows(uc, vw, p)), from_cols(sub_rows(uc, vw, p))


# ------------------------------------------------------------- wrappers


def check_operands(F, *ts):
    """Same device, int32, (n, L), contiguous; returns n."""
    t0 = ts[0]
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 limbs, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != F.L or t.shape[0] != t0.shape[0]:
            raise ValueError(f"expected ({t0.shape[0]}, {F.L}) limbs, got {tuple(t.shape)}")
        if t.device != t0.device:
            raise ValueError("operands on different devices")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError("CUDA operands must be 16-byte aligned")
    return t0.shape[0]


def aligned(t):
    """Contiguous copy when t is not a 16-byte aligned contiguous tensor."""
    if not t.is_contiguous() or (t.is_cuda and t.data_ptr() % 16):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def words(F, x: int | None = None):
    """x (default p) as a ctypes array of L/2 little-endian 32-bit words."""
    x = F.p if x is None else x
    w = F.L // 2
    return (ctypes.c_uint32 * w)(*[(x >> (32 * i)) & 0xFFFFFFFF for i in range(w)])


def _words(F):
    """(p as words, n0 = -p^-1 mod 2^32) for the kernels, cached on F."""
    if getattr(F, "_kernel_words", None) is None:
        F._kernel_words = (words(F), (-pow(F.p, -1, 1 << 32)) % (1 << 32))
    return F._kernel_words


def mont_mul(F, a, b):
    """K1: out = a*b*R^-1 mod p for (n, L) int32 limb tensors; K5a under
    ZKCP_MXU=1 (ops/mont_mma.py)."""
    from . import mont_mma

    if mont_mma.use_mxu():
        return mont_mma.mont_mul_mma(F, a, b)
    n = check_operands(F, a, b)
    if not a.is_cuda:
        return mont_mul_plain(F, a, b)
    out = torch.empty_like(a)
    if n == 0:
        return out
    p, n0 = _words(F)
    rc = cuda_lib.lib().k1_mont_mul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n, F.L // 2, p, n0,
        cuda_lib.stream_ptr(a),
    )
    cuda_lib.LAUNCHES["k1_mont_mul"] += 1
    cuda_lib.check(rc, "k1_mont_mul")
    return out


def butterfly(F, u, v, tw):
    """K2: (u + v*tw, u - v*tw) mod p for (n, L) int32 limb tensors; K5b
    under ZKCP_MXU=1 (ops/mont_mma.py)."""
    from . import mont_mma

    if mont_mma.use_mxu():
        return mont_mma.butterfly_mma(F, u, v, tw)
    n = check_operands(F, u, v, tw)
    if not u.is_cuda:
        return butterfly_plain(F, u, v, tw)
    hi = torch.empty_like(u)
    lo = torch.empty_like(u)
    if n == 0:
        return hi, lo
    p, n0 = _words(F)
    rc = cuda_lib.lib().k2_butterfly(
        u.data_ptr(), v.data_ptr(), tw.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        n, F.L // 2, p, n0, cuda_lib.stream_ptr(u),
    )
    cuda_lib.LAUNCHES["k2_butterfly"] += 1
    cuda_lib.check(rc, "k2_butterfly")
    return hi, lo
