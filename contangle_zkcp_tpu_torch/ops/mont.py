"""K1 (Montgomery multiply) and K2 (NTT butterfly, and several NTT stages
a launch): wrappers and twins.

Under `ZKCP_MXU=1` `mont_mul` and `butterfly` route to their tensor-core
variants K5a and K5b (ops/mont_mma.py), as the reference's engines do.

Port of `contangle_zkcp_tpu/ops/pallas_mont.py` (`MontMulLanes.mul_t`,
`MontMulLanes.butterfly_t`).  `butterfly` is one NTT stage at
`butterfly_t`'s own boundary (csrc/k2_butterfly.cu); `ntt_pass` runs
several stages of the port's NTT in one launch, with the bit reversal
and the scalings fused (csrc/k2_ntt.cu), and is what ops/ntt.py calls.
Operands are `(n, L)` int32 tensors of 16-bit limbs, canonical,
Montgomery form (R = 2^(16 L)), batch-major: the layout of the JAX
package's public functions.  The kernels pack limb pairs into 32-bit
words themselves (csrc/mont.cuh).

A wrapper launches its CUDA kernel for a CUDA tensor and raises if it
cannot; it takes the plain torch twin only for a tensor on the CPU.  The
twins repeat the reference's wide/SOS reduction (`fields/fp.py
_mul_xla`) in int64 and are what the CPU tests run; on the card they
serve only as the yardstick `chip_smoke.py` holds the kernels against.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

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


# ------------------------------------------------- NTT passes (K2, redesigned)
#
# One launch of k2_ntt_pass runs stages s0 .. s0+t-1 of the radix-2
# decimation-in-time loop (stage s: block m = 2^(s+1), pairs (i, i + m/2),
# twiddle w^(j n/m) for j = i mod m/2) over the whole (n, L) array.  Its
# constants are packed: the twiddle table (w^j, j < n/2) and the pre- and
# post-scales are rows of L/2 little-endian 32-bit words (`pack_words`),
# made once per NTT; the array itself crosses the boundary as limbs.

def pack_words(t):
    """(m, L) int32 limbs -> (m, L/2) int32 words, limb pairs lo | hi << 16."""
    x = t.to(torch.int64)
    w = x[:, 0::2] | (x[:, 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).contiguous()


def unpack_words(w):
    """(m, L/2) int32 words -> (m, L) int32 limbs."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([x & lb.LIMB_MASK, x >> lb.LIMB_BITS], dim=-1)
    return limbs.reshape(w.shape[0], -1).to(torch.int32)


@lru_cache(maxsize=None)
def _bit_reverse_perm(n: int, device: str) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros(n, dtype=torch.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev.to(device)


def bit_reverse_perm(n: int, device="cpu") -> torch.Tensor:
    """(n,) int64: i -> i with its log2 n bits reversed; one tensor per
    (n, device), kept (no host copy once made, so CUDA graphs may capture
    its users)."""
    return _bit_reverse_perm(n, str(torch.device(device)))


def ntt_stage(F, a, tw, s: int, bf):
    """Stage s of the loop on (N, L) limbs, with (n/2, L) twiddle limbs tw:
    ONE call of `bf` (butterfly, or butterfly_plain) over the stage's N/2
    (u, v, twiddle) triples, the block structure only in the reshapes.  N
    may be a multiple of n: a batch of N/n transforms one after another
    (a stage's blocks never cross a transform's end)."""
    N, L = a.shape
    n = 2 * tw.shape[0]
    m = 1 << (s + 1)
    half = m // 2
    stw = aligned(tw[:: n // m][:half][None].expand(N // m, half, L).reshape(N // 2, L))
    blk = a.reshape(N // m, 2, half, L)
    u = aligned(blk[:, 0].reshape(N // 2, L))
    v = aligned(blk[:, 1].reshape(N // 2, L))
    hi, lo = bf(F, u, v, stw)
    return torch.stack([hi.reshape(N // m, half, L), lo.reshape(N // m, half, L)], dim=1).reshape(N, L)


def ntt_pass_plain(F, a, table, s0: int, t: int, pre=None, post=None, gather: bool = False,
                   mul=None, bf=None):
    """Plain torch version of one k2_ntt_pass launch: a * pre (pre indexed by
    source position), the bit-reversal gather, stages s0 .. s0+t-1 through
    butterfly_plain, times post ((n, L/2) by position, or (1, L/2) for all).
    a: (n, L), or a batch (B, n, L) whose transforms share table, pre and
    post.  `mul` and `bf` replace mont_mul_plain and butterfly_plain (the
    tensor-core pass's twin, ops/mont_mma.py ntt_pass_mma_plain)."""
    mul = mul or mont_mul_plain
    bf = bf or butterfly_plain
    n, L = a.shape[-2:]
    B = a.numel() // (n * L)
    x = a.reshape(B * n, L)

    def scale(x, w):  # w: words by position within a transform, or one row
        y = unpack_words(w)
        return mul(F, x, y.repeat(B, 1) if y.shape[0] > 1 else y)

    if pre is not None:
        x = scale(x, pre)
    if gather:
        x = x.reshape(B, n, L).index_select(1, bit_reverse_perm(n, x.device)).reshape(B * n, L)
    tw = unpack_words(table)
    for s in range(s0, s0 + t):
        x = ntt_stage(F, x, tw, s, bf)
    if post is not None:
        x = scale(x, post)
    return x.reshape(a.shape)


def _check_words(F, w, rows, what, like):
    if w.dtype != torch.int32 or w.dim() != 2 or w.shape[1] != F.L // 2 or w.shape[0] not in rows:
        raise ValueError(f"{what}: expected int32 ({' or '.join(map(str, rows))}, {F.L // 2}) words, "
                         f"got {w.dtype} {tuple(w.shape)}")
    if w.device != like.device:
        raise ValueError(f"{what}: on {w.device}, the array on {like.device}")
    if not w.is_contiguous() or (w.is_cuda and w.data_ptr() % 16):
        raise ValueError(f"{what}: must be contiguous (and 16-byte aligned on CUDA)")


def check_pass(F, a, table, s0: int, t: int, pre=None, post=None, gather: bool = False):
    """The operand checks of one NTT pass (K2's and K5b's); a is (n, L) or
    a batch (B, n, L), B >= 1.  Returns (B, n)."""
    if a.dim() not in (2, 3) or (a.dim() == 3 and (a.shape[0] < 1 or not a.is_contiguous())):
        raise ValueError(f"ntt_pass: expected (n, L) or contiguous (B, n, L) limbs, got "
                         f"{tuple(a.shape)}")
    B = a.shape[0] if a.dim() == 3 else 1
    n = check_operands(F, a if a.dim() == 2 else a.view(-1, a.shape[-1])) // B
    logn = n.bit_length() - 1
    if n < 2 or n & (n - 1):
        raise ValueError(f"ntt_pass: n = {n} is not a power of two >= 2")
    if not (s0 >= 0 and t >= 1 and s0 + t <= logn) or (gather and s0 != 0):
        raise ValueError(f"ntt_pass: stages {s0} .. {s0 + t - 1} of {logn} (gather {gather})")
    _check_words(F, table, (n // 2,), "table", a)
    if pre is not None:
        _check_words(F, pre, (n,), "pre", a)
    if post is not None:
        _check_words(F, post, (1, n), "post", a)
    if a.is_cuda and F.L != 16:
        raise ValueError(f"the NTT pass kernels are built for 16-limb fields only (L = {F.L})")
    return B, n


def ntt_pass(F, a, table, s0: int, t: int, pre=None, post=None, gather: bool = False):
    """K2, redesigned: stages s0 .. s0+t-1 of the NTT in one launch of
    k2_ntt_pass (csrc/k2_ntt.cu) for a CUDA array, `ntt_pass_plain` for a
    CPU one.  a: (n, L) limbs, n a power of two, or a batch (B, n, L) of
    transforms, all B in the one launch; table: (n/2, L/2) packed twiddle
    words; pre (n, L/2), post (n or 1, L/2) words, shared by the batch;
    gather (s0 = 0 only) reads the input in bit-reversed order.  Returns a
    new array."""
    B, n = check_pass(F, a, table, s0, t, pre, post, gather)
    if not a.is_cuda:
        return ntt_pass_plain(F, a, table, s0, t, pre, post, gather)
    p, n0 = _words(F)
    out = torch.empty_like(a)
    rc = cuda_lib.lib().k2_ntt_pass(  # the kernel's launcher picks its tile and threads
        a.data_ptr(), out.data_ptr(), table.data_ptr(),
        None if pre is None else pre.data_ptr(), None if post is None else post.data_ptr(),
        int(post is not None and post.shape[0] == n), n, B, s0, t, int(gather),
        F.L // 2, p, n0, cuda_lib.stream_ptr(a),
    )
    cuda_lib.LAUNCHES["k2_ntt_pass"] += 1
    cuda_lib.check(rc, "k2_ntt_pass")
    return out
