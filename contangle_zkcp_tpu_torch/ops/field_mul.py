"""K4: the row-major Montgomery multiply entry point, wrapper and twin.

Port of `contangle_zkcp_tpu/ops/pallas_field.py` (`PallasFieldOps`, made by
`make(F)`): the round-1 kernel on `(N, L)` limbs with the limb axis
minor.  `mul` launches kernel K4 (`k4_field_mul`, the K1 kernel template
under its own entry and launch count: K1 already reads `(n, L)` row-major
limbs) for a CUDA tensor and raises if it cannot; for a CPU tensor it takes
the twin.  `mul_reference` is the twin on any device: `mont_mul_block`
ported to torch (schoolbook columns by shifted adds, Kogge-Stone carry
resolution by log-step shifts, the wide/SOS reduction), in int64.
"""

from __future__ import annotations

import torch

from ..fields.limbs import LIMB_BITS, LIMB_MASK
from . import cuda_lib
from .mont import _words, check_operands


def _shift_limbs_up(x, k: int):
    """Shift along the last (limb) axis toward higher indices by k."""
    if k == 0:
        return x
    return torch.nn.functional.pad(x[..., :-k], (k, 0))


def _ks_scan(s):
    """Generate/propagate scan of limbwise sums (< 2^17): (limbs, the
    generate bits after the scan; the top one is the carry out)."""
    g = (s >> LIMB_BITS) & 1
    lo = s & LIMB_MASK
    p = (lo == LIMB_MASK).to(s.dtype)
    sh = 1
    while sh < s.shape[-1]:
        g = g | (p & _shift_limbs_up(g, sh))
        p = p & _shift_limbs_up(p, sh)
        sh *= 2
    return (lo + _shift_limbs_up(g, 1)) & LIMB_MASK, g


def _ks_resolve(s):
    """Exact carry resolution of limbwise sums (< 2^17) into 16-bit limbs."""
    return _ks_scan(s)[0]


def _ks_sub(a, b):
    """Exact a - b on 16-bit limb vectors -> (diff, no_borrow (.., 1))."""
    one = torch.zeros_like(a)
    one[..., 0] = 1
    out, g = _ks_scan(a + ((~b) & LIMB_MASK) + one)
    return out, g[..., -1:]


def _product_cols(x, y, L: int):
    """Redundant schoolbook columns (.., 2L+1): lo halves of x_i*y_j at
    column i+j, hi halves at i+j+1."""
    c = torch.zeros(torch.broadcast_shapes(x.shape[:-1], y.shape[:-1]) + (2 * L + 1,),
                    dtype=torch.int64, device=x.device)
    for i in range(L):
        prod = x[..., i : i + 1] * y
        c[..., i : i + L] += prod & LIMB_MASK
        c[..., i + 1 : i + 1 + L] += prod >> LIMB_BITS
    return c


def _normalize(cols, out_len: int):
    """Resolve redundant columns (< 2^26) exactly to 16-bit limbs."""
    s = (cols & LIMB_MASK) + _shift_limbs_up(cols >> LIMB_BITS, 1)
    return _ks_resolve(s)[..., :out_len]


def mont_mul_block(a, b, p_limbs, npinv_limbs, L: int):
    """The reference's `mont_mul_block` on (n, L) int64 limbs."""
    t_cols = _product_cols(a, b, L)
    t_lo = _normalize(t_cols[..., : L + 1], L)
    m = _normalize(_product_cols(t_lo, npinv_limbs, L)[..., : L + 1], L)
    total = t_cols + _product_cols(m, p_limbs, L)
    res = _normalize(total, 2 * L + 1)[..., L : 2 * L + 1]
    out, top = res[..., :L], res[..., L : L + 1]
    d, no_borrow = _ks_sub(out, p_limbs.expand_as(out))
    return torch.where((no_borrow | top) != 0, d, out)


class FieldMul:
    """Row-major Montgomery multiply for one field (the reference's
    `PallasFieldOps`)."""

    def __init__(self, F):
        self.F = F
        self.L = F.L

    def mul_reference(self, a, b):
        """The twin: (n, L) int32 limbs -> (n, L) int32, on any device."""
        F = self.F
        p = F.const("p", a.device).to(torch.int64)
        npinv = F.const("npinv", a.device).to(torch.int64)
        out = mont_mul_block(a.to(torch.int64), b.to(torch.int64), p, npinv, self.L)
        return out.to(torch.int32)

    def mul(self, a, b):
        """K4: a*b*R^-1 mod p for (n, L) int32 limb tensors."""
        F = self.F
        n = check_operands(F, a, b)
        if not a.is_cuda:
            return self.mul_reference(a, b)
        out = torch.empty_like(a)
        if n == 0:
            return out
        p, n0 = _words(F)
        rc = cuda_lib.lib().k4_field_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, F.L // 2, p, n0,
            cuda_lib.stream_ptr(a),
        )
        cuda_lib.LAUNCHES["k4_field_mul"] += 1
        cuda_lib.check(rc, "k4_field_mul")
        return out


def make(F) -> FieldMul:
    """The reference's `make(F, tile)`; the row tile was the TPU grid's,
    and K4's block is its own."""
    return FieldMul(F)
