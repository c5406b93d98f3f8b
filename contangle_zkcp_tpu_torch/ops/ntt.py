"""Radix-2 NTT / iNTT over a SNARK scalar field (torch).

Port of `contangle_zkcp_tpu/ops/ntt.py`: natural-order in and out,
Cooley-Tukey with an up-front bit-reversal gather, then log2(n) stages.

The transform runs as the passes of `pass_plan(n)`: each pass is ONE call
of `ops/mont.py ntt_pass` (kernel K2's k2_ntt_pass on the card, its twin
on the CPU), which runs several stages with the array's tiles in shared
memory; under `ZKCP_MXU=1`, of `ops/mont_mma.py ntt_pass_mma` (K5b's
k5b_ntt_pass, the multiplies' constant products on the tensor cores).
The first pass gathers through the bit reversal and applies the coset
powers of `coset_forward`; the last applies n^-1 (`inverse`) or n^-1 g^-i
(`coset_inverse`).  `forward_batched` and `inverse_batched` run a
batch (B, n, L) of transforms, each pass one launch for the whole batch.
`NTT.stage_route` keeps the one-stage route (one
`ops/mont.py butterfly` call a stage, the scalings as `F.mul`) as the
yardstick the passes are timed and checked against.

Twiddles: stage s (block m = 2^(s+1)) uses w_m^j = w^(j n/m), j < m/2 —
a strided slice of ONE table of w^j, j < n/2, built on the device by
log2(n) doubling multiplies (no per-element host work), and packed once
into 32-bit words for the passes.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..fields import instances as fi
from ..fields.fp import Fp
from . import mont_mma
from .mont import bit_reverse_perm, butterfly, ntt_pass, ntt_stage, pack_words

# stages a pass at most (csrc/k2_ntt.cu takes up to NTT_TILE_LOG): tiles of
# 2^9 elements leave n / 2^9 blocks for the card's SMs
PASS_BITS = 9


def pass_plan(n: int):
    """[(s0, t), ...]: the passes of an n-point transform, t stages from
    stage s0 each, covering stages 0 .. log2 n - 1 in order.  The fewest
    passes of at most PASS_BITS stages, the stages spread evenly (the
    first passes take the extra stage): 2^18 -> 9 + 9, 2^15 -> 8 + 7,
    2^12 -> 6 + 6, 2^22 -> 8 + 7 + 7, n <= 2^9 in one pass."""
    logn = n.bit_length() - 1
    k = max(1, -(-logn // PASS_BITS))
    plan, s0 = [], 0
    for i in range(k):
        t = logn // k + (i < logn % k)
        plan.append((s0, t))
        s0 += t
    return plan


def powers(F: Fp, g: int, n: int, device) -> torch.Tensor:
    """(g^i)_{i<n} in Montgomery form, n a power of two, built by doubling:
    table[2^k : 2^(k+1)] = table[:2^k] * g^(2^k)."""
    tbl = F.encode([1], device=device)
    gk = g % F.p
    while tbl.shape[0] < n:
        tbl = torch.cat([tbl, F.mul(tbl, F.encode(gk, device=device))], dim=0)
        gk = gk * gk % F.p
    return tbl[:n]


class NTT:
    """NTT engine for a fixed field + domain size n (power of two)."""

    def __init__(self, F: Fp, n: int, device="cuda"):
        assert n & (n - 1) == 0 and n >= 2
        self.F = F
        self.n = n
        self.logn = n.bit_length() - 1
        self.device = torch.device(device)
        self.plan = pass_plan(n)
        w = fi.root_of_unity(F.p, n)
        self.omega = w
        self.omega_inv = pow(w, -1, F.p)
        self.n_inv = pow(n, -1, F.p)
        self._tw_fwd = powers(F, w, n // 2, self.device)
        self._tw_inv = powers(F, self.omega_inv, n // 2, self.device)
        self._tw_fwd_w = pack_words(self._tw_fwd)
        self._tw_inv_w = pack_words(self._tw_inv)
        self._n_inv_m = F.encode(self.n_inv, device=self.device)
        self._n_inv_w = pack_words(self._n_inv_m[None])

    def _passes(self, a, table, pre=None, post=None):
        """The plan's passes over (n, L) Montgomery limbs: the gather (and
        pre) in the first, post in the last; K5b's passes under ZKCP_MXU=1."""
        x, last = a, len(self.plan) - 1
        dev = a.device
        run = mont_mma.ntt_pass_mma if mont_mma.use_mxu() else ntt_pass
        for i, (s0, t) in enumerate(self.plan):
            x = run(
                self.F, x, table.to(dev), s0, t,
                pre=pre.to(dev) if i == 0 and pre is not None else None,
                post=post.to(dev) if i == last and post is not None else None,
                gather=i == 0,
            )
        return x

    def _stage_loop(self, a, table):
        """The bit reversal, then one `butterfly` call (K2's one-stage
        kernel, or K5b under ZKCP_MXU=1) a stage; table: (n/2, L) limbs."""
        a = a.index_select(0, bit_reverse_perm(self.n, a.device))
        table = table.to(a.device)
        for s in range(self.logn):
            a = ntt_stage(self.F, a, table, s, butterfly)
        return a

    def stage_route(self, op: str, a, g: int | None = None):
        """`op` as the stage loop with `F.mul` scalings: the one-stage route
        the passes replaced (K2's, or K5b's and K5a's under ZKCP_MXU=1),
        kept to time and check them against."""
        F = self.F
        if op == "coset_forward":
            a = F.mul(a, self._coset_scale(g).to(a.device))
        out = self._stage_loop(a, self._tw_fwd if op.endswith("forward") else self._tw_inv)
        if op.endswith("inverse"):
            out = F.mul(out, self._n_inv_m.to(a.device))
        if op == "coset_inverse":
            out = F.mul(out, self._coset_scale(pow(g, -1, F.p)).to(a.device))
        return out

    def pass_operands(self, op: str, g: int | None = None):
        """(table, pre, post) words of `op`'s passes: g^i before the first
        pass of coset_forward, n^-1 (or n^-1 g^-i) after the last pass of
        inverse (coset_inverse)."""
        if op not in ("forward", "inverse", "coset_forward", "coset_inverse"):
            raise ValueError(f"unknown NTT operation {op!r}")
        table = self._tw_fwd_w if op.endswith("forward") else self._tw_inv_w
        pre = self._coset_words(g) if op == "coset_forward" else None
        post = None
        if op == "inverse":
            post = self._n_inv_w
        elif op == "coset_inverse":
            post = self._coset_inverse_words(g)
        return table, pre, post

    def _run(self, op: str, a, g: int | None = None):
        return self._passes(a, *self.pass_operands(op, g))

    def forward(self, a):
        """Coefficients -> evaluations at the n-th roots (natural order)."""
        return self._run("forward", a)

    def inverse(self, a):
        """Evaluations -> coefficients."""
        return self._run("inverse", a)

    def _batch(self, a):
        if a.dim() != 3 or a.shape[1] != self.n:
            raise ValueError(f"expected a (B, {self.n}, L) batch, got {tuple(a.shape)}")
        return a.contiguous()

    def forward_batched(self, a):
        """(B, n, L) -> (B, n, L): the DFT along axis 1 (natural order), each
        pass of the plan ONE launch for all B transforms (the four-step
        NTT's columns and rows, parallel/ntt_sharded.py)."""
        return self._passes(self._batch(a), self._tw_fwd_w)

    def inverse_batched(self, a):
        """(B, n, L) -> (B, n, L): the inverse DFT along axis 1, times n^-1
        (fused into the last pass)."""
        return self._passes(self._batch(a), self._tw_inv_w, post=self._n_inv_w)

    # ------------------------------------------------------------ coset ops
    @lru_cache(maxsize=4)
    def _coset_scale(self, g: int):
        """(g^i)_{i<n} in Montgomery form."""
        return powers(self.F, g, self.n, self.device)

    @lru_cache(maxsize=4)
    def _coset_words(self, g: int):
        """g^i as the first pass's pre-scale words."""
        return pack_words(self._coset_scale(g))

    @lru_cache(maxsize=4)
    def _coset_inverse_words(self, g: int):
        """n^-1 g^-i as the last pass's post-scale words."""
        ginv = self._coset_scale(pow(g, -1, self.F.p))
        return pack_words(self.F.mul(ginv, self._n_inv_m))

    def coset_forward(self, a, g: int):
        """Evaluate the polynomial on the coset g*<omega>."""
        return self._run("coset_forward", a, g)

    def coset_inverse(self, a, g: int):
        """Interpolate from evaluations on the coset g*<omega>."""
        return self._run("coset_inverse", a, g)

    # --------------------------------------------------------------- host
    def h_forward(self, coeffs):
        """Exact host reference (for tests): evaluate at w^0..w^{n-1}."""
        p, n, w = self.F.p, self.n, self.omega
        out = []
        for i in range(n):
            x = pow(w, i, p)
            acc = 0
            for c in reversed(coeffs):
                acc = (acc * x + c) % p
            out.append(acc)
        return out
