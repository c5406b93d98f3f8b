"""Poseidon permutation + duplex sponge (ark-sponge 0.3 semantics).

The reference's only hash: a width-3 (rate 2, capacity 1) Poseidon with
alpha=17, 8 full + 31 partial rounds, using the hard-coded
"bls12377_rate2_constraints" constant set parsed *into the circuit field*
(constants reduce mod p — nulltea/contangle-zkcp:circuits-ark/src/poseidon.rs:13-41,
parameters at parameters.rs:11-230, transcribed to poseidon_params_p1.json).

Used for: the ElGamal KDF `dh = H(r*pk)` (encryption.rs:154-172), the
Merkle leaf/2-to-1 CRHs of the SampleEntries circuit, and the in-circuit
`PoseidonSpongeVar` — all of which reduce to the two fixed absorb/squeeze
patterns `hash2` / `hash1` below.

Sponge semantics (ark-sponge 0.3 duplex):
  state layout [capacity | rate]; fresh state = zeros, mode Absorbing(0);
  absorb adds into state[capacity+i], permuting when the rate is full;
  squeeze permutes once then reads state[capacity+i].
Absorbing a curve point absorbs its affine coordinates [x, y].

Port of `contangle_zkcp_tpu/ops/poseidon.py`.  Two implementations,
bit-identical:
  * host: exact Python ints (witness generation, protocol layer, tests);
  * device: batched over leading axes on limb tensors (`PoseidonDevice`):
    every Merkle level is one batch, each round's multiplies one `Fp.mul`
    (kernel K1, or K5a under ZKCP_MXU=1).
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import torch

_PARAMS_PATH = os.path.join(os.path.dirname(__file__), "poseidon_params_p1.json")

WIDTH = 3
RATE = 2
CAPACITY = 1


@lru_cache(maxsize=1)
def _raw_params():
    with open(_PARAMS_PATH) as f:
        d = json.load(f)
    return d


@lru_cache(maxsize=None)
def p1_params(p: int):
    """(ark, mds, alpha, full_rounds, partial_rounds) with constants mod p."""
    d = _raw_params()
    ark = [[int(x) % p for x in row] for row in d["ark"]]
    mds = [[int(x) % p for x in row] for row in d["mds"]]
    return ark, mds, d["alpha"], d["full_rounds"], d["partial_rounds"]


# --------------------------------------------------------------------- host
class PoseidonHost:
    """Exact scalar Poseidon over F_p (Python ints)."""

    def __init__(self, p: int):
        self.p = p
        self.ark, self.mds, self.alpha, self.rf, self.rp = p1_params(p)

    def permute(self, state):
        p = self.p
        state = list(state)
        half = self.rf // 2
        total = self.rf + self.rp
        for r in range(total):
            state = [(s + a) % p for s, a in zip(state, self.ark[r])]
            full = r < half or r >= half + self.rp
            if full:
                state = [pow(s, self.alpha, p) for s in state]
            else:
                state[0] = pow(state[0], self.alpha, p)
            state = [
                sum(self.mds[i][j] * state[j] for j in range(WIDTH)) % p
                for i in range(WIDTH)
            ]
        return state

    def hash2(self, x: int, y: int) -> int:
        """Absorb [x, y] into a fresh sponge, squeeze 1 (the ElGamal KDF /
        TwoToOne CRH pattern)."""
        return self.permute([0, x % self.p, y % self.p])[CAPACITY]

    def hash1(self, x: int) -> int:
        """Absorb [x], squeeze 1 (leaf CRH pattern)."""
        return self.permute([0, x % self.p, 0])[CAPACITY]


class SpongeHost:
    """Full duplex sponge (ark-sponge 0.3), exact host ints."""

    def __init__(self, perm: PoseidonHost):
        self.perm = perm
        self.state = [0] * WIDTH
        self.absorb_index = 0  # next rate slot to absorb into
        self.squeeze_index = None  # None = absorbing mode

    def absorb(self, elems):
        if not elems:
            return
        if self.squeeze_index is not None:
            self.state = self.perm.permute(self.state)
            self.absorb_index = 0
            self.squeeze_index = None
        i = self.absorb_index
        if i == RATE:
            self.state = self.perm.permute(self.state)
            i = 0
        for e in elems:
            if i == RATE:
                self.state = self.perm.permute(self.state)
                i = 0
            self.state[CAPACITY + i] = (self.state[CAPACITY + i] + e) % self.perm.p
            i += 1
        self.absorb_index = i

    def squeeze(self, n: int):
        out = []
        if self.squeeze_index is None:
            self.state = self.perm.permute(self.state)
            i = 0
        else:
            i = self.squeeze_index
        while len(out) < n:
            if i == RATE:
                self.state = self.perm.permute(self.state)
                i = 0
            out.append(self.state[CAPACITY + i])
            i += 1
        self.squeeze_index = i
        self.absorb_index = None
        return out


# ------------------------------------------------------------------- device
class PoseidonDevice:
    """Batched Poseidon on limb tensors: the state is (..., 3, L) int32 in
    Montgomery form, every lane of the leading axes one permutation.  The
    round constants and the MDS matrix are Montgomery tensors, made on each
    device the first time it is used; operations run where their operands
    are."""

    def __init__(self, F):
        self.F = F
        ark, mds, self.alpha, self.rf, self.rp = p1_params(F.p)
        assert self.alpha == 17, "device s-box addition chain assumes alpha=17"
        self.total_rounds = self.rf + self.rp
        self.half = self.rf // 2
        self._ark, self._mds = ark, mds
        self._consts = {}

    def consts(self, device):
        """(ark (rounds, 3, L), mds (3, 3, L)) Montgomery tensors on device."""
        key = str(torch.device(device))
        if key not in self._consts:
            F = self.F
            ark = F.encode([x for row in self._ark for x in row], device=device)
            mds = F.encode([x for row in self._mds for x in row], device=device)
            self._consts[key] = (ark.reshape(-1, WIDTH, F.L), mds.reshape(WIDTH, WIDTH, F.L))
        return self._consts[key]

    def _pow_alpha(self, x):
        # alpha = 17 = 10001b: 4 squarings + 1 multiply
        F = self.F
        s = x
        for _ in range(4):
            s = F.mul(s, s)
        return F.mul(s, x)

    def _round(self, r, state, full: bool):
        F = self.F
        ark, mds = self.consts(state.device)
        state = F.add(state, ark[r])
        if full:
            state = self._pow_alpha(state)
        else:  # partial round: the s-box on the first element only
            state = torch.cat([self._pow_alpha(state[..., :1, :]), state[..., 1:, :]], dim=-2)
        # MDS: new_i = sum_j mds[i][j] * s_j, one (..., 3, 3) batch multiply
        prod = F.mul(mds, state[..., None, :, :])
        acc = F.add(prod[..., 0, :], prod[..., 1, :])
        return F.add(acc, prod[..., 2, :])

    def permute(self, state):
        """state: (..., 3, L) Montgomery limbs -> same shape."""
        for r in range(self.total_rounds):
            full = r < self.half or r >= self.half + self.rp
            state = self._round(r, state, full)
        return state

    def hash2(self, x, y):
        """Batched hash2: x, y (..., L) Montgomery -> (..., L) Montgomery."""
        zero = torch.zeros_like(x)
        return self.permute(torch.stack([zero, x, y], dim=-2))[..., CAPACITY, :]

    def hash1(self, x):
        zero = torch.zeros_like(x)
        return self.permute(torch.stack([zero, x, zero], dim=-2))[..., CAPACITY, :]
