"""Vector inner-product argument over BLS12-381 G1 for Pedersen-committed
vectors (torch port): the commitment-opening half of the folding decider.

Port of `contangle_zkcp_tpu/groth16/ipa_vec.py`.  The folding scheme's
accumulators carry unblinded Pedersen vector commitments
comm = <vec, bases> (groth16/folding.py `_commit`).  Such a commitment IS
a bulletproofs-IPA commitment, so a claim <vec, b> = v against any PUBLIC
vector b admits a log-size opening argument.  The decider uses
b = eq(r, .) tables to prove multilinear evaluations of W and E at
sumcheck-chosen points.

Differences from plonkish/ipa.py (halo2's polynomial flavour): the curve
and bases are the caller's (BLS12-381 G1, the fold bases); b is an
arbitrary public vector (the verifier folds it itself); the commitment
and the per-round L/R cross MSMs of 512 points or more run on the
lockstep engine at c = 8 on `device` (kernel K3 on the card), below that
the exact host sum.  The opening folds its generators on the host, two
scalar multiplies a pair, as the reference does.

Soundness is the standard IPA argument: each round's challenge u
compresses (a, b, G) halves with (u, u^-1) weights preserving
P = <a, G> + <a, b> U; the final scalar check binds a_final against the
challenge-folded base and b.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..curves import instances as ci
from ..curves.host import sqrt_mod
from ..fields import instances as fi
from ..ops.msm import msm_host
from .folding import _H1, DEVICE_MSM_MIN, g1_msm

CURVE = ci.BLS12_381_G1
P = fi.BLS12_381_R


def hash_to_g1(tag: bytes, i: int = 0):
    """Cofactor-cleared try-and-increment point (independent base U)."""
    ctr = 0
    while True:
        h = hashlib.sha256(
            tag + i.to_bytes(4, "little") + ctr.to_bytes(4, "little")
        ).digest()
        x = int.from_bytes(h, "big") % CURVE.p
        y2 = (x * x * x + CURVE.b) % CURVE.p
        y = sqrt_mod(y2, CURVE.p)
        if y is not None:
            return CURVE.mul(_H1, (x, min(y, CURVE.p - y)))
        ctr += 1


@dataclass
class VecIpaProof:
    rounds: list  # [(L, R)] affine points
    a_final: int


class VectorIPA:
    """Opening argument for <vec, b> against comm = <vec, bases>."""

    def __init__(self, bases, u_point=None, use_device_msm: bool = True, device="cuda"):
        n = len(bases)
        assert n & (n - 1) == 0, "basis length must be a power of two"
        self.n = n
        self.G = list(bases)
        self.U = u_point if u_point is not None else hash_to_g1(b"contangle-decider-u")
        self._msm = g1_msm(device) if use_device_msm and n >= DEVICE_MSM_MIN else None

    def _msm_run(self, points, scalars):
        scalars = [s % P for s in scalars]
        if self._msm is not None and len(points) >= DEVICE_MSM_MIN:
            return self._msm.run(list(points), scalars)
        return msm_host(CURVE, points, scalars)

    def commit(self, vec):
        assert len(vec) <= self.n
        vec = list(vec) + [0] * (self.n - len(vec))
        return self._msm_run(self.G, vec)

    # ---------------------------------------------------------------- open
    def open(self, vec, b, transcript) -> VecIpaProof:
        """Prove <vec, b> (b public).  transcript: decider transcript
        with absorb_point/absorb_scalars/squeeze_scalar."""
        p = P
        a = [x % p for x in vec] + [0] * (self.n - len(vec))
        b = [x % p for x in b] + [0] * (self.n - len(b))
        G = list(self.G)
        rounds = []
        while len(a) > 1:
            h = len(a) // 2
            a_lo, a_hi = a[:h], a[h:]
            b_lo, b_hi = b[:h], b[h:]
            G_lo, G_hi = G[:h], G[h:]
            vL = sum(ai * bi for ai, bi in zip(a_lo, b_hi)) % p
            vR = sum(ai * bi for ai, bi in zip(a_hi, b_lo)) % p
            L = CURVE.add(self._msm_run(G_hi, a_lo), CURVE.mul(vL, self.U))
            R = CURVE.add(self._msm_run(G_lo, a_hi), CURVE.mul(vR, self.U))
            transcript.absorb_point(L)
            transcript.absorb_point(R)
            u = transcript.squeeze_scalar()
            ui = pow(u, -1, p)
            a = [(lo * u + hi * ui) % p for lo, hi in zip(a_lo, a_hi)]
            b = [(lo * ui + hi * u) % p for lo, hi in zip(b_lo, b_hi)]
            G = [
                CURVE.add(CURVE.mul(ui, gl), CURVE.mul(u, gh))
                for gl, gh in zip(G_lo, G_hi)
            ]
            rounds.append((L, R))
        return VecIpaProof(rounds=rounds, a_final=a[0])

    # -------------------------------------------------------------- verify
    def verify(self, comm, b, v, proof: VecIpaProof, transcript) -> bool:
        p = P
        b = [x % p for x in b] + [0] * (self.n - len(b))
        Pt = CURVE.add(comm, CURVE.mul(v % p, self.U))
        us = []
        for L, R in proof.rounds:
            transcript.absorb_point(L)
            transcript.absorb_point(R)
            u = transcript.squeeze_scalar()
            us.append(u)
            Pt = CURVE.add(
                Pt,
                CURVE.add(
                    CURVE.mul(u * u % p, L), CURVE.mul(pow(u, -2, p), R)
                ),
            )
        k = len(us)
        if (1 << k) != self.n:
            return False
        # challenge-fold vector s: s_i = prod u_j^{b_ij ? 1 : -1}
        s = [1] * self.n
        span = self.n
        for j in range(k):
            span //= 2
            uj = us[j]
            uji = pow(uj, -1, p)
            for i in range(self.n):
                s[i] = s[i] * (uj if (i // span) % 2 else uji) % p
        G_final = self._msm_run(self.G, s)
        b_final = sum(si * bi for si, bi in zip(s, b)) % p
        rhs = CURVE.add(
            CURVE.mul(proof.a_final, G_final),
            CURVE.mul(proof.a_final * b_final % p, self.U),
        )
        return Pt == rhs
