"""Inner-product-argument polynomial commitment over the Pasta curves.

Port of `contangle_zkcp_tpu/plonkish/ipa.py`.  The halo2 pipeline's
commitment scheme (halo2_proofs 0.2 uses IPA over Pasta): polynomials
over the Pallas base field are committed on the Vesta curve (whose scalar
field is that same field), with a Bulletproofs-style log-round opening
argument and Fiat-Shamir challenges.  Commitments, proofs and challenges
are the reference's, value for value.

With `use_device_msm` the device does what the reference's device does:
  * every MSM of 256 points or more (commitments, and the opening rounds'
    L and R) through `ops/msm.py MSM` over Vesta's base field
    (`pasta_fq`, c = 8), whose bucket adds are kernel K3 on the card;
  * the generator fold of the opening rounds while the vector holds at
    least 1,024 points, down to h < 256: two batched 255-bit ladders
    (`SWDevice.scalar_mul_bits`, two K3 launches a bit) and one add per
    round, the generators staying on the device between rounds.
Vesta's prime leaves no room for lazy reduction (4p > 2^256), so K3 runs
its strict arithmetic there (csrc/fp_lazy.cuh; ops/curve_add.py picks it
from p).  The rest — the scalar folds, the inner products, the
transcript and the tail rounds — is host arithmetic, as in the reference.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from ..curves import instances as ci
from ..curves.host import sqrt_mod
from ..fields import instances as fi
from ..ops.msm import msm_host

CURVE = ci.VESTA  # commitments live on Vesta; scalars in PASTA_P
SCALAR_P = fi.PASTA_P
DEVICE_MSM_MIN = 256  # MSMs from this many points run on the device
DEVICE_FOLD_MIN = 1024  # generator vectors from this size fold on the device


def _hash_to_point(tag: bytes, i: int):
    """Deterministic generator derivation (try-and-increment)."""
    ctr = 0
    while True:
        h = hashlib.sha256(tag + i.to_bytes(4, "little") + ctr.to_bytes(4, "little")).digest()
        x = int.from_bytes(h, "big") % CURVE.p
        y2 = (x * x * x + CURVE.b) % CURVE.p
        y = sqrt_mod(y2, CURVE.p)
        if y is not None:
            return (x, y if y % 2 == 0 else CURVE.p - y)
        ctr += 1


@dataclass
class IpaProof:
    rounds: list  # [(L, R)] points
    a_final: int


class IPA:
    def __init__(self, n: int, use_device_msm: bool = False, device="cuda"):
        assert n & (n - 1) == 0
        self.n = n
        self.G = [_hash_to_point(b"contangle-ipa-g", i) for i in range(n)]
        self.U = _hash_to_point(b"contangle-ipa-u", 0)
        self._msm = None
        self._dev = None
        self._G_dev = None
        if use_device_msm:
            from ..curves.weierstrass import SWDevice
            from ..ops.msm import MSM

            self._dev = SWDevice(fi.pasta_fq(), CURVE, device=device)
            self._msm = MSM(self._dev, scalar_bits=SCALAR_P.bit_length(), c=8)
            self._G_dev = self._dev.encode_points(self.G)

    # ------------------------------------------------------------ commit
    def _msm_run(self, points, scalars):
        scalars = [s % SCALAR_P for s in scalars]
        if self._msm is not None and len(points) >= DEVICE_MSM_MIN:
            return self._msm.run(list(points), scalars)
        return msm_host(CURVE, points, scalars)

    def _msm_dev(self, pts_dev, scalars):
        """MSM over a slice of the device-resident generators."""
        n = int(pts_dev["x"].shape[0])
        if self._msm is not None and n >= DEVICE_MSM_MIN:
            return self._msm.run(pts_dev, [s % SCALAR_P for s in scalars])
        return msm_host(CURVE, self._dev.decode_points(pts_dev), scalars)

    def commit(self, coeffs):
        assert len(coeffs) <= self.n
        coeffs = list(coeffs) + [0] * (self.n - len(coeffs))
        if self._G_dev is not None and self.n >= DEVICE_MSM_MIN:
            # the generators are already on the device: no re-encoding
            return self._msm.run(self._G_dev, [s % SCALAR_P for s in coeffs])
        return self._msm_run(self.G, coeffs)

    # -------------------------------------------------------------- open
    @staticmethod
    def _challenge(transcript: bytes) -> int:
        return int.from_bytes(hashlib.sha256(transcript).digest(), "big") % SCALAR_P

    @staticmethod
    def _pt_bytes(P) -> bytes:
        if P is None:
            return b"\x00" * 33
        return bytes([2 + (P[1] & 1)]) + P[0].to_bytes(32, "big")

    def _bits(self, k: int):
        """k's 255 bits, LSB first, as a tensor on the generators' device."""
        nb = SCALAR_P.bit_length()
        return torch.tensor([(k >> i) & 1 for i in range(nb)], dtype=torch.int32,
                            device=self._dev.device)

    def open(self, coeffs, x: int, transcript=None):
        """Prove p(x) = v for the committed coefficients.

        With the device engine, the generator vector stays on the device
        across the folding rounds (each fold is two batched fixed-scalar
        ladders and one add) until fewer than 256 points are left.

        `transcript`: optional shared Blake2bTranscript (halo2 style —
        the IPA rounds absorb L/R into the SAME running transcript the
        outer protocol uses and squeeze challenges from it); without
        one, the standalone SHA256 chain below."""
        p = SCALAR_P
        a = list(coeffs) + [0] * (self.n - len(coeffs))
        b = [pow(x, i, p) for i in range(self.n)]
        use_dev = self._dev is not None and self.n >= DEVICE_FOLD_MIN
        G = None if use_dev else list(self.G)
        G_dev = dict(self._G_dev) if use_dev else None
        if transcript is None:
            chain = self._pt_bytes(self.commit(coeffs)) + x.to_bytes(32, "big")
        else:
            transcript.common_scalar(x)
        rounds = []
        while len(a) > 1:
            h = len(a) // 2
            a_lo, a_hi = a[:h], a[h:]
            b_lo, b_hi = b[:h], b[h:]
            vL = sum(ai * bi for ai, bi in zip(a_lo, b_hi)) % p
            vR = sum(ai * bi for ai, bi in zip(a_hi, b_lo)) % p
            if use_dev:
                G_lo = {k: v[:h] for k, v in G_dev.items()}
                G_hi = {k: v[h:] for k, v in G_dev.items()}
                L = CURVE.add(self._msm_dev(G_hi, a_lo), CURVE.mul(vL, self.U))
                R = CURVE.add(self._msm_dev(G_lo, a_hi), CURVE.mul(vR, self.U))
            else:
                G_lo, G_hi = G[:h], G[h:]
                L = CURVE.add(self._msm_run(G_hi, a_lo), CURVE.mul(vL, self.U))
                R = CURVE.add(self._msm_run(G_lo, a_hi), CURVE.mul(vR, self.U))
            if transcript is None:
                chain = hashlib.sha256(
                    chain + self._pt_bytes(L) + self._pt_bytes(R)
                ).digest()
                u = self._challenge(chain)
            else:
                transcript.common_point(L)
                transcript.common_point(R)
                u = transcript.squeeze_challenge() % p
            ui = pow(u, -1, p)
            a = [(lo * u + hi * ui) % p for lo, hi in zip(a_lo, a_hi)]
            b = [(lo * ui + hi * u) % p for lo, hi in zip(b_lo, b_hi)]
            if use_dev:
                G_dev = self._dev.add(
                    self._dev.scalar_mul_bits(G_lo, self._bits(ui)),
                    self._dev.scalar_mul_bits(G_hi, self._bits(u)),
                )
                if h < DEVICE_MSM_MIN:  # tail rounds on the host (few points left)
                    use_dev = False
                    G = self._dev.decode_points(G_dev)
            else:
                G = [
                    CURVE.add(CURVE.mul(ui, gl), CURVE.mul(u, gh))
                    for gl, gh in zip(G_lo, G_hi)
                ]
            rounds.append((L, R))
        return IpaProof(rounds=rounds, a_final=a[0])

    # ------------------------------------------------------------ verify
    def verify(self, commitment, x: int, v: int, proof: IpaProof, transcript=None) -> bool:
        p = SCALAR_P
        P = CURVE.add(commitment, CURVE.mul(v % p, self.U))
        if transcript is None:
            chain = self._pt_bytes(commitment) + x.to_bytes(32, "big")
        else:
            transcript.common_scalar(x)
        us = []
        for L, R in proof.rounds:
            if transcript is None:
                chain = hashlib.sha256(
                    chain + self._pt_bytes(L) + self._pt_bytes(R)
                ).digest()
                u = self._challenge(chain)
            else:
                transcript.common_point(L)
                transcript.common_point(R)
                u = transcript.squeeze_challenge() % p
            us.append(u)
            P = CURVE.add(
                P,
                CURVE.add(
                    CURVE.mul(u * u % p, L), CURVE.mul(pow(u, -2, p), R)
                ),
            )
        # fold the generator/point vectors with the s-vector
        k = len(us)
        assert (1 << k) == self.n
        uinv = [pow(u, -1, p) for u in us]
        s = []
        for i in range(self.n):
            acc = 1
            for j in range(k):
                bit = (i >> (k - 1 - j)) & 1
                acc = acc * (us[j] if bit else uinv[j]) % p
            s.append(acc)
        G_final = self.commit(s)
        b_final = sum(si * pow(x, i, p) for i, si in enumerate(s)) % p
        rhs = CURVE.add(
            CURVE.mul(proof.a_final, G_final),
            CURVE.mul(proof.a_final * b_final % p, self.U),
        )
        return P == rhs
