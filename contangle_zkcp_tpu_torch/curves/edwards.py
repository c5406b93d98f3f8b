"""Batched twisted Edwards group ops on limb tensors (torch).

Port of `contangle_zkcp_tpu/curves/edwards.py`.  Extended coordinates
(X, Y, Z, T) with X*Y = Z*T.  For a = -1 curves (Jubjub, over BLS12-381 Fr,
L = 16) the unified Hisil-Wong-Carter-Dawson formulas are strongly unified:
no special case for doubling or the identity, every lane runs the same
operations.  (The reference's ElGamal uses arkworks' twisted Edwards
backend, circuits-ark/src/encryption.rs:154-217.)

Point batches are dicts {x, y, z, t} of `(..., L)` int32 Montgomery limb
tensors.  Every multiply reaches kernel K1 through `Fp.mul` on the card;
the independent products of one formula go out as ONE stacked multiply
(an add is 3 launches, a double 2), which gives the reference's limbs:
each product is canonical whatever its grouping.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.fp import Fp, as_tensor
from .host import EdwardsCurve


class EdwardsDevice:
    """Batched Jubjub-style (a = -1) twisted Edwards arithmetic."""

    def __init__(self, F: Fp, curve: EdwardsCurve, device="cuda"):
        assert curve.a == F.p - 1, "device formulas specialized to a = -1"
        self.F = F
        self.curve = curve
        self.device = torch.device(device)
        self.k_m = F.encode(2 * curve.d % F.p, device=self.device)  # 2d for the unified add

    # ---------------------------------------------------------------- host
    def encode_points(self, pts):
        """[(x, y), ...] affine ints -> extended-coordinate batch."""
        F = self.F
        return {
            "x": F.encode([p[0] for p in pts], device=self.device),
            "y": F.encode([p[1] for p in pts], device=self.device),
            "z": F.one_mont((len(pts),), device=self.device).clone(),
            "t": F.encode([p[0] * p[1] % F.p for p in pts], device=self.device),
        }

    def decode_points(self, P):
        """Batch -> [(x, y), ...] affine ints (to_affine where the batch
        lives, then only canonical limbs cross to the host)."""
        x, y = self.to_affine(P)
        xy = self.F.decode(torch.stack([x.reshape(-1, self.F.L), y.reshape(-1, self.F.L)]))
        n = len(xy) // 2
        return list(zip(xy[:n], xy[n:]))

    def identity(self, shape=()):
        F = self.F
        zero = F.zeros(shape, device=self.device)
        one = F.one_mont(shape, device=self.device).clone()
        return {"x": zero, "y": one, "z": one.clone(), "t": zero.clone()}

    # -------------------------------------------------------------- device
    def add(self, P, Q):
        """Unified extended addition, a = -1 (add-2008-hwcd-3): 8M + 1k."""
        F = self.F
        A, B, D, TT = F.mul(
            torch.stack([F.sub(P["y"], P["x"]), F.add(P["y"], P["x"]), P["z"], P["t"]]),
            torch.stack([F.sub(Q["y"], Q["x"]), F.add(Q["y"], Q["x"]), F.add(Q["z"], Q["z"]), Q["t"]]),
        )
        C = F.mul(TT, self.k_m)
        E = F.sub(B, A)
        Fv = F.sub(D, C)
        G = F.add(D, C)
        H = F.add(B, A)
        return self._out(E, Fv, G, H)

    def double(self, P):
        """Dedicated doubling (dbl-2008-hwcd), a = -1: 4S + 3M."""
        F = self.F
        xy = F.add(P["x"], P["y"])
        sq = torch.stack([P["x"], P["y"], P["z"], xy])
        A, B, zz, xy2 = F.mul(sq, sq)
        C = F.add(zz, zz)
        D = F.neg(A)  # a*A with a = -1
        E = F.sub(F.sub(xy2, A), B)
        G = F.add(D, B)
        Fv = F.sub(G, C)
        H = F.sub(D, B)
        return self._out(E, Fv, G, H)

    def _out(self, E, Fv, G, H):
        """(E Fv, G H, Fv G, E H) as one stacked multiply."""
        x, y, z, t = self.F.mul(torch.stack([E, G, Fv, E]), torch.stack([Fv, H, G, H]))
        return {"x": x, "y": y, "z": z, "t": t}

    def select(self, cond, P, Q):
        """cond ? P : Q, cond shaped like the batch."""
        return {c: self.F.select(cond, P[c], Q[c]) for c in ("x", "y", "z", "t")}

    def scalar_mul_bits(self, P, bits):
        """Batched double-and-add; bits (..., nbits) int tensor, LSB first
        (the circuit gadget's `scalar_mul_le` order, circuits-ark/src/
        encryption.rs:243-248)."""
        acc = self.identity(P["x"].shape[:-1])
        base = P
        for i in range(bits.shape[-1]):
            acc = self.select(bits[..., i] == 1, self.add(acc, base), acc)
            base = self.double(base)
        return acc

    def scalar_mul_ints(self, P, scalars, nbits=None):
        """Host scalars -> device scalar multiply."""
        nbits = nbits or (8 * ((self.curve.order.bit_length() + 7) // 8))
        ks = np.array([[(s >> (16 * j)) & 0xFFFF for j in range(-(-nbits // 16))] for s in scalars],
                      dtype=np.int64).reshape(len(scalars), -1)
        bits = ((ks[:, :, None] >> np.arange(16)) & 1).reshape(len(scalars), -1)[:, :nbits]
        return self.scalar_mul_bits(P, as_tensor(bits, P["x"].device))

    def to_affine(self, P):
        """(x, y) affine limb batches: one batched inversion of z."""
        F = self.F
        x, y = F.mul(torch.stack([P["x"], P["y"]]), F.batch_inv(P["z"]))
        return x, y
