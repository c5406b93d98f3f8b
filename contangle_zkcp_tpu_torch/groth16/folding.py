"""Nova-style relaxed-R1CS folding (torch port).

Port of `contangle_zkcp_tpu/groth16/folding.py`: any number of satisfied
R1CS instances of one structure (e.g. Proofs of Encryption of one
EncryptCircuit size) fold pairwise into ONE relaxed instance whose single
check certifies them all; groth16/decider.py proves that check without
the witness.

Scheme (Nova, Kothapalli-Setty-Tzialla 2021, folding only, no IVC
circuit):
  relaxed instance  U = (comm_W, comm_E, u, x)
  relaxed witness   W = (W vec, E vec)
  satisfied iff  AZ o BZ = u * CZ + E  with  Z = [u, x.., W..]
  (a plain R1CS instance embeds with u = 1, E = 0: the z layout already
  leads with the constant-1 slot, which relaxation turns into u).

  fold(U1, U2): cross term T = AZ1 o BZ2 + AZ2 o BZ1 - u1 CZ2 - u2 CZ1;
  rho = H(comm_T, U1, U2); everything combines linearly, E picks up
  E1 + rho T + rho^2 E2.

Commitments are Pedersen vector commitments over BLS12-381 G1 (order =
the circuit field).  Work placement, on `device` (default "cuda"):
  * bases: try-and-increment hashing on the host; above 64 bases the
    cofactor is cleared on the device, one batched double-and-add over
    the cofactor's 126 bits (`SWDevice.scalar_mul_bits`: two launches of
    kernel K3 a bit);
  * commitments of 512 entries or more: the lockstep Pippenger engine at
    c = 8 (ops/msm.py; kernel K3 for every bucket add); below that the
    exact host sum `msm_host`;
  * row evaluation: the native C++ engine (r1cs/native.py), with an exact
    Python fallback; the fold's combination and rho: host integers.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from ..curves import instances as ci
from ..fields import instances as fi
from ..ops.msm import msm_host
from ..r1cs.builder import ConstraintSystem

_R = fi.BLS12_381_R
# BLS12-381 G1 cofactor from the family polynomial: (x-1)^2 / 3
_H1 = (fi.BLS_X - 1) ** 2 // 3
# Base counts up to which the cofactor is cleared on the host, and
# vector lengths from which a commitment runs on the device MSM.
HOST_CLEAR_MAX = 64
DEVICE_MSM_MIN = 512


def _hash_points_raw(tag: bytes, count: int):
    """Try-and-increment curve points (NOT yet cofactor-cleared)."""
    C = ci.BLS12_381_G1
    e = (C.p + 1) // 4  # p = 3 mod 4: sqrt by one pow
    out = []
    for i in range(count):
        ctr = 0
        while True:
            h = hashlib.sha256(
                tag + i.to_bytes(4, "little") + ctr.to_bytes(4, "little")
            ).digest()
            x = int.from_bytes(h, "big") % C.p
            y2 = (x * x * x + C.b) % C.p
            y = pow(y2, e, C.p)
            if y * y % C.p == y2:
                out.append((x, min(y, C.p - y)))
                break
            ctr += 1
    return out


def g1_device(device):
    """BLS12-381 G1 on `device` (its adds are kernel K3 on the card)."""
    from ..curves.weierstrass import SWDevice

    return SWDevice(fi.bls12_381_fq(), ci.BLS12_381_G1, device=device)


def g1_msm(device):
    """The lockstep engine at c = 8 over 255-bit scalars, as the
    reference's folding and vector IPA build it."""
    from ..ops.msm import MSM

    return MSM(g1_device(device), scalar_bits=255, c=8)


def _derive_bases(tag: bytes, count: int, device="cuda"):
    """Independent Pedersen bases: hash-to-curve on the host, then the
    cofactor cleared by one batched fixed-scalar multiply on `device`."""
    raw = _hash_points_raw(tag, count)
    if count <= HOST_CLEAR_MAX:
        C = ci.BLS12_381_G1
        return [C.mul(_H1, P) for P in raw]
    dev = g1_device(device)
    bits = torch.tensor(
        [(_H1 >> i) & 1 for i in range(_H1.bit_length())],
        dtype=torch.int32,
        device=dev.device,
    )
    out = dev.scalar_mul_bits(dev.encode_points(raw), bits)
    return dev.decode_points(out)


@dataclass
class RelaxedInstance:
    comm_w: tuple
    comm_e: tuple
    u: int
    x: list  # public inputs (without the leading constant slot)


@dataclass
class RelaxedWitness:
    w: list
    e: list


class FoldingScheme:
    """Folding for one fixed R1CS structure (A, B, C COO + shape)."""

    def __init__(self, cs: ConstraintSystem, use_device_msm: bool = False, device="cuda"):
        self.p = cs.p
        assert cs.p == _R, "folding commitments fixed to BLS12-381 G1"
        self.device = torch.device(device)
        self.ni = cs.num_instance  # includes the leading 1/u slot
        self.nv = cs.num_variables
        self.nc = cs.num_constraints
        self.A, self.B, self.C = cs.matrices_coo()
        nw = self.nv - self.ni
        self.bases_w = _derive_bases(b"contangle-fold-w", nw, self.device)
        self.bases_e = _derive_bases(b"contangle-fold-e", self.nc, self.device)
        self._msm = None
        if use_device_msm or max(nw, self.nc) >= DEVICE_MSM_MIN:
            self._msm = g1_msm(self.device)

    # ---------------------------------------------------------- commitments
    def _commit(self, bases, vec):
        if self._msm is not None and len(vec) >= DEVICE_MSM_MIN:
            return self._msm.run(bases[: len(vec)], [v % self.p for v in vec])
        return msm_host(ci.BLS12_381_G1, bases[: len(vec)], vec)

    # ------------------------------------------------------------- lifting
    def instance_from_cs(self, cs: ConstraintSystem):
        """Satisfied plain R1CS -> (relaxed instance, relaxed witness)."""
        z = cs.full_assignment()
        w = z[self.ni :]
        e = [0] * self.nc
        inst = RelaxedInstance(
            comm_w=self._commit(self.bases_w, w),
            comm_e=None,  # commit of the zero vector is the identity
            u=1,
            x=z[1 : self.ni],
        )
        return inst, RelaxedWitness(w=w, e=e)

    # -------------------------------------------------------------- algebra
    def _mat_vec(self, coo, z):
        from ..r1cs import native

        out = native.eval_rows(self.p, coo, z, self.nc)
        if out is not None:
            return out
        out = [0] * self.nc
        for row, col, coeff in coo:
            out[row] = (out[row] + coeff * z[col]) % self.p
        return out

    def _z(self, inst: RelaxedInstance, wit: RelaxedWitness):
        return [inst.u] + list(inst.x) + list(wit.w)

    def check(self, inst: RelaxedInstance, wit: RelaxedWitness) -> bool:
        p = self.p
        z = self._z(inst, wit)
        az = self._mat_vec(self.A, z)
        bz = self._mat_vec(self.B, z)
        cz = self._mat_vec(self.C, z)
        for i in range(self.nc):
            if az[i] * bz[i] % p != (inst.u * cz[i] + wit.e[i]) % p:
                return False
        if inst.comm_w != self._commit(self.bases_w, wit.w):
            return False
        return inst.comm_e == (
            self._commit(self.bases_e, wit.e) if any(wit.e) else None
        )

    # ---------------------------------------------------------------- fold
    @staticmethod
    def _pt_bytes(P):
        if P is None:
            return b"\x00" * 49
        return bytes([2 + (P[1] & 1)]) + P[0].to_bytes(48, "big")

    def cross_term(self, i1, w1, i2, w2):
        """The Nova cross term T (length-nc vector) for one fold."""
        p = self.p
        z1 = self._z(i1, w1)
        z2 = self._z(i2, w2)
        az1, bz1, cz1 = (self._mat_vec(m, z1) for m in (self.A, self.B, self.C))
        az2, bz2, cz2 = (self._mat_vec(m, z2) for m in (self.A, self.B, self.C))
        return [
            (az1[i] * bz2[i] + az2[i] * bz1[i] - i1.u * cz2[i] - i2.u * cz1[i])
            % p
            for i in range(self.nc)
        ]

    def fold(self, i1, w1, i2, w2):
        """(U1, W1) x (U2, W2) -> (U, W) with Fiat-Shamir challenge."""
        T = self.cross_term(i1, w1, i2, w2)
        comm_t = self._commit(self.bases_e, T)
        return self.fold_with_comm(i1, w1, i2, w2, T, comm_t)

    def fold_challenge(self, i1, i2, comm_t) -> int:
        """rho = SHA-256("fold" || comm_T || comm_W1 || comm_W2 || comm_E1
        || comm_E2 || u1 || u2) mod r, the reference's bytes."""
        return (
            int.from_bytes(
                hashlib.sha256(
                    b"fold"
                    + self._pt_bytes(comm_t)
                    + self._pt_bytes(i1.comm_w)
                    + self._pt_bytes(i2.comm_w)
                    + self._pt_bytes(i1.comm_e)
                    + self._pt_bytes(i2.comm_e)
                    + i1.u.to_bytes(32, "big")
                    + i2.u.to_bytes(32, "big")
                ).digest(),
                "big",
            )
            % self.p
        )

    def fold_with_comm(self, i1, w1, i2, w2, T, comm_t):
        """Combine step with a precomputed cross-term commitment: lets a
        pipeline batch many cross-term MSMs while the Fiat-Shamir
        transcript stays identical to fold()."""
        p = self.p
        C = ci.BLS12_381_G1
        rho = self.fold_challenge(i1, i2, comm_t)
        r2 = rho * rho % p
        w = [(a + rho * b) % p for a, b in zip(w1.w, w2.w)]
        e = [
            (e1 + rho * t + r2 * e2) % p
            for e1, t, e2 in zip(w1.e, T, w2.e)
        ]
        x = [(a + rho * b) % p for a, b in zip(i1.x, i2.x)]
        u = (i1.u + rho * i2.u) % p
        comm_w = C.add(i1.comm_w, C.mul(rho, i2.comm_w))
        comm_e = C.add(
            i1.comm_e,
            C.add(
                C.mul(rho, comm_t),
                C.mul(r2, i2.comm_e) if i2.comm_e else None,
            ),
        )
        return RelaxedInstance(comm_w, comm_e, u, x), RelaxedWitness(w, e)
