"""ElGamal verify-encryption circuit, PLONKish form (halo2 pipeline).

Port of `contangle_zkcp_tpu/plonkish/elgamal_circuit.py` (host code,
copied as is).

Mirror of the reference's `ElGamalGadget` over the Pallas curve
(circuits-halo2/src/encryption.rs:164-296), preserving its
semantics — including the documented soundness shortcut (SURVEY.md §7):
`s = r*pk` and `c1 = r*G` are *witnessed as precomputed points* (only
curve membership is enforced, not the scalar multiplications,
encryption.rs:221-230).  The circuit proves:

    on-curve(s); on-curve(c1); dh = Poseidon_pow5(s.x, s.y);
    c2 = dh + m;  instance = (c1.x, c1.y, c2)   [one instance column]

Layout: one Poseidon round per row (degree-5 round gate with Rotation(1)
state transition), plus dedicated rows for the two curve checks and the
reference's one-row AddChip gate (add_chip.rs:9-81).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..curves import instances as ci
from ..fields import instances as fi
from .circuit import Assignment, CircuitMeta, Expr
from .poseidon_pow5 import ALPHA, R_F, R_P, T, PoseidonPow5Host

N_ROUNDS = R_F + R_P


# ------------------------------------------------------------ native scheme
@dataclass
class ElGamalPallas:
    """Native ElGamal over Pallas with the Pow5 Poseidon KDF."""

    def __post_init__(self):
        self.curve = ci.PALLAS
        self.poseidon = PoseidonPow5Host(fi.PASTA_P)

    def keygen(self, rng=None):
        sk = (rng.randrange(1, self.curve.order) if rng
              else secrets.randbelow(self.curve.order - 1) + 1)
        return sk, self.curve.mul(sk, self.curve.generator)

    def encrypt(self, pk, m: int, r: int):
        c1 = self.curve.mul(r, self.curve.generator)
        s = self.curve.mul(r, pk)
        dh = self.poseidon.hash2(s[0], s[1])
        return (c1, (m + dh) % self.curve.p), s

    def decrypt(self, sk, cipher):
        c1, c2 = cipher
        s = self.curve.mul(sk, c1)
        dh = self.poseidon.hash2(s[0], s[1])
        return (c2 - dh) % self.curve.p


# ---------------------------------------------------------------- circuit
class ElGamalCircuit:
    """configure() builds the gates; synthesize() fills the tables."""

    def __init__(self, s_point, c1_point, m: int, c2: int):
        self.s = s_point
        self.c1 = c1_point
        self.m = m
        self.c2 = c2
        self.pos = PoseidonPow5Host(fi.PASTA_P)

    # -------------------------------------------------------------- meta
    @staticmethod
    def configure(meta: CircuitMeta):
        cols = {
            "s0": meta.advice_column(),
            "s1": meta.advice_column(),
            "s2": meta.advice_column(),
            "rc0": meta.fixed_column(),
            "rc1": meta.fixed_column(),
            "rc2": meta.fixed_column(),
            "q_full": meta.selector(),
            "q_partial": meta.selector(),
            "q_curve": meta.selector(),
            "q_add": meta.selector(),
            "instance": meta.instance_column(),
        }
        pos = PoseidonPow5Host(fi.PASTA_P)
        s = [Expr.col(cols[f"s{i}"]) for i in range(T)]
        s_next = [Expr.col(cols[f"s{i}"].at(1)) for i in range(T)]
        rc = [Expr.col(cols[f"rc{i}"]) for i in range(T)]

        def pow5(e):
            e2 = e * e
            return e2 * e2 * e

        # full round: next_i = sum_j MDS[i][j] * (s_j + rc_j)^5
        qf = Expr.col(cols["q_full"])
        full_polys = []
        for i in range(T):
            acc = Expr.const(0)
            for j in range(T):
                acc = acc + Expr.const(pos.mds[i][j]) * pow5(s[j] + rc[j])
            full_polys.append(qf * (s_next[i] - acc))
        meta.create_gate("poseidon_full", full_polys)

        # partial round: only lane 0 is powered
        qp = Expr.col(cols["q_partial"])
        part_polys = []
        for i in range(T):
            acc = Expr.const(0)
            for j in range(T):
                term = s[j] + rc[j]
                acc = acc + Expr.const(pos.mds[i][j]) * (
                    pow5(term) if j == 0 else term
                )
            part_polys.append(qp * (s_next[i] - acc))
        meta.create_gate("poseidon_partial", part_polys)

        # curve membership: y^2 = x^3 + 5 on (s0, s1)
        qc = Expr.col(cols["q_curve"])
        x, y = s[0], s[1]
        meta.create_gate(
            "pallas_on_curve", [qc * (y * y - (x * x * x + Expr.const(5)))]
        )

        # AddChip (add_chip.rs): c = a + b on one row: s0 + s1 - s2 = 0
        qa = Expr.col(cols["q_add"])
        meta.create_gate("add", [qa * (s[0] + s[1] - s[2])])
        return cols

    # --------------------------------------------------------- assignment
    def synthesize(self, meta: CircuitMeta, asg: Assignment):
        cols = self.cols
        pos = self.pos
        p = meta.p
        half = R_F // 2

        # rows 0..N_ROUNDS: the permutation trace over [s.x, s.y, cap]
        cap = (2 << 64) % p
        state = [self.s[0] % p, self.s[1] % p, cap]
        for r in range(N_ROUNDS):
            for i in range(T):
                asg.assign(cols[f"s{i}"], r, state[i])
                asg.assign(cols[f"rc{i}"], r, pos.rc[r][i])
            full = r < half or r >= half + R_P
            asg.enable(cols["q_full" if full else "q_partial"], r)
            # compute next state
            st = [(state[i] + pos.rc[r][i]) % p for i in range(T)]
            if full:
                st = [pow(x, ALPHA, p) for x in st]
            else:
                st[0] = pow(st[0], ALPHA, p)
            state = [
                sum(pos.mds[i][j] * st[j] for j in range(T)) % p for i in range(T)
            ]
        for i in range(T):
            asg.assign(cols[f"s{i}"], N_ROUNDS, state[i])
        dh = state[0]

        # curve-membership rows for s and c1
        row_s = N_ROUNDS + 1
        asg.assign(cols["s0"], row_s, self.s[0])
        asg.assign(cols["s1"], row_s, self.s[1])
        asg.enable(cols["q_curve"], row_s)
        # the hashed point must BE the witnessed point (copy constraints)
        asg.copy(cols["s0"], row_s, cols["s0"], 0)
        asg.copy(cols["s1"], row_s, cols["s1"], 0)

        row_c1 = N_ROUNDS + 2
        asg.assign(cols["s0"], row_c1, self.c1[0])
        asg.assign(cols["s1"], row_c1, self.c1[1])
        asg.enable(cols["q_curve"], row_c1)

        # add row: dh + m = c2
        row_add = N_ROUNDS + 3
        asg.assign(cols["s0"], row_add, dh)
        asg.assign(cols["s1"], row_add, self.m)
        asg.assign(cols["s2"], row_add, (dh + self.m) % p)
        asg.enable(cols["q_add"], row_add)
        asg.copy(cols["s0"], row_add, cols["s0"], N_ROUNDS)  # dh from sponge

        # instance exposure: [c1.x, c1.y, c2]
        asg.constrain_instance(cols["s0"], row_c1, cols["instance"], 0)
        asg.constrain_instance(cols["s1"], row_c1, cols["instance"], 1)
        asg.constrain_instance(cols["s2"], row_add, cols["instance"], 2)

    @staticmethod
    def build(meta: CircuitMeta, s, c1, m, c2):
        circ = ElGamalCircuit(s, c1, m, c2)
        circ.cols = ElGamalCircuit.configure(meta)
        return circ

    @staticmethod
    def min_rows() -> int:
        return N_ROUNDS + 4
