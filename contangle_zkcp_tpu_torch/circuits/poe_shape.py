"""A Proof-of-Encryption-shaped R1CS structure for the folding scheme.

`mini_poe_cs(n, seed)` builds the structure the JAX package's folding
tests fold (`tests/test_folding.py _mini_poe_cs`), constraint for
constraint and variable for variable: n per-block ElGamal equations
c2_i = dh + m_i (c2_i public, m_i and dh witnesses) and one cube chain
on dh, so that the structure has nonlinear rows.  It leaves out the
EncryptCircuit's in-circuit scalar multiplications (about 6,000
constraints at any n).  Sizes: n + 3 constraints, 2n + 5 variables, of
which n + 1 instance (the constant slot included).
"""

from __future__ import annotations

import random

from ..curves import instances as ci
from ..r1cs.builder import ConstraintSystem
from ..r1cs.gadgets import Gadgets
from . import elgamal


def mini_poe_cs(n: int, seed: int) -> ConstraintSystem:
    """The satisfied structure for one seed (key, randomness, message)."""
    rng = random.Random(seed)
    params = elgamal.ElGamalParams(curve=ci.JUBJUB, n=n)
    sk, pk = elgamal.keygen(params, rng)
    r = elgamal.random_scalar(params, rng)
    msg = [rng.randrange(256) for _ in range(n)]
    c1, c2 = elgamal.encrypt(params, pk, msg, r)
    dh = elgamal.shared_digest(params, params.curve.mul(r, pk))
    cs = ConstraintSystem(p=params.curve.p)
    g = Gadgets(cs)
    dh_var = g.witness(dh)
    for i in range(n):
        m = g.witness(msg[i])
        c2v = g.input(c2[i])
        g.enforce_equal(dh_var + m, c2v)
    sq = g.mul(dh_var, dh_var)
    g.enforce_equal(g.mul(sq, dh_var), g.witness(pow(dh, 3, cs.p)))
    assert cs.is_satisfied()
    return cs
