"""Batched verification of Groth16 proofs (torch port).

Port of `contangle_zkcp_tpu/groth16/aggregate.py`: randomized batch
verification of many proofs under one verifying key in a single
multi-pairing,

  prod_i e(rho_i * A_i, B_i)
    == e(alpha, beta)^{sum rho_i} * e(sum_i rho_i * PI_i, gamma)
       * e(sum_i rho_i * C_i, delta)

with independent odd 128-bit weights rho_i, collapsing 3N pairings and N
final exponentiations into N + 2 Miller loops and ONE final
exponentiation.  Host arithmetic throughout (the port's curve context
and pairing engine), on a verifying key of host points; `device` names
the curve context.
"""

from __future__ import annotations

import secrets

from .groth16 import VerifyingKey, curve_ctx


def batch_verify(
    vk: VerifyingKey,
    statements,  # [(public_inputs, Proof)]
    curve: str = "bls12_381",
    rng=None,
    device="cuda",
) -> bool:
    ctx = curve_ctx(curve, device)
    g1, r = ctx.g1, ctx.r
    if not statements:
        return True
    rhos = [
        (rng.randrange(1 << 128) if rng else secrets.randbits(128)) | 1
        for _ in statements
    ]

    pairs = []
    acc_pi = None
    acc_c = None
    rho_sum = 0
    for (inputs, proof), rho in zip(statements, rhos):
        if len(inputs) != len(vk.gamma_abc_g1) - 1:
            return False
        pi = vk.gamma_abc_g1[0]
        for x, base in zip(inputs, vk.gamma_abc_g1[1:]):
            pi = g1.add(pi, g1.mul(x % r, base))
        acc_pi = g1.add(acc_pi, g1.mul(rho, pi))
        acc_c = g1.add(acc_c, g1.mul(rho, proof.c))
        rho_sum = (rho_sum + rho) % r
        pairs.append((g1.mul(rho, proof.a), proof.b))

    eng = ctx.pairing
    pairs.append((g1.neg(acc_pi), vk.gamma_g2))
    pairs.append((g1.neg(acc_c), vk.delta_g2))
    lhs = eng.multi_pairing(pairs)
    rhs = eng.F.pow(eng.pairing(vk.alpha_g1, vk.beta_g2), rho_sum)
    return lhs == rhs
