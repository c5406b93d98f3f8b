"""Carry Groth16 keys and folding state across from the JAX package.

`from_reference` turns the JAX package's `ProvingKey` / `VerifyingKey`
into this package's.  Host points (affine int tuples, or None) carry over
as they are; a device-resident query — an {x, y, z} dict of limb arrays —
carries over limb for limb onto `device`, since both packages share the
limb layout.  The caller passes such arrays as numpy (anything
`numpy.asarray` accepts).  With it both packages prove from one key.

`instance_from_reference`, `witness_from_reference`,
`ipa_proof_from_reference` and `decider_proof_from_reference` do the same
for the folding accumulator (`RelaxedInstance`, `RelaxedWitness`) and the
decider's proofs (`VecIpaProof`, `DeciderProof`), so that this package
decides an accumulator the JAX package folded and verifies its proofs.
All of them read the objects by attribute.
"""

from __future__ import annotations

import numpy as np

from ..fields.fp import as_tensor
from .decider import DeciderProof
from .folding import RelaxedInstance, RelaxedWitness
from .groth16 import ProvingKey, VerifyingKey
from .ipa_vec import VecIpaProof


def _points(v, device):
    """A query: an {x, y, z} dict of limb arrays, or a list of points."""
    if isinstance(v, dict):
        return {k: as_tensor(np.asarray(v[k]), device) for k in ("x", "y", "z")}
    return [_point(p) for p in v]


def _point(p):
    if p is None:
        return None
    x, y = p
    if isinstance(x, (tuple, list)):
        return (tuple(int(c) for c in x), tuple(int(c) for c in y))
    return (int(x), int(y))


def from_reference(key, device="cuda"):
    """The JAX package's ProvingKey or VerifyingKey -> this package's."""
    if hasattr(key, "a_query"):
        return ProvingKey(
            vk=from_reference(key.vk, device),
            beta_g1=_point(key.beta_g1),
            delta_g1=_point(key.delta_g1),
            a_query=_points(key.a_query, device),
            b_g1_query=_points(key.b_g1_query, device),
            b_g2_query=_points(key.b_g2_query, device),
            h_query=_points(key.h_query, device),
            l_query=_points(key.l_query, device),
            domain=int(key.domain),
        )
    return VerifyingKey(
        alpha_g1=_point(key.alpha_g1),
        beta_g2=_point(key.beta_g2),
        gamma_g2=_point(key.gamma_g2),
        delta_g2=_point(key.delta_g2),
        gamma_abc_g1=_points(key.gamma_abc_g1, device),
    )


def _ints(v):
    return [int(x) for x in v]


def instance_from_reference(inst) -> RelaxedInstance:
    """The JAX package's RelaxedInstance -> this package's."""
    return RelaxedInstance(
        comm_w=_point(inst.comm_w),
        comm_e=_point(inst.comm_e),
        u=int(inst.u),
        x=_ints(inst.x),
    )


def witness_from_reference(wit) -> RelaxedWitness:
    """The JAX package's RelaxedWitness -> this package's."""
    return RelaxedWitness(w=_ints(wit.w), e=_ints(wit.e))


def ipa_proof_from_reference(proof) -> VecIpaProof:
    """The JAX package's VecIpaProof -> this package's."""
    return VecIpaProof(
        rounds=[(_point(L), _point(R)) for L, R in proof.rounds],
        a_final=int(proof.a_final),
    )


def decider_proof_from_reference(proof) -> DeciderProof:
    """The JAX package's DeciderProof -> this package's."""
    return DeciderProof(
        outer_polys=[_ints(ev) for ev in proof.outer_polys],
        va=int(proof.va),
        vb=int(proof.vb),
        vc=int(proof.vc),
        ve=int(proof.ve),
        open_e=ipa_proof_from_reference(proof.open_e),
        inner_polys=[_ints(ev) for ev in proof.inner_polys],
        vz=int(proof.vz),
        open_w=ipa_proof_from_reference(proof.open_w),
    )
