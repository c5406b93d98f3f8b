"""The port's PLONKish prover against the JAX package's, at the reference
tests' n = 128 and seed (tests/test_plonk_prover.py): the same key and,
for one blinding seed, the same proof field for field; each package's
verifier accepts the other's proof and refuses a tampered instance.

One test in this file, so that the suite's scheduler (pytest-xdist
--dist loadfile, files with more tests first) starts it after every
other file: it takes minutes on XLA:CPU.
"""

import random

from contangle_zkcp_tpu.plonkish import prover as jprover
from contangle_zkcp_tpu_torch.fields import instances as fi
from contangle_zkcp_tpu_torch.plonkish import convert
from contangle_zkcp_tpu_torch.plonkish.prover import PlonkSystem
from tests.test_torch_plonkish import JAX_MODS, PORT_MODS, elgamal
from tests.torch_port_util import one_torch_thread  # noqa: F401

CLASSES = {name: getattr(jprover, name) for name in ("PlonkProof", "PlonkPK", "PlonkVK", "IpaProof")}


def test_proof_equals_reference_and_verifies_across():
    meta, asg, inst = elgamal(PORT_MODS, 201)
    jmeta, jasg, jinst = elgamal(JAX_MODS, 201)
    ours = PlonkSystem(meta, 128, asg, device="cpu")
    theirs = jprover.PlonkSystem(jmeta, 128, jasg)
    assert convert.fields(ours.pk) == convert.fields(theirs.pk)
    proof = ours.prove(asg, inst, rng=random.Random(5))
    jproof = theirs.prove(jasg, jinst, rng=random.Random(5))
    assert convert.fields(proof) == convert.fields(jproof)
    bad = [[inst[0][0], inst[0][1], (inst[0][2] + 1) % fi.PASTA_P]]
    as_theirs = convert.to_reference(proof, CLASSES)
    as_ours = convert.from_reference(jproof)
    assert theirs.verify(as_theirs, jinst) and not theirs.verify(as_theirs, bad)
    assert ours.verify(as_ours, inst) and not ours.verify(as_ours, bad)
    assert convert.fields(convert.from_reference(theirs.pk)) == convert.fields(ours.pk)
