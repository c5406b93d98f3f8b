"""The slice as a whole: Groth16 over BLS12-381 on the port (torch, CPU)
against the JAX package.

  * the toy circuit of tests/test_groth16.py with seed 20260819 gives pk,
    vk and proof bytes whose sha256 equal the JAX package's pinned golden
    (tests/conformance/groth16_golden_bls12_381.json);
  * a proving key made by the JAX package's host setup, carried over by
    groth16/convert.py from_reference, proves to the same bytes;
  * each side's verifier accepts the other's proof (the JAX verifier runs
    on its host pairing: nothing is compiled);
  * ElGamalDevice's block encryption matches the JAX package's limbs.

The Proof of Encryption end to end is in tests/test_torch_poe.py.
"""

import copy
import functools
import hashlib
import json
import pathlib
import random

import jax.numpy as jnp
import numpy as np
import pytest

from contangle_zkcp_tpu.circuits import elgamal as j_elgamal
from contangle_zkcp_tpu.curves import instances as jci
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu.groth16 import Groth16 as JGroth16
from contangle_zkcp_tpu.groth16 import serialize as jser
from contangle_zkcp_tpu_torch.circuits import elgamal
from contangle_zkcp_tpu_torch.curves import instances as ci
from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.groth16 import Groth16
from contangle_zkcp_tpu_torch.groth16 import serialize as tser
from contangle_zkcp_tpu_torch.groth16.convert import from_reference
from contangle_zkcp_tpu_torch.r1cs.builder import ConstraintSystem
from contangle_zkcp_tpu_torch.r1cs.gadgets import Gadgets
from tests.test_groth16 import toy_circuit as jax_toy_circuit
from tests.torch_port_util import one_torch_thread, rand_ints  # noqa: F401

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "conformance" / "groth16_golden_bls12_381.json").read_text()
)
SEED = 20260819


def toy_circuit(p, x=3, y=5, bump=0):
    """tests/test_groth16.py toy_circuit, built with the port's builder."""
    cs = ConstraintSystem(p=p)
    g = Gadgets(cs)
    xv = g.witness(x)
    yv = g.witness(y)
    prod = g.mul(xv, yv)
    zin = g.input((x * y + bump) % p)
    win = g.input((x + y) % p)
    g.enforce_equal(prod, zin)
    g.enforce_equal(xv + yv, win)
    cube = g.mul(prod, xv)
    b = g.alloc_bit(1)
    g.enforce_equal(g.mul(cube, b), cube)
    return cs


def sha(b):
    return hashlib.sha256(b).hexdigest()


@functools.lru_cache(maxsize=None)
def port_golden():
    eng = Groth16("bls12_381", device="cpu")
    rng = random.Random(SEED)
    cs = toy_circuit(eng.ctx.r)
    pk, vk = eng.setup(cs, rng)
    proof = eng.prove(pk, cs, rng)
    return eng, cs, pk, vk, proof


def test_toy_circuit_is_the_reference_circuit():
    p = ci.JUBJUB.p
    assert toy_circuit(p).matrices_coo() == jax_toy_circuit(p).matrices_coo()
    assert toy_circuit(p).full_assignment() == jax_toy_circuit(p).full_assignment()


@pytest.mark.parametrize("blob", ["pk", "vk", "proof"])
def test_golden_bytes(blob):
    _, _, pk, vk, proof = port_golden()
    data = {
        "pk": tser.pk_to_bytes(pk),
        "vk": tser.vk_to_bytes(vk),
        "proof": tser.proof_to_bytes(proof),
    }[blob]
    assert len(data) == GOLDEN[blob]["len"]
    assert sha(data) == GOLDEN[blob]["sha256"]


@functools.lru_cache(maxsize=None)
def reference_setup():
    """The JAX package's host setup of the toy circuit, and the rng state
    after it (the prover draws r, s from there)."""
    jeng = JGroth16("bls12_381")
    rng = random.Random(SEED)
    jpk, jvk = jeng.setup(jax_toy_circuit(jeng.ctx.r), rng, engine="host")
    return jeng, jpk, jvk, rng.getstate()


@pytest.mark.parametrize("device_queries", [False, True], ids=["host_queries", "limb_queries"])
def test_reference_key_gives_golden_proof(device_queries):
    """JAX host setup -> from_reference -> port prove == pinned proof."""
    jeng, jpk, _, state = reference_setup()
    jpk = copy.copy(jpk)
    rng = random.Random()
    rng.setstate(state)
    if device_queries:
        # device-resident queries as the JAX package holds them: {x,y,z}
        # limb arrays, handed over as numpy
        for name in ("a_query", "b_g1_query", "h_query", "l_query"):
            enc = jeng.ctx.g1_dev.encode_points(getattr(jpk, name))
            setattr(jpk, name, {k: np.asarray(v) for k, v in enc.items()})
        enc = jeng.ctx.g2_dev.encode_points(jpk.b_g2_query)
        jpk.b_g2_query = {k: np.asarray(v) for k, v in enc.items()}
    pk = from_reference(jpk, device="cpu")
    proof = Groth16("bls12_381", device="cpu").prove(pk, toy_circuit(jeng.ctx.r), rng)
    assert sha(tser.proof_to_bytes(proof)) == GOLDEN["proof"]["sha256"]


def test_cross_verification():
    eng, cs, pk, vk, proof = port_golden()
    inputs = cs.public_inputs()
    proof_bytes = tser.proof_to_bytes(proof)
    jeng = JGroth16("bls12_381")
    jvk = jser.vk_from_bytes(tser.vk_to_bytes(vk))
    # the JAX verifier accepts the port's proof, and rejects a bad input
    assert jeng.verify(jvk, inputs, jser.proof_from_bytes(proof_bytes))
    bad = [(inputs[0] + 1) % eng.ctx.r] + inputs[1:]
    assert not jeng.verify(jvk, bad, jser.proof_from_bytes(proof_bytes))
    # the port's verifier accepts the JAX package's proof bytes (the pinned
    # golden: same sha256 as these) under the JAX package's key
    tvk = from_reference(jvk, device="cpu")
    assert eng.verify(tvk, inputs, tser.proof_from_bytes(proof_bytes))
    assert not eng.verify(tvk, bad, tser.proof_from_bytes(proof_bytes))


def test_elgamal_blocks_match_jax():
    """ElGamalDevice.encrypt_blocks / decrypt_blocks: c2 = m + dh limbwise."""
    jF, tF = jfi.bls12_381_fr(), tfi.bls12_381_fr()
    params = elgamal.ElGamalParams(curve=ci.JUBJUB, n=8)
    jdev = j_elgamal.ElGamalDevice(jF, j_elgamal.ElGamalParams(curve=jci.JUBJUB, n=8))
    tdev = elgamal.ElGamalDevice(tF, params)
    msgs = rand_ints(jF.p, 5, seed=11)
    dh = rand_ints(jF.p, 1, seed=12)[-1]
    want = np.asarray(jdev.encrypt_blocks(dh, jnp.asarray(jF.encode(msgs))))
    got = tdev.encrypt_blocks(dh, tF.encode(msgs, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tF.decode(tdev.decrypt_blocks(dh, got)) == msgs


def test_input_sum_of_a_host_key_runs_as_msm():
    """A verifying key read from disk holds host points; from
    DEVICE_INPUT_SUM_MIN inputs its input sum is a device MSM, equal to
    the reference's host loop of scalar multiplications."""
    from contangle_zkcp_tpu_torch.groth16 import groth16 as tg
    from contangle_zkcp_tpu_torch.groth16.groth16 import VerifyingKey

    C = ci.BLS12_381_G1
    n = tg.DEVICE_INPUT_SUM_MIN + 3
    rng = random.Random(97)
    step = C.mul(rng.randrange(1, 1 << 40), C.generator)
    pts, acc = [], None
    for _ in range(n + 1):
        acc = C.add(acc, step)
        pts.append(acc)
    xs = [rng.randrange(2) for _ in range(n)]
    for i in range(0, n, 37):
        xs[i] = rng.randrange(tfi.BLS12_381_R)
    vk = VerifyingKey(alpha_g1=None, beta_g2=None, gamma_g2=None, delta_g2=None, gamma_abc_g1=pts)
    want = pts[0]
    for x, P in zip(xs, pts[1:]):
        want = C.add(want, C.mul(x, P))
    eng = Groth16("bls12_381", device="cpu")
    assert eng.input_sum(vk, xs) == want
    small = VerifyingKey(None, None, None, None, pts[:4])
    assert eng.input_sum(small, xs[:3]) == C.add(C.add(C.add(pts[0], C.mul(xs[0], pts[1])), C.mul(xs[1], pts[2])), C.mul(xs[2], pts[3]))

