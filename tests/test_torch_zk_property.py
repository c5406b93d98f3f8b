"""The port's Proof of Property with real Groth16 on the CPU (the kernels'
plain twins), at n = 4 blocks: compile, prove a true property, verify;
a flipped ciphertext byte is rejected, a false property is refused before
any proof is made, and the JAX package's ZkPropertyVerifier, reading the
port's key files from the same build_dir, accepts the port's
ProofOfProperty (on its host pairing: nothing is compiled).

Setup and prove run every kernel's twin on the CPU: minutes, so the test
sits in a file of its own, after tests/test_torch_poe.py.
"""

import random

import pytest

from contangle_zkcp_tpu.zkcp.config import CircomParams as JCircomParams
from contangle_zkcp_tpu.zkcp.property import ZkPropertyVerifier as JZkPropertyVerifier
from contangle_zkcp_tpu.zkcp.verifiable_encryption import ProofOfProperty as JProofOfProperty
from contangle_zkcp_tpu_torch.circuits import elgamal
from contangle_zkcp_tpu_torch.utils import serialize as ser
from contangle_zkcp_tpu_torch.utils.errors import ProofError
from contangle_zkcp_tpu_torch.zkcp import CircomParams, ZkEncryption, ZkPropertyVerifier
from tests.torch_port_util import one_torch_thread  # noqa: F401


def test_property_groth16_round_trip(tmp_path):
    n = 4
    build = tmp_path / "build"
    missing = str(tmp_path / "no_such.r1cs")
    pv = ZkPropertyVerifier(build, CircomParams(r1cs_path=missing), n, device="cpu")
    pv.compile(random.Random(1))
    sk, pk = elgamal.keygen(pv.params, random.Random(2))
    msg = bytes([5, 1, 2, 9])
    cipher, pop = pv.assess_property_and_encrypt(
        msg, sk, pk, {"something": 5, "challenge": 25}, random.Random(3))
    assert pv.verify_proof(pop, cipher)
    bad = cipher[:-1] + bytes([cipher[-1] ^ 1])
    assert not pv.verify_proof(pop, bad)
    with pytest.raises(ProofError):
        pv.assess_property_and_encrypt(msg, sk, pk, {"something": 5, "challenge": 26}, random.Random(3))
    plain = ZkEncryption(tmp_path / "none", params=pv.params, device="cpu").decrypt(
        ser.fp_to_bytes(sk, pv.params.curve.order), cipher)
    assert plain == msg

    # the JAX package's verifier on the same build_dir, the proof as JSON
    theirs = JZkPropertyVerifier(build, JCircomParams(r1cs_path=missing), n)
    j_pop = JProofOfProperty.from_json(pop.to_json())
    assert theirs.verify_proof(j_pop, cipher)
    assert not theirs.verify_proof(j_pop, bad)
