"""ZkSampleEntries — the PropertyVerifier over the SampleEntries circuit.

Port of `contangle_zkcp_tpu/zkcp/sample_entries.py`, a mirror of
nulltea/contangle-zkcp:lib/src/zk/sample_entries.rs: plaintext
assessment is a no-op; ciphertext assessment pads c2 to n, proves the
single hard-coded sample idx=1, and emits the decrypted sample as a named
argument; verification rebuilds the Merkle root from the ciphertext and
checks with public inputs [sample_value, root].
"""

from __future__ import annotations

import os
import random
from pathlib import Path

from ..circuits import elgamal
from ..circuits.sample_entries_circuit import SampleEntriesCircuit
from ..curves import instances as ci
from ..groth16 import Groth16
from ..groth16 import serialize as g16ser
from ..ops.merkle import build_tree_host
from ..utils import serialize as ser
from ..utils.errors import ProofError, SerializationError
from .verifiable_encryption import ProofOfProperty
from .zk_encryption import (
    MockProof,
    PROVING_KEY_FILE,
    VERIFYING_KEY_FILE,
    ciphertext_from_bytes,
)

_CURVE = "bls12_381"
SAMPLE_IDX = 1  # hard-coded in the reference (sample_entries.rs:80)


class ZkSampleEntries:
    def __init__(self, build_dir, n: int, backend: str = "groth16", device="cuda"):
        assert n & (n - 1) == 0, "n must be a power of two"
        self.build_dir = Path(build_dir)
        self.device = device
        self.params = elgamal.ElGamalParams(curve=ci.JUBJUB, n=n)
        self.circuit = SampleEntriesCircuit(self.params)
        self.backend = backend
        self.proving_key = None
        self.verifying_key = None
        pkf = self.build_dir / PROVING_KEY_FILE
        if backend == "groth16" and pkf.exists():
            self.proving_key = g16ser.pk_from_bytes(pkf.read_bytes(), _CURVE)
            self.verifying_key = self.proving_key.vk
        vkf = self.build_dir / VERIFYING_KEY_FILE
        if backend == "groth16" and self.verifying_key is None and vkf.exists():
            self.verifying_key = g16ser.vk_from_bytes(vkf.read_bytes(), _CURVE)

    @classmethod
    def new_verifier(cls, build_dir, n: int, backend: str = "groth16", device="cuda"):
        self = cls(build_dir, n, backend, device)
        if backend == "groth16" and self.verifying_key is None:
            raise ProofError("verification key missing")
        return self

    # ------------------------------------------------- PropertyVerifier API
    def assess_plaintext(self, plaintext, rng=None):
        return []

    def assess_ciphertext(self, ciphertext, sk: int, rng=None):
        c1, c2 = ciphertext
        assert len(c2) <= self.params.n
        c2 = list(c2) + [0] * (self.params.n - len(c2))
        cs = self.circuit.synthesize((c1, c2), sk, SAMPLE_IDX)
        sample_value = cs.public_inputs()[0]
        sample_bytes = ser.fp_to_bytes(sample_value, self.params.curve.p)
        if self.backend == "mock":
            if not cs.is_satisfied():
                raise ProofError("unsatisfied sample circuit")
            proof_bytes = MockProof.create(cs.public_inputs())
        else:
            if self.proving_key is None:
                raise ProofError("proving key expected")
            rng = rng or random.SystemRandom()
            proof = Groth16(_CURVE, self.device).prove(self.proving_key, cs, rng)
            proof_bytes = g16ser.proof_to_bytes(proof, _CURVE)
        return [
            ProofOfProperty(
                proof=proof_bytes,
                arguments=[("sample_value", sample_bytes)],
            )
        ]

    def prepare_public_inputs(self, ciphertext_bytes: bytes):
        """Rebuild the Merkle root from the hosted ciphertext — the
        verifier-side n-Poseidon hot loop (SURVEY.md §3.3).  Large trees
        hash level-by-level as batched device calls."""
        cipher = ciphertext_from_bytes(ciphertext_bytes, self.params)
        c2 = list(cipher[1])
        if len(c2) >= 512:
            from ..fields import instances as fi
            from ..ops.merkle import build_tree_device
            from ..ops.poseidon import PoseidonDevice

            F = fi.bls12_381_fr()
            tree = build_tree_device(F, PoseidonDevice(F), c2, self.device)
        else:
            tree = build_tree_host(self.params.poseidon, c2)
        return [tree.root]

    def verify_proof(self, pop: ProofOfProperty, public_inputs) -> bool:
        sample_values = [
            ser.fp_from_bytes(arg, self.params.curve.p) for _, arg in pop.arguments
        ]
        inputs = sample_values + list(public_inputs)
        if self.backend == "mock":
            return MockProof.verify(pop.proof, inputs)
        if self.verifying_key is None:
            raise ProofError("verifying key expected")
        try:
            proof = g16ser.proof_from_bytes(pop.proof, _CURVE)
        except SerializationError:
            return False
        return Groth16(_CURVE, self.device).verify(self.verifying_key, inputs, proof)

    def compile(self, rng=None):
        os.makedirs(self.build_dir, exist_ok=True)
        if self.backend == "mock":
            (self.build_dir / VERIFYING_KEY_FILE).write_bytes(b"mock")
            return None, None
        rng = rng or random.SystemRandom()
        ciphertext, sk, idx = self.circuit.dummy_instance()
        cs = self.circuit.synthesize(ciphertext, sk, idx)
        pk, vk = Groth16(_CURVE, self.device).setup(cs, rng)
        (self.build_dir / PROVING_KEY_FILE).write_bytes(g16ser.pk_to_bytes(pk, _CURVE))
        (self.build_dir / VERIFYING_KEY_FILE).write_bytes(g16ser.vk_to_bytes(vk, _CURVE))
        self.proving_key, self.verifying_key = pk, vk
        return pk, vk
