"""ZkEncryption — Groth16 lifecycle around the Proof-of-Encryption circuit.

Port of `contangle_zkcp_tpu/zkcp/zk_encryption.py`: artifact management
(`circuit.zkey` / `verification.key` in a build dir), byte-level
encrypt+prove / decrypt, the cross-curve `keygen_derive` loop, proof
verification, and `compile` (setup + artifact write).

A pluggable snark backend supports:
  * "groth16": the real prover on the card (default);
  * "mock":    satisfiability-checked stub proofs for fast protocol-layer
               tests (the reference's `cs.is_satisfied()`-as-fake-prover
               pattern, SURVEY.md §4a).
"""

from __future__ import annotations

import hashlib
import os
import random
from pathlib import Path

from ..circuits import elgamal
from ..circuits.encrypt_circuit import EncryptCircuit
from ..curves import instances as ci
from ..groth16 import Groth16, Proof
from ..groth16 import serialize as g16ser
from ..utils import chunks as chunk_util
from ..utils import serialize as ser
from ..utils.errors import ProofError, SerializationError
from . import secp

PROVING_KEY_FILE = "circuit.zkey"
VERIFYING_KEY_FILE = "verification.key"

_CURVE = "bls12_381"


class MockProof:
    """Stub proof: binds to the public inputs (NOT sound; tests only)."""

    MAGIC = b"MOCKPROOF1"

    @staticmethod
    def create(public_inputs) -> bytes:
        h = hashlib.sha256()
        for x in public_inputs:
            h.update(int(x).to_bytes(32, "little"))
        return MockProof.MAGIC + h.digest()

    @staticmethod
    def verify(data: bytes, public_inputs) -> bool:
        return data == MockProof.create(public_inputs)


class ZkEncryption:
    def __init__(
        self,
        build_dir,
        params: elgamal.ElGamalParams = None,
        backend: str = "groth16",
        device="cuda",
    ):
        self.build_dir = Path(build_dir)
        self.device = device
        self.params = params or elgamal.ElGamalParams(curve=ci.JUBJUB, n=1)
        self.backend = backend
        self.circuit = EncryptCircuit(self.params)
        self.proving_key = None
        self.verifying_key = None
        pkf = self.build_dir / PROVING_KEY_FILE
        if backend == "groth16" and pkf.exists():
            self.proving_key = g16ser.pk_from_bytes(pkf.read_bytes(), _CURVE)
            self.verifying_key = self.proving_key.vk
        self._load_vk()

    def _load_vk(self):
        vkf = self.build_dir / VERIFYING_KEY_FILE
        if self.verifying_key is None and self.backend == "groth16" and vkf.exists():
            self.verifying_key = g16ser.vk_from_bytes(vkf.read_bytes(), _CURVE)

    @classmethod
    def new_verifier(cls, build_dir, params=None, backend: str = "groth16", device="cuda"):
        self = cls(build_dir, params, backend, device)
        if backend == "groth16" and self.verifying_key is None:
            raise ProofError("verification key missing")
        return self

    # ------------------------------------------------------------ key mgmt
    def keygen(self, rng=None):
        return elgamal.keygen(self.params, rng)

    def keygen_derive(self, rng=None):
        """Loop ElGamal keygen until the Jubjub scalar's LE bytes also parse
        as a secp256k1 scalar (encryption.rs:118-133 + utils.rs:28-37)."""
        while True:
            sk, pk = self.keygen(rng)
            le = ser.fp_to_bytes(sk, self.params.curve.order)
            try:
                secp_sk, secp_pk = secp.keypair_from_bytes(le)
            except ValueError:
                continue
            return pk, secp_sk, secp_pk

    # ------------------------------------------------------- encrypt/prove
    def encrypt(self, msg: bytes, pk, rng=None) -> tuple:
        """(ciphertext_bytes, proof_bytes); 32-byte chunking as the
        reference's ZkEncryption::encrypt (bytes_to_plaintext_chunks)."""
        p = self.params.curve.p
        chunks = chunk_util.bytes_to_chunks(msg, p)
        return self.encrypt_chunks(chunks, pk, rng)

    def encrypt_chunks(self, chunks, pk, rng=None) -> tuple:
        rng = rng or random.SystemRandom()
        r = elgamal.random_scalar(self.params, rng)
        cipher = elgamal.encrypt(self.params, pk, chunks, r)
        cs = self.circuit.synthesize(pk, chunks, r, cipher)
        cipher_bytes = ciphertext_to_bytes(cipher, self.params)
        if self.backend == "mock":
            if not cs.is_satisfied():
                raise ProofError("unsatisfied encryption circuit")
            proof_bytes = MockProof.create(cs.public_inputs())
        else:
            if self.proving_key is None:
                raise ProofError("proving key expected")
            proof = Groth16(_CURVE, self.device).prove(self.proving_key, cs, rng)
            proof_bytes = g16ser.proof_to_bytes(proof, _CURVE)
        return cipher_bytes, proof_bytes

    def decrypt(self, sk_bytes: bytes, ciphertext: bytes) -> bytes:
        sk = ser.fp_from_bytes(sk_bytes, self.params.curve.order)
        cipher = ciphertext_from_bytes(ciphertext, self.params)
        chunks = elgamal.decrypt(self.params, sk, cipher)
        return chunk_util.chunks_to_bytes(chunks, self.params.curve.p)

    def verify_proof(self, proof_bytes: bytes, ciphertext: bytes) -> bool:
        cipher = ciphertext_from_bytes(ciphertext, self.params)
        inputs = elgamal.public_inputs(self.params, cipher)
        if self.backend == "mock":
            return MockProof.verify(proof_bytes, inputs)
        if self.verifying_key is None:
            raise ProofError("verifying key expected")
        try:
            proof = g16ser.proof_from_bytes(proof_bytes, _CURVE)
        except SerializationError:
            return False
        return Groth16(_CURVE, self.device).verify(self.verifying_key, inputs, proof)

    # -------------------------------------------------------------- compile
    def compile(self, rng=None):
        os.makedirs(self.build_dir, exist_ok=True)
        if self.backend == "mock":
            (self.build_dir / VERIFYING_KEY_FILE).write_bytes(b"mock")
            return None, None
        rng = rng or random.SystemRandom()
        pk_pt, msg, r, cipher = self.circuit.dummy_instance()
        cs = self.circuit.synthesize(pk_pt, msg, r, cipher)
        pk, vk = Groth16(_CURVE, self.device).setup(cs, rng)
        (self.build_dir / PROVING_KEY_FILE).write_bytes(g16ser.pk_to_bytes(pk, _CURVE))
        (self.build_dir / VERIFYING_KEY_FILE).write_bytes(g16ser.vk_to_bytes(vk, _CURVE))
        self.proving_key, self.verifying_key = pk, vk
        return pk, vk


# -------------------------------------------------- ciphertext wire format
def ciphertext_to_bytes(cipher, params: elgamal.ElGamalParams) -> bytes:
    """arkworks tuple (C, Vec<Fq>): compressed TE point + u64-len vector."""
    import struct

    c1, c2 = cipher
    parts = [ser.edwards_to_bytes(c1, params.curve), struct.pack("<Q", len(c2))]
    parts += [ser.fp_to_bytes(x, params.curve.p) for x in c2]
    return b"".join(parts)


def ciphertext_from_bytes(data: bytes, params: elgamal.ElGamalParams):
    import struct

    plen = ser.field_byte_len(params.curve.p)
    c1 = ser.edwards_from_bytes(data[:plen], params.curve)
    (n,) = struct.unpack_from("<Q", data, plen)
    off = plen + 8
    c2 = []
    for _ in range(n):
        c2.append(ser.fp_from_bytes(data[off : off + plen], params.curve.p))
        off += plen
    return (c1, c2)
