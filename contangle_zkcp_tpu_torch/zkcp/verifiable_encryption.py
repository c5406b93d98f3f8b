"""ZkVerifiableEncryption + wire types.

Port of `contangle_zkcp_tpu/zkcp/verifiable_encryption.py`, a mirror of
nulltea/contangle-zkcp:lib/src/zk/verifiable_encryption.rs: composes
the Proof-of-Encryption with a PropertyVerifier.  The JSON schema matches
the reference's serde output (Vec<u8> as arrays of ints; ProofOfProperty
arguments as [name, bytes] pairs) so hosted ciphertexts interoperate.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from ..circuits import elgamal
from ..utils import chunks as chunk_util


@dataclass
class ProofOfProperty:
    proof: bytes
    arguments: list  # [(name, bytes)]

    def to_json(self):
        return {
            "proof": list(self.proof),
            "arguments": [[name, list(data)] for name, data in self.arguments],
        }

    @staticmethod
    def from_json(d):
        return ProofOfProperty(
            proof=bytes(d["proof"]),
            arguments=[(name, bytes(data)) for name, data in d["arguments"]],
        )


@dataclass
class VerifiableEncryption:
    ciphertext: bytes
    proof_of_encryption: bytes
    proofs_of_property: list

    def to_json(self):
        return {
            "ciphertext": list(self.ciphertext),
            "proof_of_encryption": list(self.proof_of_encryption),
            "proofs_of_property": [p.to_json() for p in self.proofs_of_property],
        }

    @staticmethod
    def from_json(d):
        return VerifiableEncryption(
            ciphertext=bytes(d["ciphertext"]),
            proof_of_encryption=bytes(d["proof_of_encryption"]),
            proofs_of_property=[
                ProofOfProperty.from_json(p) for p in d["proofs_of_property"]
            ],
        )


class ZkVerifiableEncryption:
    def __init__(
        self, build_dir, verifier, params: elgamal.ElGamalParams, backend="groth16", device="cuda"
    ):
        from .zk_encryption import ZkEncryption

        self.build_dir = Path(build_dir)
        self.encryption = ZkEncryption(build_dir, params, backend, device)
        self.verifier = verifier
        self.backend = backend

    @classmethod
    def new_verifier(cls, build_dir, verifier, params, backend="groth16", device="cuda"):
        from .zk_encryption import ZkEncryption

        self = cls.__new__(cls)
        self.build_dir = Path(build_dir)
        self.encryption = ZkEncryption.new_verifier(build_dir, params, backend, device)
        self.verifier = verifier
        self.backend = backend
        return self

    def keygen(self, rng=None):
        return self.encryption.keygen(rng)

    def assess_property_and_encrypt(self, msg: bytes, sk, pk, rng=None) -> VerifiableEncryption:
        """PoPRP(plaintext) + PoE + PoPRP(ciphertext)
        (verifiable_encryption.rs:72-111).  Uses the 1-byte-per-block
        direct chunking (bytes_to_plaintext_chunks_direct)."""
        params = self.encryption.params
        chunks = chunk_util.bytes_to_chunks_direct(msg, params.curve.p, params.n)
        proofs = list(self.verifier.assess_plaintext(chunks, rng))
        cipher_bytes, proof_bytes = self.encryption.encrypt_chunks(chunks, pk, rng)
        from .zk_encryption import ciphertext_from_bytes

        cipher = ciphertext_from_bytes(cipher_bytes, params)
        proofs += self.verifier.assess_ciphertext(cipher, sk, rng)
        return VerifiableEncryption(
            ciphertext=cipher_bytes,
            proof_of_encryption=proof_bytes,
            proofs_of_property=proofs,
        )

    def verify_proof(self, ve: VerifiableEncryption) -> bool:
        public_inputs = self.verifier.prepare_public_inputs(ve.ciphertext)
        ok_enc = self.encryption.verify_proof(ve.proof_of_encryption, ve.ciphertext)
        ok_prop = all(
            self.verifier.verify_proof(p, list(public_inputs))
            for p in ve.proofs_of_property
        )
        return ok_enc and ok_prop

    def decrypt(self, sk_bytes: bytes, ciphertext: bytes) -> bytes:
        return self.encryption.decrypt(sk_bytes, ciphertext)

    def compile(self, rng=None):
        self.encryption.compile(rng)
        self.verifier.compile(rng)
