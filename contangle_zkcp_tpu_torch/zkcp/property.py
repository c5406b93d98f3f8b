"""ZkPropertyVerifier — circom-backed Proof of Property.

Port of `contangle_zkcp_tpu/zkcp/property.py`, a mirror of
nulltea/contangle-zkcp:lib/src/zk/property.rs: an all-in-one verifiable
encryption where a circom circuit (the property) is composed with the
EncryptCircuit in a single Groth16 proof, set up, proved and verified on
the card (`device`) as `zk_encryption.py` does.  Faithfulness notes
preserved: the committed CircomWrapper does not link the circom plaintext
to the encryption witness (commented out upstream), so the composed proof
enforces the circom constraints alongside the encryption constraints
without sharing wires.

The composed public inputs are [circom publics...] ++ [c1.x, c1.y, c2...]
(circom_wrapper.rs:68-84).
"""

from __future__ import annotations

import os
import random
from pathlib import Path

from ..circomx import CircomBuilder, CircomConfig, read_r1cs
from ..circomx.dummy import compile_dummy, dummy_signal_map
from ..circomx.wrapper import CircomCircuit
from ..circuits import elgamal
from ..circuits.encrypt_circuit import EncryptCircuit
from ..curves import instances as ci
from ..groth16 import Groth16
from ..groth16 import serialize as g16ser
from ..r1cs.builder import LC, ConstraintSystem
from ..utils import chunks as chunk_util
from ..utils import metrics
from ..utils import serialize as ser
from ..utils.errors import ProofError, SerializationError
from .config import CircomParams
from .verifiable_encryption import ProofOfProperty
from .zk_encryption import (
    MockProof,
    PROVING_KEY_FILE,
    VERIFYING_KEY_FILE,
    ciphertext_from_bytes,
    ciphertext_to_bytes,
)

_CURVE = "bls12_381"


class ZkPropertyVerifier:
    """Composes a circom property circuit with the encryption circuit."""

    def __init__(
        self,
        build_dir,
        circom: CircomParams,
        n: int,
        extra_args: dict = None,
        backend: str = "groth16",
        device="cuda",
    ):
        self.build_dir = Path(build_dir)
        self.device = device
        self.params = elgamal.ElGamalParams(curve=ci.JUBJUB, n=n)
        self.circuit = EncryptCircuit(self.params)
        self.backend = backend
        self.extra_args = extra_args or {}
        self.circom_params = circom
        r1cs_path = Path(circom.r1cs_path)
        if r1cs_path.exists():
            r1 = read_r1cs(r1cs_path.read_bytes())
            signal_map = _signal_map_from_labels(r1, circom)
        else:
            # no compiled artifact: fall back to the in-repo dummy circuit
            # compiled programmatically over the SNARK field (the
            # reference's hacked-circom BLS variant)
            r1 = compile_dummy(n, prime=ci.JUBJUB.p)
            signal_map = dummy_signal_map(n)
        assert r1.prime == ci.JUBJUB.p, (
            "circom r1cs must be over the BLS12-381 scalar field for the "
            "composed proof (the reference's patched-circom requirement)"
        )
        self.cfg = CircomConfig(r1cs=r1, signal_map=signal_map, sanity_check=True)
        self.proving_key = None
        self.verifying_key = None
        pkf = self.build_dir / PROVING_KEY_FILE
        if backend == "groth16" and pkf.exists():
            self.proving_key = g16ser.pk_from_bytes(pkf.read_bytes(), _CURVE)
            self.verifying_key = self.proving_key.vk
        vkf = self.build_dir / VERIFYING_KEY_FILE
        if backend == "groth16" and self.verifying_key is None and vkf.exists():
            self.verifying_key = g16ser.vk_from_bytes(vkf.read_bytes(), _CURVE)

    # ---------------------------------------------------------- composition
    @metrics.timed("property.compose")
    def _compose(self, pk_pt, msg, r, cipher, circom_args: dict):
        """Build the composed constraint system: circom LCs first (their
        publics lead the input vector), then the encryption circuit."""
        builder = CircomBuilder(self.cfg)
        builder.push_variable(self.circom_params.plaintext_field_name, msg)
        for name, val in circom_args.items():
            builder.push_input(name, val)
        witness = builder.solve_witness()
        circom = CircomCircuit(self.cfg, witness)

        composed = ConstraintSystem(p=self.params.curve.p)
        var = circom.allocate(composed)
        circom.enforce(composed, var)
        # now replay the encryption circuit into the same system
        cs2 = self.circuit.synthesize(pk_pt, msg, r, cipher)
        with metrics.timer("property.merge"):
            _merge(composed, cs2)
        metrics.gauge("property.constraints", composed.num_constraints)
        metrics.gauge("property.variables", composed.num_variables)
        return composed, circom

    # ------------------------------------------------------- verifier iface
    def assess_property_and_encrypt(self, msg_bytes: bytes, sk, pk_pt, circom_args: dict, rng=None):
        params = self.params
        chunks = chunk_util.bytes_to_chunks_direct(msg_bytes, params.curve.p, params.n)
        rng = rng or random.SystemRandom()
        r = elgamal.random_scalar(params, rng)
        cipher = elgamal.encrypt(params, pk_pt, chunks, r)
        composed, circom = self._compose(pk_pt, chunks, r, cipher, circom_args)
        cipher_bytes = ciphertext_to_bytes(cipher, params)
        args = [
            (name, ser.fp_to_bytes(int(v), params.curve.p))
            for name, v in circom_args.items()
        ]
        if self.backend == "mock":
            if not composed.is_satisfied():
                raise ProofError("unsatisfied composed circuit")
            proof_bytes = MockProof.create(composed.public_inputs())
        else:
            if self.proving_key is None:
                raise ProofError("proving key expected")
            proof = Groth16(_CURVE, self.device).prove(self.proving_key, composed, rng)
            proof_bytes = g16ser.proof_to_bytes(proof, _CURVE)
        return cipher_bytes, ProofOfProperty(proof=proof_bytes, arguments=args)

    def verify_proof(self, pop: ProofOfProperty, ciphertext_bytes: bytes) -> bool:
        try:
            cipher = ciphertext_from_bytes(ciphertext_bytes, self.params)
        except SerializationError:
            return False  # malformed ciphertext can't satisfy any proof
        enc_inputs = elgamal.public_inputs(self.params, cipher)
        # circom public wires (dummy circuit: none) then encryption inputs
        inputs = list(enc_inputs)
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
        pk_pt, msg, r, cipher = self.circuit.dummy_instance()
        msg = [1] + [0] * (self.params.n - 1)
        cipher = elgamal.encrypt(self.params, pk_pt, msg, r)
        args = {
            name: 1
            for name in self.cfg.signal_map
            if name != self.circom_params.plaintext_field_name
        }
        # satisfy dummy semantics: something = plaintext[0], challenge = s^2
        if "something" in args:
            args["something"] = msg[0]
            args["challenge"] = msg[0] * msg[0] % self.params.curve.p
        composed, _ = self._compose(pk_pt, msg, r, cipher, args)
        pk, vk = Groth16(_CURVE, self.device).setup(composed, rng)
        (self.build_dir / PROVING_KEY_FILE).write_bytes(g16ser.pk_to_bytes(pk, _CURVE))
        (self.build_dir / VERIFYING_KEY_FILE).write_bytes(g16ser.vk_to_bytes(vk, _CURVE))
        self.proving_key, self.verifying_key = pk, vk
        return pk, vk


def _merge(dst, src):
    """Append src's variables/constraints into dst (after dst's)."""
    inst_off = len(dst.instance_values)
    wit_off = len(dst.witness_values)
    dst.instance_values.extend(src.instance_values)
    dst.witness_values.extend(src.witness_values)

    def remap(lc):
        out = {}
        for v, c in lc.terms.items():
            if v == 0:
                nv = 0
            elif v > 0:
                nv = v + inst_off
            else:
                nv = v - wit_off
            out[nv] = c
        return LC(dst.p, out)

    for a, b, c in src.constraints:
        dst.constraints.append((remap(a), remap(b), remap(c)))


def _signal_map_from_labels(r1, circom: CircomParams):
    """Best-effort signal map for external r1cs files: wire order is
    [1, publics..., privates...]; without a .sym file we expose the
    plaintext as the trailing wire range and named args must be mapped by
    the caller."""
    raise ProofError(
        "external circom artifacts need a .sym signal map — provide one or "
        "use the built-in dummy circuit"
    )
