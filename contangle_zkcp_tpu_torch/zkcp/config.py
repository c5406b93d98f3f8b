"""ZkConfig — the circuit-compatibility contract shared via zk-config.json
(mirror of nulltea/contangle-zkcp:lib/src/config.rs)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

PROVING_KEY_FILE = "circuit.zkey"
VERIFYING_KEY_FILE = "verification.key"
ZK_CONFIG_FILE = "zk-config.json"


@dataclass
class CircomParams:
    plaintext_field_name: str = "plaintext"
    wasm_path: str = "./circom/build/dummy_js/dummy.wasm"
    r1cs_path: str = "./circom/build/dummy.r1cs"

    def to_json(self):
        return {
            "plaintext_field_name": self.plaintext_field_name,
            "wasm_path": self.wasm_path,
            "r1cs_path": self.r1cs_path,
        }

    @staticmethod
    def from_json(d):
        return CircomParams(
            d["plaintext_field_name"], d["wasm_path"], d["r1cs_path"]
        )


@dataclass
class ZkConfig:
    prop_verifier_dir: str
    data_encryption_dir: str
    data_encryption_limit: int
    key_encryption_dir: str
    circom_params: CircomParams = field(default_factory=CircomParams)
    backend: str = "groth16"  # ours: snark backend selector

    def to_json(self):
        return {
            "prop_verifier_dir": self.prop_verifier_dir,
            "data_encryption_dir": self.data_encryption_dir,
            "data_encryption_limit": self.data_encryption_limit,
            "key_encryption_dir": self.key_encryption_dir,
            "circom_params": self.circom_params.to_json(),
            "backend": self.backend,
        }

    @staticmethod
    def from_json(d):
        return ZkConfig(
            prop_verifier_dir=d["prop_verifier_dir"],
            data_encryption_dir=d["data_encryption_dir"],
            data_encryption_limit=d["data_encryption_limit"],
            key_encryption_dir=d["key_encryption_dir"],
            circom_params=CircomParams.from_json(d["circom_params"]),
            backend=d.get("backend", "groth16"),
        )

    def save(self, path):
        Path(path).write_text(json.dumps(self.to_json(), indent=2))

    @staticmethod
    def load(path) -> "ZkConfig":
        return ZkConfig.from_json(json.loads(Path(path).read_text()))
