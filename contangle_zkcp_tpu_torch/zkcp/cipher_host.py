"""CipherHost implementations (mirror of nulltea/contangle-zkcp:lib/src/cipher_host.rs)."""

from __future__ import annotations

import json
from pathlib import Path

from .verifiable_encryption import VerifiableEncryption

HOSTED_FILE = "verifiable_encryption.json"


class LocalHost:
    def __init__(self, directory):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def write(self, ve: VerifiableEncryption):
        (self.directory / HOSTED_FILE).write_text(json.dumps(ve.to_json()))

    def read(self) -> VerifiableEncryption:
        data = json.loads((self.directory / HOSTED_FILE).read_text())
        return VerifiableEncryption.from_json(data)

    def is_hosted(self) -> bool:
        return (self.directory / HOSTED_FILE).exists()


class EphemeralHost:
    def __init__(self):
        self._ve = None

    def write(self, ve: VerifiableEncryption):
        self._ve = ve

    def read(self) -> VerifiableEncryption:
        if self._ve is None:
            raise RuntimeError("nothing hosted")
        return self._ve

    def is_hosted(self) -> bool:
        return self._ve is not None
