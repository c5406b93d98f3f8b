"""Buyer-side HTTP client (mirror of nulltea/contangle-zkcp:server/src/client.rs),
implementing the CipherDownloader role (download == GET /step0)."""

from __future__ import annotations

import json
import urllib.request

from ..utils.errors import ProtocolError
from . import secp
from .seller import Step1Msg
from .verifiable_encryption import VerifiableEncryption


class SellerClient:
    def __init__(self, base_url: str):
        self.base = base_url.rstrip("/")

    def _get(self, path: str):
        with urllib.request.urlopen(f"{self.base}/{path}", timeout=600) as r:
            return r.read()

    def price(self) -> float:
        return json.loads(self._get("info"))["price"]

    def download(self) -> VerifiableEncryption:
        return VerifiableEncryption.from_json(json.loads(self._get("step0")))

    def step1(self, address: bytes) -> Step1Msg:
        d = json.loads(self._get(f"step1/{address.hex()}"))
        return Step1Msg(
            ciphertext=bytes(d["ciphertext"]),
            proof_of_encryption=bytes(d["proof_of_encryption"]),
            data_pk=secp.point_from_bytes(bytes.fromhex(d["data_pk"])),
            seller_address=bytes.fromhex(d["address"]),
        )

    def step3(self, pub_key, enc_sig: secp.EncryptedSignature) -> bytes:
        body = json.dumps(
            {"pub_key": secp.point_to_bytes(pub_key).hex(), "enc_sig": enc_sig.to_hex()}
        ).encode()
        req = urllib.request.Request(
            f"{self.base}/step3", data=body, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return bytes.fromhex(r.read().decode())
        except urllib.error.HTTPError as e:
            raise ProtocolError(f"step3 failed: {e.read().decode()}") from e
