"""Seller actor (port of `contangle_zkcp_tpu/zkcp/seller.py`, a mirror of
nulltea/contangle-zkcp:lib/src/seller.rs).

Holds the data decryption key (cached to disk for restart resilience,
seller.rs:79-80,110-115), per-buyer one-time cross-curve keys, and the
adaptor-signature context.  Runs as an asyncio actor consuming SellerMsg
from an inbox queue (the reference's mpsc+oneshot pattern).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from pathlib import Path

from ..circuits import elgamal
from ..curves import instances as ci
from ..utils import serialize as ser
from ..utils.errors import ProtocolError
from ..utils import metrics
from . import secp
from .config import ZkConfig
from .verifiable_encryption import VerifiableEncryption, ZkVerifiableEncryption
from .zk_encryption import ZkEncryption

DECRYPTION_KEY_FILE = "decryption_key"


@dataclass
class SellerConfig:
    price: float
    cache_dir: str
    zk: ZkConfig


@dataclass
class Step1Msg:
    ciphertext: bytes
    proof_of_encryption: bytes
    data_pk: tuple  # secp point
    seller_address: bytes


class Seller:
    def __init__(
        self, cfg: SellerConfig, chain, cipher_host, property_verifier, wallet, device="cuda"
    ):
        self.cfg = cfg
        self.chain = chain
        self.cipher_host = cipher_host
        self.wallet = wallet
        self.one_time_keys = {}
        self.inbox = asyncio.Queue(maxsize=16)
        cache = Path(cfg.cache_dir)
        key_file = cache / DECRYPTION_KEY_FILE
        self.decryption_key = key_file.read_bytes() if key_file.exists() else None
        self.verifiable_encryption = ZkVerifiableEncryption(
            cfg.zk.data_encryption_dir,
            property_verifier,
            elgamal.ElGamalParams(curve=ci.JUBJUB, n=cfg.zk.data_encryption_limit),
            backend=cfg.zk.backend,
            device=device,
        )
        self.key_encryption = ZkEncryption(
            cfg.zk.key_encryption_dir,
            elgamal.ElGamalParams(curve=ci.JUBJUB, n=1),
            backend=cfg.zk.backend,
            device=device,
        )

    # ------------------------------------------------------------- step 0
    @metrics.timed("seller.step0_setup")
    def step0_setup(self, data: bytes):
        """keygen, cache sk, produce + host the verifiable encryption."""
        sk, pk = self.verifiable_encryption.keygen()
        sk_bytes = ser.fp_to_bytes(sk, ci.JUBJUB.order)
        cache = Path(self.cfg.cache_dir)
        cache.mkdir(parents=True, exist_ok=True)
        (cache / DECRYPTION_KEY_FILE).write_bytes(sk_bytes)
        self.decryption_key = sk_bytes
        ve = self.verifiable_encryption.assess_property_and_encrypt(data, sk, pk)
        self.cipher_host.write(ve)

    # ------------------------------------------------------------- handlers
    def handle_step0(self) -> VerifiableEncryption:
        return self.cipher_host.read()

    def handle_step1(self, address: bytes) -> Step1Msg:
        elgamal_pk, data_sk, data_pk = self.key_encryption.keygen_derive()
        self.one_time_keys[address] = data_sk
        seller_address = self.chain.address_from_pk(self.wallet.pub_key())
        if self.decryption_key is None:
            raise ProtocolError("decryption key was expected")
        ciphertext, proof = self.key_encryption.encrypt(
            self.decryption_key, elgamal_pk
        )
        return Step1Msg(
            ciphertext=ciphertext,
            proof_of_encryption=proof,
            data_pk=data_pk,
            seller_address=seller_address,
        )

    def handle_step3(self, pub_key, enc_sig: secp.EncryptedSignature) -> bytes:
        """Verify the buyer's adaptor signature against the expected payment
        tx, decrypt it with the one-time key, broadcast — getting paid
        reveals the key (seller.rs:160-194)."""
        local_address = self.chain.address_from_pk(self.wallet.pub_key())
        address = self.chain.address_from_pk(pub_key)
        if address not in self.one_time_keys:
            raise ProtocolError("unknown address")
        decryption_key = self.one_time_keys.pop(address)
        pay_tx, tx_hash = self.chain.compose_tx(address, local_address, self.cfg.price)
        one_time_pk = secp.SECP256K1.mul(decryption_key, secp.SECP256K1.generator)
        if not secp.verify_encrypted_signature(pub_key, one_time_pk, tx_hash, enc_sig):
            raise ProtocolError("invalid adaptor signature")
        sig = secp.decrypt_signature(decryption_key, enc_sig)
        return self.chain.sent_signed(pay_tx, sig)

    # --------------------------------------------------------------- actor
    async def run(self):
        """Actor loop; messages are (kind, payload, future) tuples."""
        while True:
            kind, payload, fut = await self.inbox.get()
            try:
                if kind == "step0":
                    fut.set_result(self.handle_step0())
                elif kind == "step1":
                    fut.set_result(self.handle_step1(payload))
                elif kind == "step3":
                    fut.set_result(self.handle_step3(*payload))
                elif kind == "stop":
                    fut.set_result(None)
                    return
                else:
                    fut.set_exception(ProtocolError(f"unknown message {kind}"))
            except Exception as e:  # noqa: BLE001 - actor must not die
                if not fut.done():
                    fut.set_exception(e)

    async def call(self, kind, payload=None):
        fut = asyncio.get_event_loop().create_future()
        await self.inbox.put((kind, payload, fut))
        return await fut
