"""Buyer state machine (port of `contangle_zkcp_tpu/zkcp/buyer.py`, a mirror
of nulltea/contangle-zkcp:lib/src/buyer.rs).

step0_verify -> step2 (verify key PoE, compose payment, adaptor-sign) ->
step4 (poll chain with exponential backoff, recover the one-time key from
the broadcast signature, decrypt key then data).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from ..utils import metrics
from ..utils import serialize as ser
from ..circuits import elgamal
from ..curves import instances as ci
from ..utils.errors import ProtocolError
from . import secp
from .config import ZkConfig
from .verifiable_encryption import VerifiableEncryption, ZkVerifiableEncryption
from .zk_encryption import ZkEncryption


@dataclass
class BuyerConfig:
    zk: ZkConfig


class Buyer:
    def __init__(self, cfg: BuyerConfig, chain, property_verifier, wallet, device="cuda"):
        self.chain = chain
        self.wallet = wallet
        self.encrypted_key = None
        self.one_time_pk = None
        self.encrypted_sig = None
        self.data_encryption = ZkVerifiableEncryption.new_verifier(
            cfg.zk.data_encryption_dir,
            property_verifier,
            elgamal.ElGamalParams(curve=ci.JUBJUB, n=cfg.zk.data_encryption_limit),
            backend=cfg.zk.backend,
            device=device,
        )
        self.key_encryption = ZkEncryption.new_verifier(
            cfg.zk.key_encryption_dir,
            elgamal.ElGamalParams(curve=ci.JUBJUB, n=1),
            backend=cfg.zk.backend,
            device=device,
        )

    @metrics.timed("buyer.step0_verify")
    def step0_verify(self, ve: VerifiableEncryption) -> bool:
        return self.data_encryption.verify_proof(ve)

    @metrics.timed("buyer.step2")
    def step2(self, encrypted_key: bytes, proof: bytes, one_time_pk, addr_to: bytes, amount: float):
        """Verify the key-encryption PoE, compose the payment tx, produce
        the adaptor pre-signature under the seller's one-time pk."""
        if not self.key_encryption.verify_proof(proof, encrypted_key):
            raise ProtocolError("seller sent invalid proof of key encryption")
        self.encrypted_key = bytes(encrypted_key)
        self.one_time_pk = one_time_pk
        _, tx_hash = self.chain.compose_tx(
            self.chain.address_from_pk(self.wallet.pub_key()), addr_to, amount
        )
        enc_sig = secp.encrypted_sign(self.wallet.sec_key(), one_time_pk, tx_hash)
        self.encrypted_sig = enc_sig
        return enc_sig

    async def step4(self, tx_hash: bytes, encrypted_data: bytes, max_wait: float = 60.0) -> bytes:
        """Poll for the broadcast signature (exponential backoff), recover
        the decryption key, decrypt key then data (buyer.rs:101-128)."""
        delay = 0.1
        waited = 0.0
        sig = None
        while True:
            sig = self.chain.get_signature(tx_hash)
            if sig is not None:
                break
            if waited >= max_wait:
                raise ProtocolError("tx not found before timeout")
            await asyncio.sleep(delay)
            waited += delay
            delay = min(delay * 2, 5.0)

        recovered = secp.recover_decryption_key(
            self.one_time_pk, sig, self.encrypted_sig
        )
        if recovered is None:
            raise ProtocolError("failed to recover decryption key")
        # the secp scalar's BE bytes are the Jubjub scalar's LE bytes
        # (the keygen_derive byte-reinterpretation trick)
        sk_bytes = secp.scalar_to_bytes(recovered)
        decryption_key = self.key_encryption.decrypt(sk_bytes, self.encrypted_key)
        # the key decryption's chunks_to_bytes drops trailing zero bytes, so
        # a data key whose top byte is 0 (about one Jubjub scalar in 15)
        # comes back short: give it back its little-endian width
        decryption_key = decryption_key.ljust(ser.field_byte_len(ci.JUBJUB.order), b"\0")
        self.encrypted_key = None
        return self.data_encryption.decrypt(decryption_key, encrypted_data)
