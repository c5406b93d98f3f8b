"""Ethereum chain provider (legacy EIP-155 value transfers).

Mirror of the reference's `Ethereum` ChainProvider
(nulltea/contangle-zkcp:lib/src/ethereum.rs:12-122): compose an EIP-155 value
transfer and its sighash, broadcast a raw signed tx deriving the recovery
id by trial verification (the reference's `sent_signed` trick, :58-62),
extract (r, s) from an on-chain tx, and keccak-derive addresses.

Includes `MockChain`, an in-memory ChainProvider with the same interface
for tests and local end-to-end runs (the reference has no mock; its tests
never reach the chain).
"""

from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass, field

from ..utils.errors import ProtocolError
from . import rlp, secp
from .keccak import keccak256

WEI_IN_ETHER = 10**18


def parse_ether(amount: float) -> int:
    # decimal string route to avoid float dust (ethers' parse_ether takes
    # the f64 display representation)
    return int(round(amount * WEI_IN_ETHER))


def address_from_pk(pk) -> bytes:
    """keccak256(uncompressed pk)[12:] (ethereum.rs:111-121)."""
    x, y = pk
    uncompressed = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return keccak256(uncompressed)[12:]


@dataclass
class LegacyTx:
    """Legacy value transfer; None fields RLP-encode as empty (matching
    ethers' TransactionRequest with unset nonce/gas, ethereum.rs:36-50)."""

    chain_id: int
    from_addr: bytes
    to: bytes
    value: int
    nonce: int = 0
    gas_price: int = 0
    gas: int = 0
    data: bytes = b""

    def sighash(self) -> bytes:
        payload = [
            self.nonce,
            self.gas_price,
            self.gas,
            self.to,
            self.value,
            self.data,
            self.chain_id,
            0,
            0,
        ]
        return keccak256(rlp.encode(payload))

    def rlp_signed(self, v: int, r: int, s: int) -> bytes:
        payload = [
            self.nonce,
            self.gas_price,
            self.gas,
            self.to,
            self.value,
            self.data,
            v,
            r,
            s,
        ]
        return rlp.encode(payload)


def to_eip155_v(recid: int, chain_id: int) -> int:
    return 35 + chain_id * 2 + recid


def derive_v_by_trial(tx: LegacyTx, sig: secp.Signature) -> int:
    """Recovery id by trial verification, as the reference does."""
    m = tx.sighash()
    for recid in (0, 1):
        pk = secp.recover_pubkey(m, sig, recid)
        if pk is not None and address_from_pk(pk) == tx.from_addr:
            return to_eip155_v(recid, tx.chain_id)
    raise ProtocolError("signature does not recover to the sender address")


class Ethereum:
    """JSON-RPC chain provider."""

    def __init__(self, url: str):
        self.url = url
        self.chain_id = int(self._rpc("eth_chainId", []), 16)

    def _rpc(self, method: str, params):
        req = urllib.request.Request(
            self.url,
            data=json.dumps(
                {"jsonrpc": "2.0", "id": 1, "method": method, "params": params}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        if "error" in out:
            raise ProtocolError(f"rpc error: {out['error']}")
        return out["result"]

    def compose_tx(self, from_addr: bytes, to: bytes, amount: float):
        tx = LegacyTx(
            chain_id=self.chain_id,
            from_addr=from_addr,
            to=to,
            value=parse_ether(amount),
        )
        return tx, tx.sighash()

    def sent_signed(self, tx: LegacyTx, sig: secp.Signature) -> bytes:
        v = derive_v_by_trial(tx, sig)
        raw = tx.rlp_signed(v, sig.r, sig.s)
        tx_hash = self._rpc("eth_sendRawTransaction", ["0x" + raw.hex()])
        return bytes.fromhex(tx_hash[2:])

    def get_signature(self, tx_hash: bytes):
        tx = self._rpc("eth_getTransactionByHash", ["0x" + tx_hash.hex()])
        if tx is None:
            return None
        r = int(tx["r"], 16)
        s = int(tx["s"], 16)
        return secp.Signature(r % secp.N, s % secp.N)

    def address_from_pk(self, pk) -> bytes:
        return address_from_pk(pk)


@dataclass
class MockChain:
    """In-memory ChainProvider for tests/local runs.  With `state_path`
    set, transactions persist to a JSON file so separate seller/buyer
    processes (the CLI's --mock-chain mode) observe one chain."""

    chain_id: int = 1337
    txs: dict = field(default_factory=dict)
    balances: dict = field(default_factory=dict)
    state_path: str = None

    def _load(self):
        if not self.state_path:
            return
        import os

        if os.path.exists(self.state_path):
            with open(self.state_path) as f:
                doc = json.load(f)
            self.txs = {
                bytes.fromhex(h): (None, secp.Signature(int(r), int(s)))
                for h, (r, s) in doc.get("txs", {}).items()
            }
            self.balances = {
                bytes.fromhex(a): v for a, v in doc.get("balances", {}).items()
            }

    def _save(self):
        if not self.state_path:
            return
        doc = {
            "txs": {
                h.hex(): [str(sig.r), str(sig.s)] for h, (_, sig) in self.txs.items()
            },
            "balances": {a.hex(): v for a, v in self.balances.items()},
        }
        with open(self.state_path, "w") as f:
            json.dump(doc, f)

    def compose_tx(self, from_addr: bytes, to: bytes, amount: float):
        tx = LegacyTx(
            chain_id=self.chain_id,
            from_addr=from_addr,
            to=to,
            value=parse_ether(amount),
        )
        return tx, tx.sighash()

    def sent_signed(self, tx: LegacyTx, sig: secp.Signature) -> bytes:
        v = derive_v_by_trial(tx, sig)  # validates sender
        raw = tx.rlp_signed(v, sig.r, sig.s)
        tx_hash = keccak256(raw)
        self._load()
        self.txs[tx_hash] = (tx, sig)
        self.balances[tx.to] = self.balances.get(tx.to, 0) + tx.value
        self._save()
        return tx_hash

    def get_signature(self, tx_hash: bytes):
        self._load()
        ent = self.txs.get(tx_hash)
        if ent is None:
            return None
        return ent[1]

    def address_from_pk(self, pk) -> bytes:
        return address_from_pk(pk)
