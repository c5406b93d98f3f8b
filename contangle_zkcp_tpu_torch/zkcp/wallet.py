"""LocalWallet + Web3 Secret Storage (v3) keystore files.

Mirror of nulltea/contangle-zkcp:lib/src/wallet.rs and the eth-keystore
read/write helpers in lib/src/utils.rs:52-83 (scrypt + aes-128-ctr +
keccak MAC, the standard geth keystore format).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets
import unicodedata
import uuid
from pathlib import Path

from ..utils.errors import ProtocolError
from . import secp
from .aes import aes128_ctr
from .keccak import keccak256


class LocalWallet:
    def __init__(self, sk: int):
        self.sk = sk
        self.pk = secp.SECP256K1.mul(sk, secp.SECP256K1.generator)

    @staticmethod
    def new(rng=None) -> "LocalWallet":
        sk, _ = secp.keypair_gen(rng)
        return LocalWallet(sk)

    @staticmethod
    def from_hex(h: str) -> "LocalWallet":
        sk, _ = secp.keypair_from_hex(h)
        return LocalWallet(sk)

    @staticmethod
    def from_keystore(path, password: bytes) -> "LocalWallet":
        return LocalWallet(read_keystore(path, password))

    @staticmethod
    def from_bip39(phrase: str) -> "LocalWallet":
        sk, _ = keypair_from_bip39(phrase)
        return LocalWallet(sk)

    def pub_key(self):
        return self.pk

    def sec_key(self) -> int:
        return self.sk

    def address(self) -> bytes:
        from .ethereum import address_from_pk

        return address_from_pk(self.pk)


# --------------------------------------------------------------- BIP39/BIP32
# Mnemonic-phrase key recovery, mirroring the reference's
# keypair_from_bip39 (nulltea/contangle-zkcp:lib/src/utils.rs:38-50), which uses
# ethers' MnemonicBuilder<English> with the default Ethereum derivation
# path m/44'/60'/0'/0/0: BIP39 seed (PBKDF2-HMAC-SHA512, salt "mnemonic",
# 2048 rounds) -> BIP32 HD chain under "Bitcoin seed".
#
# NOTE: no BIP39 English wordlist ships in this environment, so word/
# checksum validation is limited to shape checks; seed derivation itself
# never needs the wordlist.

ETH_DERIVATION_PATH = (
    (44 | 0x80000000, 60 | 0x80000000, 0x80000000, 0, 0)
)


def _bip39_seed(phrase: str, passphrase: str = "") -> bytes:
    norm = unicodedata.normalize
    return hashlib.pbkdf2_hmac(
        "sha512",
        norm("NFKD", phrase).encode(),
        b"mnemonic" + norm("NFKD", passphrase).encode(),
        2048,
        64,
    )


def _bip32_derive(seed: bytes, path=ETH_DERIVATION_PATH) -> int:
    n = secp.SECP256K1.order
    I = hmac.new(b"Bitcoin seed", seed, hashlib.sha512).digest()
    k, chain = int.from_bytes(I[:32], "big"), I[32:]
    for idx in path:
        if idx & 0x80000000:  # hardened: 0x00 || ser256(k) || ser32(i)
            data = b"\x00" + k.to_bytes(32, "big") + idx.to_bytes(4, "big")
        else:  # normal: serP(K) || ser32(i)
            P = secp.SECP256K1.mul(k, secp.SECP256K1.generator)
            data = secp.point_to_bytes(P) + idx.to_bytes(4, "big")
        I = hmac.new(chain, data, hashlib.sha512).digest()
        k = (int.from_bytes(I[:32], "big") + k) % n
        chain = I[32:]
        if k == 0:
            raise ProtocolError("bip32: derived zero key")
    return k


def keypair_from_bip39(phrase: str, passphrase: str = ""):
    """(sk, pk) from an English mnemonic at m/44'/60'/0'/0/0."""
    words = phrase.split()
    if len(words) not in (12, 15, 18, 21, 24):
        raise ProtocolError(f"bip39: bad word count {len(words)}")
    sk = _bip32_derive(_bip39_seed(phrase, passphrase))
    pk = secp.SECP256K1.mul(sk, secp.SECP256K1.generator)
    return sk, pk


def write_keystore(sk: int, dirpath, name: str, password: bytes) -> str:
    os.makedirs(dirpath, exist_ok=True)
    salt = secrets.token_bytes(32)
    iv = secrets.token_bytes(16)
    key = hashlib.scrypt(password, salt=salt, n=8192, r=8, p=1, dklen=32)
    sk_bytes = secp.scalar_to_bytes(sk)
    ct = aes128_ctr(key[:16], iv, sk_bytes)
    mac = keccak256(key[16:32] + ct)
    doc = {
        "crypto": {
            "cipher": "aes-128-ctr",
            "cipherparams": {"iv": iv.hex()},
            "ciphertext": ct.hex(),
            "kdf": "scrypt",
            "kdfparams": {
                "dklen": 32,
                "n": 8192,
                "p": 1,
                "r": 8,
                "salt": salt.hex(),
            },
            "mac": mac.hex(),
        },
        "id": str(uuid.uuid4()),
        "version": 3,
    }
    path = Path(dirpath) / name
    path.write_text(json.dumps(doc))
    return str(path)


def read_keystore(path, password: bytes) -> int:
    doc = json.loads(Path(path).read_text())
    crypto = doc["crypto"]
    kdf = crypto["kdf"]
    params = crypto["kdfparams"]
    if kdf == "scrypt":
        key = hashlib.scrypt(
            password,
            salt=bytes.fromhex(params["salt"]),
            n=params["n"],
            r=params["r"],
            p=params["p"],
            dklen=params["dklen"],
            maxmem=2**31 - 1,
        )
    elif kdf == "pbkdf2":
        key = hashlib.pbkdf2_hmac(
            "sha256", password, bytes.fromhex(params["salt"]), params["c"], params["dklen"]
        )
    else:
        raise ProtocolError(f"unsupported kdf {kdf}")
    ct = bytes.fromhex(crypto["ciphertext"])
    mac = keccak256(key[16:32] + ct)
    if mac.hex() != crypto["mac"]:
        raise ProtocolError("keystore MAC mismatch (wrong password?)")
    iv = bytes.fromhex(crypto["cipherparams"]["iv"])
    sk_bytes = aes128_ctr(key[:16], iv, ct)
    return secp.scalar_from_bytes(sk_bytes)
