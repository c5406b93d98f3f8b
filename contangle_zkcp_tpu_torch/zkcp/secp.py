"""secp256k1 keys + ECDSA + adaptor signatures (host-side).

Mirrors the reference's payment-layer crypto: secp256kfun/ecdsa_fun 0.7
with the `adaptor` feature (nulltea/contangle-zkcp:lib/Cargo.toml:17-18, used by
seller.rs:76-77 / buyer.rs:39-40), and the key utilities of
lib/src/utils.rs:15-50.  Tiny, security-critical, host-only math — the card
has no role here (SURVEY.md §2.2 adaptor row).  Port of
`contangle_zkcp_tpu/zkcp/secp.py`, unchanged.

Adaptor scheme (ECDSA one-time VES, as in ecdsa_fun):
  EncSign(x, Y, m): k ← nonce; R = k*Y; R_hat = k*G; r = R.x mod n;
                    s_hat = k^{-1}(m + r*x); pi = DLEQ(G, R_hat; Y, R).
  EncVerify: check pi and m*s_hat^{-1}*G + r*s_hat^{-1}*X == R_hat.
  Decrypt(y): s = s_hat * y^{-1}  ->  (r, s) verifies under nonce k*y.
  Recover(Y, sig, enc_sig): y = s^{-1}*s_hat (or its negation).

Point serialization: 33-byte SEC1 compressed (secp256kfun `to_bytes`);
scalars 32-byte big-endian.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
from dataclasses import dataclass

from ..curves.host import SWCurve
from ..fields import instances as fi

SECP256K1 = SWCurve(
    p=fi.SECP256K1_P,
    a=0,
    b=7,
    order=fi.SECP256K1_N,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)
N = SECP256K1.order
P = SECP256K1.p


# ------------------------------------------------------------------ points
def point_to_bytes(Pt) -> bytes:
    x, y = Pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def point_from_bytes(b: bytes):
    from ..curves.host import sqrt_mod

    if len(b) != 33 or b[0] not in (2, 3):
        raise ValueError("bad SEC1 compressed point")
    x = int.from_bytes(b[1:], "big")
    y2 = (x * x * x + 7) % P
    y = sqrt_mod(y2, P)
    if y is None:
        raise ValueError("not on curve")
    if (y & 1) != (b[0] & 1):
        y = P - y
    return (x, y)


def scalar_to_bytes(s: int) -> bytes:
    return int(s % N).to_bytes(32, "big")


def scalar_from_bytes(b: bytes) -> int:
    """secp256kfun Scalar::from_slice semantics: 32 bytes big-endian,
    must be < n; NonZero mark additionally requires != 0."""
    if len(b) != 32:
        raise ValueError("scalar must be 32 bytes")
    x = int.from_bytes(b, "big")
    if x >= N:
        raise ValueError("scalar overflows group order")
    return x


# ------------------------------------------------------------------- keys
def keypair_gen(rng=None):
    sk = rng.randrange(1, N) if rng else secrets.randbelow(N - 1) + 1
    return sk, SECP256K1.mul(sk, SECP256K1.generator)


def keypair_from_hex(h: str):
    sk = scalar_from_bytes(bytes.fromhex(h))
    if sk == 0:
        raise ValueError("zero scalar")
    return sk, SECP256K1.mul(sk, SECP256K1.generator)


def keypair_from_bytes(b: bytes):
    """The cross-curve derivation hook (utils.rs:28-37): interpret 32 bytes
    big-endian; fail on overflow/zero so `keygen_derive` can retry."""
    sk = scalar_from_bytes(b)
    if sk == 0:
        raise ValueError("zero scalar")
    return sk, SECP256K1.mul(sk, SECP256K1.generator)


# ------------------------------------------------------------------ ECDSA
def _rfc6979_k(sk: int, msg32: bytes, extra: bytes = b"") -> int:
    """Deterministic nonce (RFC 6979, HMAC-SHA256)."""
    h1 = msg32
    V = b"\x01" * 32
    K = b"\x00" * 32
    x = scalar_to_bytes(sk)
    K = hmac.new(K, V + b"\x00" + x + h1 + extra, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    K = hmac.new(K, V + b"\x01" + x + h1 + extra, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    while True:
        V = hmac.new(K, V, hashlib.sha256).digest()
        k = int.from_bytes(V, "big")
        if 1 <= k < N:
            return k
        K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()


@dataclass
class Signature:
    r: int  # R.x as a scalar ("R_x" in ecdsa_fun)
    s: int

    def to_bytes(self):
        return scalar_to_bytes(self.r) + scalar_to_bytes(self.s)

    @staticmethod
    def from_bytes(b):
        return Signature(scalar_from_bytes(b[:32]), scalar_from_bytes(b[32:]))


def sign(sk: int, msg32: bytes) -> Signature:
    m = int.from_bytes(msg32, "big") % N
    k = _rfc6979_k(sk, msg32)
    R = SECP256K1.mul(k, SECP256K1.generator)
    r = R[0] % N
    s = pow(k, -1, N) * (m + r * sk) % N
    if s > N // 2:  # low-s normalization (Ethereum requires it)
        s = N - s
    return Signature(r, s)


def verify(pk, msg32: bytes, sig: Signature) -> bool:
    if not (1 <= sig.r < N and 1 <= sig.s < N):
        return False
    m = int.from_bytes(msg32, "big") % N
    si = pow(sig.s, -1, N)
    u1, u2 = m * si % N, sig.r * si % N
    R = SECP256K1.add(
        SECP256K1.mul(u1, SECP256K1.generator), SECP256K1.mul(u2, pk)
    )
    return R is not None and R[0] % N == sig.r


def recover_pubkey(msg32: bytes, sig: Signature, recid: int):
    """Recover the public key (Ethereum's ecrecover); recid in {0, 1}."""
    x = sig.r  # (ignoring the r >= p - n edge case, prob ~2^-128)
    from ..curves.host import sqrt_mod

    y2 = (x * x * x + 7) % P
    y = sqrt_mod(y2, P)
    if y is None:
        return None
    if (y & 1) != recid:
        y = P - y
    R = (x, y)
    m = int.from_bytes(msg32, "big") % N
    rinv = pow(sig.r, -1, N)
    # Q = r^-1 (s*R - m*G)
    sR = SECP256K1.mul(sig.s, R)
    mG = SECP256K1.mul(m, SECP256K1.generator)
    Q = SECP256K1.add(sR, SECP256K1.neg(mG))
    return SECP256K1.mul(rinv, Q)


# -------------------------------------------------------- DLEQ (Chaum-Pedersen)
@dataclass
class DleqProof:
    c: int
    z: int


def _dleq_challenge(Y, A, B, T1, T2) -> int:
    h = hashlib.sha256()
    for Pt in (SECP256K1.generator, Y, A, B, T1, T2):
        h.update(point_to_bytes(Pt))
    return int.from_bytes(h.digest(), "big") % N


def dleq_prove(k: int, Y, A, B, rng=None) -> DleqProof:
    """Prove log_G(A) == log_Y(B) == k."""
    t = rng.randrange(1, N) if rng else secrets.randbelow(N - 1) + 1
    T1 = SECP256K1.mul(t, SECP256K1.generator)
    T2 = SECP256K1.mul(t, Y)
    c = _dleq_challenge(Y, A, B, T1, T2)
    z = (t + c * k) % N
    return DleqProof(c, z)


def dleq_verify(Y, A, B, proof: DleqProof) -> bool:
    zG = SECP256K1.mul(proof.z, SECP256K1.generator)
    zY = SECP256K1.mul(proof.z, Y)
    cA = SECP256K1.mul(proof.c, A)
    cB = SECP256K1.mul(proof.c, B)
    T1 = SECP256K1.add(zG, SECP256K1.neg(cA))
    T2 = SECP256K1.add(zY, SECP256K1.neg(cB))
    if T1 is None or T2 is None:
        return False
    return _dleq_challenge(Y, A, B, T1, T2) == proof.c


# ------------------------------------------------------- adaptor signatures
@dataclass
class EncryptedSignature:
    R: tuple  # k*Y (the decrypted signature's nonce point)
    R_hat: tuple  # k*G
    s_hat: int
    proof: DleqProof

    def to_hex(self) -> str:
        return (
            point_to_bytes(self.R)
            + point_to_bytes(self.R_hat)
            + scalar_to_bytes(self.s_hat)
            + scalar_to_bytes(self.proof.c)
            + scalar_to_bytes(self.proof.z)
        ).hex()

    @staticmethod
    def from_hex(h: str) -> "EncryptedSignature":
        b = bytes.fromhex(h)
        if len(b) != 33 + 33 + 96:
            raise ValueError("bad encrypted signature length")
        return EncryptedSignature(
            R=point_from_bytes(b[:33]),
            R_hat=point_from_bytes(b[33:66]),
            s_hat=scalar_from_bytes(b[66:98]),
            proof=DleqProof(scalar_from_bytes(b[98:130]), scalar_from_bytes(b[130:162])),
        )


def encrypted_sign(sk: int, enc_pk, msg32: bytes) -> EncryptedSignature:
    """One-time VES under encryption key Y = enc_pk (ecdsa_fun
    `Adaptor::encrypted_sign` with deterministic nonces)."""
    m = int.from_bytes(msg32, "big") % N
    k = _rfc6979_k(sk, msg32, extra=point_to_bytes(enc_pk))
    R = SECP256K1.mul(k, enc_pk)
    R_hat = SECP256K1.mul(k, SECP256K1.generator)
    r = R[0] % N
    if r == 0:
        raise ValueError("degenerate nonce")
    s_hat = pow(k, -1, N) * (m + r * sk) % N
    proof = dleq_prove(k, enc_pk, R_hat, R)
    return EncryptedSignature(R, R_hat, s_hat, proof)


def verify_encrypted_signature(pk, enc_pk, msg32: bytes, es: EncryptedSignature) -> bool:
    if not dleq_verify(enc_pk, es.R_hat, es.R, es.proof):
        return False
    m = int.from_bytes(msg32, "big") % N
    r = es.R[0] % N
    if r == 0 or es.s_hat == 0:
        return False
    si = pow(es.s_hat, -1, N)
    u1, u2 = m * si % N, r * si % N
    T = SECP256K1.add(SECP256K1.mul(u1, SECP256K1.generator), SECP256K1.mul(u2, pk))
    return T == es.R_hat


def decrypt_signature(y: int, es: EncryptedSignature) -> Signature:
    s = es.s_hat * pow(y, -1, N) % N
    if s > N // 2:
        s = N - s
    return Signature(es.R[0] % N, s)


def recover_decryption_key(enc_pk, sig: Signature, es: EncryptedSignature):
    """The fairness hinge (buyer.rs:115-122): the broadcast signature plus
    the pre-signature algebraically reveal y."""
    if sig.r != es.R[0] % N:
        return None
    y = pow(sig.s, -1, N) * es.s_hat % N
    for cand in (y, (N - y) % N):
        if SECP256K1.mul(cand, SECP256K1.generator) == enc_pk:
            return cand
    return None
