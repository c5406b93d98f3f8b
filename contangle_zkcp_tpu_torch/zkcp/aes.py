"""Minimal AES-128 in CTR mode (pure Python).

Only what the Web3 keystore format needs (aes-128-ctr); encryption and
decryption are the same operation in CTR.  No external crypto deps exist
in this image, and hashlib provides scrypt but not AES.
"""

from __future__ import annotations

_SBOX = None


def _build_sbox():
    global _SBOX
    if _SBOX is not None:
        return _SBOX
    # multiplicative inverse table via exp/log in GF(2^8)
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
        x &= 0xFF
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    sbox = [0] * 256
    for i in range(256):
        inv = 0 if i == 0 else exp[255 - log[i]]
        b = inv
        res = 0
        for _ in range(5):
            res ^= b
            b = ((b << 1) | (b >> 7)) & 0xFF
        sbox[i] = res ^ 0x63
    _SBOX = sbox
    return sbox


def _xtime(a):
    a <<= 1
    if a & 0x100:
        a ^= 0x11B
    return a & 0xFF


def _expand_key(key: bytes):
    sbox = _build_sbox()
    assert len(key) == 16
    w = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [sbox[b] for b in t]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return w


def _encrypt_block(block: bytes, w) -> bytes:
    sbox = _build_sbox()
    s = [[block[r + 4 * c] for c in range(4)] for r in range(4)]

    def add_round_key(rnd):
        for c in range(4):
            for r in range(4):
                s[r][c] ^= w[4 * rnd + c][r]

    add_round_key(0)
    for rnd in range(1, 11):
        for r in range(4):
            for c in range(4):
                s[r][c] = sbox[s[r][c]]
        for r in range(1, 4):
            s[r] = s[r][r:] + s[r][:r]
        if rnd != 10:
            for c in range(4):
                a = [s[r][c] for r in range(4)]
                s[0][c] = _xtime(a[0]) ^ _xtime(a[1]) ^ a[1] ^ a[2] ^ a[3]
                s[1][c] = a[0] ^ _xtime(a[1]) ^ _xtime(a[2]) ^ a[2] ^ a[3]
                s[2][c] = a[0] ^ a[1] ^ _xtime(a[2]) ^ _xtime(a[3]) ^ a[3]
                s[3][c] = _xtime(a[0]) ^ a[0] ^ a[1] ^ a[2] ^ _xtime(a[3])
        add_round_key(rnd)
    return bytes(s[r][c] for c in range(4) for r in range(4))


def aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    w = _expand_key(key)
    counter = int.from_bytes(iv, "big")
    out = bytearray()
    for off in range(0, len(data), 16):
        ks = _encrypt_block(counter.to_bytes(16, "big"), w)
        counter = (counter + 1) % (1 << 128)
        chunk = data[off : off + 16]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
    return bytes(out)
