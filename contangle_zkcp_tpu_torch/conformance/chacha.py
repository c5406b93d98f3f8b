"""ChaCha stream RNGs matching the Rust `rand` crate's semantics.

The Rust original's deterministic tests all start from `ark_std::test_rng()`
(circuits-ark/src/encryption.rs:352 etc.), which in
ark-std 0.3 is `rand::rngs::StdRng::from_seed(SEED)` with rand 0.8 —
i.e. **ChaCha12** with a 64-bit block counter in words 12-13 and the
stream id (0) in words 14-15.  The adaptor-signature stack additionally
uses ChaCha20 (ecdsa_fun's `HashTranscript<_, ChaCha20Rng>`,
lib/src/seller.rs:76).

Word-stream semantics mirror rand's `BlockRng`:
  * `next_u32` serves consecutive words of consecutive blocks;
  * `next_u64` = lo word then hi word (little-endian halves);
  * `fill_bytes` consumes whole words, dropping unused trailing bytes of
    a partial word (rand's `fill_via_u32_chunks` contract).

The 20-round core is validated against the RFC 7539 block-function test
vector in tests/conformance/.
"""

from __future__ import annotations

import struct

_MASK = 0xFFFFFFFF


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & _MASK


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & _MASK
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _MASK
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha_block(key_words, counter_words, nonce_words, rounds: int):
    """One ChaCha block: 16 output u32 words.

    key_words: 8 u32; counter_words + nonce_words: 4 u32 total (the
    split between counter and nonce is the caller's convention).
    """
    const = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
    init = list(const) + list(key_words) + list(counter_words) + list(nonce_words)
    s = list(init)
    for _ in range(rounds // 2):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return [(s[i] + init[i]) & _MASK for i in range(16)]


class ChaChaRng:
    """rand_chacha-compatible RNG: 64-bit block counter, 64-bit stream id."""

    def __init__(self, seed: bytes, rounds: int):
        assert len(seed) == 32
        self.key = list(struct.unpack("<8I", seed))
        self.rounds = rounds
        self.counter = 0  # 64-bit block counter
        self.stream = 0  # 64-bit stream id (words 14-15), always 0 here
        self._buf: list[int] = []
        self._idx = 0

    def _refill(self):
        ctr = (self.counter & _MASK, (self.counter >> 32) & _MASK)
        nonce = (self.stream & _MASK, (self.stream >> 32) & _MASK)
        self._buf = chacha_block(self.key, ctr, nonce, self.rounds)
        self._idx = 0
        self.counter += 1

    def next_u32(self) -> int:
        if self._idx >= len(self._buf):
            self._refill()
        w = self._buf[self._idx]
        self._idx += 1
        return w

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def fill_bytes(self, n: int) -> bytes:
        """rand BlockRng fill: whole words, partial tail word truncated."""
        out = bytearray()
        while len(out) < n:
            w = self.next_u32()
            out += struct.pack("<I", w)
        return bytes(out[:n])


def chacha12(seed: bytes) -> ChaChaRng:
    return ChaChaRng(seed, 12)


def chacha20(seed: bytes) -> ChaChaRng:
    return ChaChaRng(seed, 20)
