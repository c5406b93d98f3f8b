"""arkworks 0.3 deterministic sampling on top of the ChaCha RNGs.

`ark_std::test_rng()` (ark-std 0.3) is StdRng from the fixed seed below;
`UniformRand` for an `Fp<N*64>` samples N little-endian u64 limbs, masks
the top limb by REPR_SHAVE_BITS = 64*N - MODULUS_BITS, and rejects until
the value is < p (ark-ff 0.3 `rand` impl).  The result is the *canonical*
integer (arkworks converts to Montgomery internally — representation
detail only).

Cross-validation: replaying the Rust original's `test_elgamal_keygen`
(circuits-ark/src/encryption.rs:415-426) through this
module reproduces the ALICE_SK/ALICE_PK golden hex pinned at
circuits-ark/src/utils.rs:114-115 byte-for-byte
(tests/conformance/test_ark_rng.py).
"""

from __future__ import annotations

from .chacha import ChaChaRng, chacha12

# ark-std 0.3 test_rng seed (ark-std/src/rand_helper.rs)
TEST_RNG_SEED = bytes(
    [1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0] + [0] * 16
)


def test_rng() -> ChaChaRng:
    """`ark_std::test_rng()`: StdRng (ChaCha12) from the fixed seed."""
    return chacha12(TEST_RNG_SEED)


def uniform_bigint(rng: ChaChaRng, limbs64: int) -> int:
    """BigInteger::rand — limbs64 little-endian u64 draws."""
    v = 0
    for i in range(limbs64):
        v |= rng.next_u64() << (64 * i)
    return v


def fp_rand(rng: ChaChaRng, p: int, limbs64: int | None = None) -> int:
    """`Fp::rand` — shave top bits, reject until < p; canonical value."""
    nbits = p.bit_length()
    if limbs64 is None:
        limbs64 = -(-nbits // 64)
    shave = 64 * limbs64 - nbits
    mask = (1 << (64 * limbs64)) - 1
    top_mask = mask >> shave
    while True:
        v = uniform_bigint(rng, limbs64) & top_mask
        if v < p:
            return v
