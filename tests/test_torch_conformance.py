"""The port's conformance/ (the arkworks ChaCha RNG and UniformRand) replays
the vectors of tests/conformance/test_ark_rng.py through the port's own
modules, and equals the JAX package's copy on seeded streams."""

import random
import struct

import pytest

from contangle_zkcp_tpu.conformance import ark_rng as jark
from contangle_zkcp_tpu.conformance import chacha as jchacha
from contangle_zkcp_tpu_torch.circuits import elgamal
from contangle_zkcp_tpu_torch.conformance.ark_rng import TEST_RNG_SEED, fp_rand, test_rng as ark_test_rng, uniform_bigint
from contangle_zkcp_tpu_torch.conformance.chacha import chacha12, chacha20, chacha_block
from contangle_zkcp_tpu_torch.curves import instances as ci
from contangle_zkcp_tpu_torch.fields import instances as fi
from contangle_zkcp_tpu_torch.utils.serialize import edwards_to_bytes, fp_from_random_bytes
from tests.conformance.test_ark_rng import ALICE_SK


def test_chacha20_rfc7539_block():
    key = list(struct.unpack("<8I", bytes(range(32))))
    nonce = struct.unpack("<3I", bytes.fromhex("000000090000004a00000000"))
    buf = b"".join(struct.pack("<I", w) for w in chacha_block(key, (1,), nonce, 20))
    assert buf.hex().startswith("10f1e7e4d13b5915500fdd1fa32071c4")


def test_test_rng_first_words_and_alice_sk():
    rng = ark_test_rng()
    assert [hex(rng.next_u64()) for _ in range(4)] == [
        "0x94c25463ca1c3fbe", "0x42da2de98c064cf", "0xf46bfbdbb7949e00", "0xaaddd44f7e3b786e",
    ]
    assert fp_rand(ark_test_rng(), fi.JUBJUB_FR).to_bytes(32, "little").hex() == ALICE_SK
    assert ark_test_rng().fill_bytes(32).hex() == ALICE_SK[:-2] + "aa"


@pytest.mark.parametrize("p,want", [
    (fi.JUBJUB_FR, 0x0ADDD44F7E3B786EF46BFBDBB7949E00042DA2DE98C064CF94C25463CA1C3FBE),
    (fi.BLS12_381_R, 0x2ADDD44F7E3B786EF46BFBDBB7949E00042DA2DE98C064CF94C25463CA1C3FBE),
    (fi.BLS12_381_P, 0x33EDC24198C03528255C7E9F7A37C04AADDD44F7E3B786EF46BFBDBB7949E00042DA2DE98C064CF94C25463CA1C3FBE),
])
def test_field_rand_first_draws(p, want):
    assert fp_rand(ark_test_rng(), p) == want


def test_ciphertext_decode_and_elgamal_transcript_replay():
    """utils.rs test_ciphertext_decode and encryption.rs
    test_elgamal_encryption (n = 1) through the port's curve, Poseidon
    sponge and serialization."""
    v = fp_from_random_bytes(ark_test_rng().fill_bytes(32), fi.BLS12_381_R)
    assert v == 0x2ADDD44F7E3B786EF46BFBDBB7949E00042DA2DE98C064CF94C25463CA1C3FBE
    rng = ark_test_rng()
    msg = fp_from_random_bytes(bytes([1, 2, 3]), fi.BLS12_381_R)
    sk = fp_rand(rng, fi.JUBJUB_FR)
    pk = ci.JUBJUB.mul(sk, ci.JUBJUB.generator)
    r = fp_rand(rng, fi.JUBJUB_FR)
    assert r == 0x087B871A42CC7E352F862DB864633FA7433EDC24198C03528255C7E9F7A37C04
    params = elgamal.ElGamalParams(curve=ci.JUBJUB, n=1)
    c1, c2 = elgamal.encrypt(params, pk, [msg], r)
    assert edwards_to_bytes(pk, ci.JUBJUB).hex() == "1331b63a3f85f69c5169c003f4764f87f4ce792820252337ebbb106da2b56496"
    assert edwards_to_bytes(c1, ci.JUBJUB).hex() == "533ab6608e0fc18737e51d1512af0a355374e7d857b7c94df3261a3ee6e663ce"
    assert c2 == [0x6B188B158FB7820CE6F1879709B1A8FC19088B92B922F40947532E67741CDEC6]
    assert elgamal.decrypt(params, sk, (c1, c2)) == [msg]


@pytest.mark.parametrize("rounds", [12, 20])
def test_seeded_streams_equal_reference(rounds):
    ours_of, ref_of = (chacha12, jchacha.chacha12) if rounds == 12 else (chacha20, jchacha.chacha20)
    assert TEST_RNG_SEED == jark.TEST_RNG_SEED
    for seed in range(4):
        key = random.Random(seed).randbytes(32)
        ours, ref = ours_of(key), ref_of(key)
        # words across block boundaries, a partial-word fill, then draws
        assert [ours.next_u32() for _ in range(23)] == [ref.next_u32() for _ in range(23)]
        assert ours.fill_bytes(37) == ref.fill_bytes(37)
        assert [ours.next_u64() for _ in range(9)] == [ref.next_u64() for _ in range(9)]
        assert uniform_bigint(ours, 4) == jark.uniform_bigint(ref, 4)
        for p in (fi.JUBJUB_FR, fi.BLS12_381_R, fi.BLS12_381_P, fi.PASTA_P):
            assert fp_rand(ours, p) == jark.fp_rand(ref, p)
