"""Port curves/ (torch) against the JAX package: G1 and G2 complete adds and
doubles limb for limb against the JAX SWDevice, scalar multiplication
against the JAX package's host curve math.  The K3 twin against the
Pallas point add it replaces is in tests/test_torch_pallas.py."""

import functools

import numpy as np
import pytest

from contangle_zkcp_tpu.curves import instances as jci
from contangle_zkcp_tpu.curves.fq2_device import Fq2Device as JFq2
from contangle_zkcp_tpu.curves.weierstrass import SWDevice as JSW
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu_torch.curves.fq2_device import Fq2Device
from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
from contangle_zkcp_tpu_torch.fields import instances as tfi
from tests.torch_port_util import one_torch_thread  # noqa: F401

G2_GEN = (jci.BLS12_381_G2_GX, jci.BLS12_381_G2_GY)


@functools.lru_cache(maxsize=None)
def groups(name):
    jFq, tFq = jfi.bls12_381_fq(), tfi.bls12_381_fq()
    if name == "g1":
        return JSW(jFq, jci.BLS12_381_G1), SWDevice(tFq, jci.BLS12_381_G1, device="cpu")
    b2 = jci.BLS12_381_G2_B
    return JSW(JFq2(jFq), b=b2), SWDevice(Fq2Device(tFq), b=b2, device="cpu")


def points(name, n, seed):
    """n affine points (None = identity) from a numpy seed, host math."""
    jdev, _ = groups(name)
    gen = jci.BLS12_381_G1.generator if name == "g1" else G2_GEN
    rng = np.random.default_rng(seed)
    return [jdev.host_mul(int(k), gen) for k in rng.integers(1, 1 << 20, size=n)]


def pairs(name, seed):
    P = points(name, 4, seed)
    neg = _neg(name, P[1])
    left = [P[0], None, P[2], P[1], P[3], None]
    right = [P[1], P[2], P[2], neg, None, None]
    return left, right


def _neg(name, Q):
    p = jfi.BLS12_381_P
    if name == "g1":
        return (Q[0], (-Q[1]) % p)
    return (Q[0], ((-Q[1][0]) % p, (-Q[1][1]) % p))


def _same(tP, jP):
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(tP[k].numpy(), np.asarray(jP[k]))


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_encode_points_match_jax(name):
    jdev, tdev = groups(name)
    left, _ = pairs(name, 1)
    _same(tdev.encode_points(left), jdev.encode_points(left))
    assert tdev.decode_points(tdev.encode_points(left)) == left


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_add_matches_jax_and_host(name):
    jdev, tdev = groups(name)
    left, right = pairs(name, 2)
    jP, jQ = jdev.encode_points(left), jdev.encode_points(right)
    tP, tQ = tdev.encode_points(left), tdev.encode_points(right)
    got = tdev.add(tP, tQ)
    _same(got, jdev.add(jP, jQ))
    assert tdev.decode_points(got) == [jdev.host_add(a, b) for a, b in zip(left, right)]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_double_matches_jax(name):
    jdev, tdev = groups(name)
    left, _ = pairs(name, 3)
    got = tdev.double(tdev.encode_points(left))
    _same(got, jdev.double(jdev.encode_points(left)))
    assert tdev.decode_points(got) == [jdev.host_add(a, a) for a in left]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_scalar_mul_matches_host(name):
    jdev, tdev = groups(name)
    base = points(name, 3, 4)
    ks = [0, 1, 0xBEEF]
    got = tdev.decode_points(tdev.scalar_mul_ints(tdev.encode_points(base), ks, 16))
    assert got == [jdev.host_mul(k, P) for k, P in zip(ks, base)]


def test_broadcast_add():
    _, tdev = groups("g1")
    P = points("g1", 3, 5)
    got = tdev.add(
        {k: v[:, None] for k, v in tdev.encode_points(P).items()},
        {k: v[None, :] for k, v in tdev.encode_points(P[:2]).items()},
    )
    assert got["x"].shape == (3, 2, 24)
    flat = tdev.decode_points(got)
    assert flat == [jci.BLS12_381_G1.add(a, b) for a in P for b in P[:2]]


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_sqrt_mod_matches_reference(name):
    """The host square root (point decompression) returns the reference's
    root or None for the same inputs: p = 3 mod 4 (Fq) takes one
    exponentiation, p = 1 mod 4 (Fr) Tonelli-Shanks."""
    from contangle_zkcp_tpu.curves.host import sqrt_mod as jsqrt
    from contangle_zkcp_tpu_torch.curves.host import sqrt_mod

    p = getattr(tfi, f"bls12_381_{name}")().p
    xs = [0, 1, p - 1] + [int(v) for v in np.random.default_rng(99).integers(0, 1 << 62, size=40)]
    xs += [x * x % p for x in xs[3:13]]
    for x in xs:
        r = sqrt_mod(x, p)
        assert r == jsqrt(x, p)
        assert r is None or r * r % p == x % p
