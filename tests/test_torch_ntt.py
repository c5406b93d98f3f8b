"""Port ops/ntt.py (torch) against the JAX package's NTT, limb for limb,
in the default configuration and under ZKCP_MXU=1 (the tensor-core
passes' twin).  The K2 twin against the Pallas butterfly it replaces is in
tests/test_torch_pallas.py."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu.ops.ntt import NTT as JNTT
from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.ops.ntt import NTT, powers

from tests.torch_port_util import one_torch_thread, rand_ints  # noqa: F401

COSET_G = 7  # the prover's coset generator for BLS12-381 Fr


@functools.lru_cache(maxsize=None)
def engines(n):
    jF, tF = jfi.bls12_381_fr(), tfi.bls12_381_fr()
    return jF, tF, JNTT(jF, n), NTT(tF, n, device="cpu")


@pytest.mark.parametrize("op", ["forward", "inverse", "coset_forward", "coset_inverse"])
@pytest.mark.parametrize("n", [8, 256])
def test_ntt_matches_jax(n, op):
    jF, tF, jn, tn = engines(n)
    xs = rand_ints(jF.p, n - 3, seed=n)
    ja, ta = jnp.asarray(jF.encode(xs)), tF.encode(xs, device="cpu")
    args = (COSET_G,) if op.startswith("coset") else ()
    want = np.asarray(getattr(jn, op)(ja, *args))
    got = getattr(tn, op)(ta, *args)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["forward", "inverse", "coset_forward", "coset_inverse"])
def test_ntt_mxu_matches_jax(op, monkeypatch):
    """ZKCP_MXU=1: the passes' twin (K5b's, the constant products as the
    reference's Toeplitz matrix products) equal to the JAX NTT at n = 16."""
    jF, tF, jn, tn = engines(16)
    xs = rand_ints(jF.p, 13, seed=19)
    ja, ta = jnp.asarray(jF.encode(xs)), tF.encode(xs, device="cpu")
    args = (COSET_G,) if op.startswith("coset") else ()
    want = np.asarray(getattr(jn, op)(ja, *args))
    monkeypatch.setenv("ZKCP_MXU", "1")
    np.testing.assert_array_equal(getattr(tn, op)(ta, *args).numpy(), want)


@pytest.mark.parametrize("n", [8, 256])
def test_ntt_roundtrip_and_host_dft(n):
    _, tF, _, tn = engines(n)
    xs = rand_ints(tF.p, n - 3, seed=n + 1)
    ta = tF.encode(xs, device="cpu")
    if n == 8:
        assert tF.decode(tn.forward(ta)) == tn.h_forward(xs)
    assert tF.decode(tn.inverse(tn.forward(ta))) == xs
    assert tF.decode(tn.coset_inverse(tn.coset_forward(ta, COSET_G), COSET_G)) == xs


def test_twiddle_table_is_powers():
    tF = tfi.bls12_381_fr()
    g = 7
    assert tF.decode(powers(tF, g, 16, "cpu")) == [pow(g, i, tF.p) for i in range(16)]
