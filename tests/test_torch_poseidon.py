"""The port's device Poseidon and Merkle tree (ops/poseidon.py
PoseidonDevice, ops/merkle.py build_tree_device) on the CPU against the
JAX package's PoseidonDevice and the host permutation, exactly; and the
same tree under ZKCP_MXU=1, whose every multiply runs K5a's twin."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu.ops import merkle as jmerkle
from contangle_zkcp_tpu.ops.poseidon import PoseidonDevice as JPoseidonDevice
from contangle_zkcp_tpu.ops.poseidon import PoseidonHost as JPoseidonHost
from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.ops import merkle
from contangle_zkcp_tpu_torch.ops.poseidon import PoseidonDevice, PoseidonHost
from tests.torch_port_util import one_torch_thread, rand_ints  # noqa: F401


def test_hash1_hash2_match_jax_device_and_host():
    jF, tF = jfi.bls12_381_fr(), tfi.bls12_381_fr()
    xs = rand_ints(tF.p, 13, 21)
    ys = rand_ints(tF.p, 13, 22)[::-1]
    jdev, tdev = JPoseidonDevice(jF), PoseidonDevice(tF)
    x, y = tF.encode(xs, device="cpu"), tF.encode(ys, device="cpu")
    got2, got1 = tdev.hash2(x, y), tdev.hash1(x)
    want2 = np.asarray(jdev.hash2(jnp.asarray(jF.encode(xs)), jnp.asarray(jF.encode(ys))))
    want1 = np.asarray(jdev.hash1(jnp.asarray(jF.encode(xs))))
    np.testing.assert_array_equal(got2.numpy(), want2)
    np.testing.assert_array_equal(got1.numpy(), want1)
    host = JPoseidonHost(jF.p)
    assert tF.decode(got2) == [host.hash2(a, b) for a, b in zip(xs, ys)]
    assert tF.decode(got1) == [host.hash1(a) for a in xs]


def test_permute_batch_axes():
    """Leading batch axes ride along: a (2, 3) batch of states."""
    F = tfi.bls12_381_fr()
    host = PoseidonHost(F.p)
    vals = rand_ints(F.p, 15, 23)[:18]
    state = F.encode(vals, device="cpu").reshape(2, 3, 3, F.L)
    got = PoseidonDevice(F).permute(state)
    rows = [vals[3 * i : 3 * i + 3] for i in range(6)]
    assert F.decode(got.reshape(-1, F.L)) == [v for r in rows for v in host.permute(r)]


@pytest.mark.parametrize("n", [8, 64])
def test_device_tree_equals_host_tree(n):
    F = tfi.bls12_381_fr()
    rng = random.Random(131 + n)
    leaves = [rng.randrange(F.p) for _ in range(n)]
    got = merkle.build_tree_device(F, PoseidonDevice(F), leaves, device="cpu")
    want = jmerkle.build_tree_host(JPoseidonHost(F.p), leaves)
    assert got.root == want.root
    assert got.levels == want.levels
    assert merkle.build_tree_host(PoseidonHost(F.p), leaves).levels == want.levels
    for idx in (0, n - 1):
        assert merkle.MerkleTree.verify_host(PoseidonHost(F.p), got.root, idx, leaves[idx], got.path(idx))


def test_device_tree_under_mxu(monkeypatch):
    monkeypatch.setenv("ZKCP_MXU", "1")
    F = tfi.bls12_381_fr()
    leaves = list(range(3, 11))
    got = merkle.build_tree_device(F, PoseidonDevice(F), leaves, device="cpu")
    assert got.root == jmerkle.build_tree_host(JPoseidonHost(F.p), leaves).root


def test_sample_entries_verifier_root(tmp_path):
    """The buyer's step-0 root: ZkSampleEntries.prepare_public_inputs over
    a hosted ciphertext, by the device tree at 512 blocks (the size where
    the reference switches to it), equals the host tree's root."""
    from contangle_zkcp_tpu_torch.circuits import elgamal
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.zkcp.sample_entries import ZkSampleEntries
    from contangle_zkcp_tpu_torch.zkcp.zk_encryption import ciphertext_to_bytes

    n = 512
    se = ZkSampleEntries(tmp_path, n, backend="mock", device="cpu")
    params = elgamal.ElGamalParams(curve=ci.JUBJUB, n=n)
    rng = random.Random(133)
    sk, pk = elgamal.keygen(params, rng)
    cipher = elgamal.encrypt(params, pk, [rng.randrange(256) for _ in range(n)],
                             elgamal.random_scalar(params, rng))
    [root] = se.prepare_public_inputs(ciphertext_to_bytes(cipher, params))
    assert root == jmerkle.build_tree_host(JPoseidonHost(params.curve.p), cipher[1]).root
    assert torch.get_num_threads() == 1
