"""The port's parallel/ in one process (a gloo group of world size 1) and
its batched NTT passes, against the JAX package: the batched passes'
twins (K2's, and K5b's under ZKCP_MXU=1) against one transform at a time,
`forward_batched`/`inverse_batched` against the JAX package's, the
four-step and sharded NTTs against the JAX `NTT.forward`, `ShardedMSM`
against `msm_host`, `MeshFoldPipeline` against the sequential fold, and
the mesh's device and backend.  The multi-rank exchanges are
tests/test_torch_zz_parallel_ranks.py; the batched kernels on the card,
tests/test_torch_cuda.py.  Seconds."""

import functools
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from contangle_zkcp_tpu.curves import instances as jci
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu.ops.msm import msm_host
from contangle_zkcp_tpu.ops.ntt import NTT as JNTT
from contangle_zkcp_tpu_torch.circuits.poe_shape import mini_poe_cs
from contangle_zkcp_tpu_torch.curves import instances as tci
from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.groth16.folding import FoldingScheme
from contangle_zkcp_tpu_torch.ops import mont, mont_mma
from contangle_zkcp_tpu_torch.ops.msm import MSM
from contangle_zkcp_tpu_torch.ops.ntt import NTT
from contangle_zkcp_tpu_torch.parallel import ShardedMSM, ShardedNTT, make_mesh, replicated, shard_along
from contangle_zkcp_tpu_torch.parallel.fold_pipeline import MeshFoldPipeline
from contangle_zkcp_tpu_torch.parallel.mesh import backend_for
from contangle_zkcp_tpu_torch.parallel.ntt_sharded import FourStepNTT

from tests.torch_port_util import one_torch_thread, rand_ints  # noqa: F401


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh(device="cpu")
    yield m
    m.close()


def batch(F, B, n, seed):
    xs = rand_ints(F.p, B * n - 3, seed=seed)
    return F.encode(xs, device="cpu").reshape(B, n, F.L)


@pytest.mark.parametrize("twin", ["k2", "k5b"])
@pytest.mark.parametrize("n", [16, 1024])
def test_batched_pass_twins_equal_single_transforms(twin, n):
    """Each pass of the plan on a (3, n, L) batch, with the gather, a
    per-position pre and a scalar or per-position post, equal to the same
    pass on each transform alone."""
    plain = mont.ntt_pass_plain if twin == "k2" else mont_mma.ntt_pass_mma_plain
    F = tfi.bls12_381_fr()
    ntt = NTT(F, n, device="cpu")
    a = batch(F, 3, n, seed=n)
    for op in ("forward", "coset_inverse", "inverse"):
        table, _, post = ntt.pass_operands(op, 7)
        pre = ntt.pass_operands("coset_forward", 5)[1]
        x, last = a, len(ntt.plan) - 1
        for i, (s0, t) in enumerate(ntt.plan):
            kw = dict(pre=pre if i == 0 else None, post=post if i == last else None, gather=i == 0)
            got = plain(F, x, table, s0, t, **kw)
            want = torch.stack([plain(F, x[b], table, s0, t, **kw) for b in range(3)])
            assert torch.equal(got, want), (op, s0, t)
            x = got


def test_batched_wrappers_and_checks(monkeypatch):
    """forward_batched/inverse_batched equal one transform at a time, in
    the default configuration and under ZKCP_MXU=1; bad shapes raise."""
    F, n = tfi.bls12_381_fr(), 64
    ntt = NTT(F, n, device="cpu")
    a = batch(F, 4, n, seed=3)
    for mxu in (False, True):
        if mxu:
            monkeypatch.setenv("ZKCP_MXU", "1")
        fwd = ntt.forward_batched(a)
        assert torch.equal(fwd, torch.stack([ntt.forward(x) for x in a]))
        assert torch.equal(ntt.inverse_batched(fwd), a)
    with pytest.raises(ValueError):
        ntt.forward_batched(a[0])  # (n, L): not a batch
    with pytest.raises(ValueError):
        ntt.forward_batched(a[:, : n // 2])
    with pytest.raises(ValueError):
        mont.ntt_pass(F, torch.zeros(0, n, F.L, dtype=torch.int32), ntt._tw_fwd_w, 0, 6, gather=True)
    with pytest.raises(ValueError):
        mont.ntt_pass(F, a.transpose(0, 1), ntt._tw_fwd_w, 0, 6, gather=True)  # not contiguous


@functools.lru_cache(maxsize=None)
def jax_ntt(n, B, seed):
    """The JAX package's forward and inverse on B transforms of n (B = 0:
    NTT.forward on one), with the values."""
    jF = jfi.bls12_381_fr()
    xs = rand_ints(jF.p, max(B, 1) * n - 3, seed=seed)
    jn, ja = JNTT(jF, n), jnp.asarray(jF.encode(xs))
    if not B:
        return xs, np.asarray(jn.forward(ja))
    ja = ja.reshape(B, n, jF.L)
    return xs, np.asarray(jn.forward_batched(ja)), np.asarray(jn.inverse_batched(ja))


@pytest.mark.parametrize("mxu", [False, True])
def test_batched_ntt_matches_jax(mxu, monkeypatch):
    tF, B, n = tfi.bls12_381_fr(), 4, 16
    if mxu:
        monkeypatch.setenv("ZKCP_MXU", "1")
    xs, fwd, inv = jax_ntt(n, B, 41)
    ta = tF.encode(xs, device="cpu").reshape(B, n, tF.L)
    tn = NTT(tF, n, device="cpu")
    np.testing.assert_array_equal(tn.forward_batched(ta).numpy(), fwd)
    np.testing.assert_array_equal(tn.inverse_batched(ta).numpy(), inv)


@pytest.mark.parametrize("n,n1,split", [(64, None, (8, 8)), (64, 4, (4, 16)), (4, None, (2, 2))])
def test_four_step_and_sharded_ntt_match_jax(mesh, n, n1, split):
    tF = tfi.bls12_381_fr()
    xs, want = jax_ntt(n, 0, n + 7)
    a = tF.encode(xs, device="cpu")
    four = FourStepNTT(tF, n, mesh, n1=n1)
    assert (four.n1, four.n2) == split
    np.testing.assert_array_equal(four.forward(a).numpy(), want)
    sh = ShardedNTT(NTT(tF, n, device="cpu"), mesh)
    ev = sh.forward(sh.shard(a))
    np.testing.assert_array_equal(ev.numpy(), want)
    assert torch.equal(sh.inverse(ev), a)


@pytest.mark.parametrize("signed", [False, True])
def test_sharded_msm_matches_msm_host(mesh, signed):
    """run and run_scheduled at D = 1, scalars 0 and 1 among them, and an
    all-zero vector (the identity)."""
    jC = jci.BLS12_381_G1
    rng = random.Random(72 + signed)
    n = 48
    pts = [jC.mul(rng.randrange(1, jC.order), jC.generator) for _ in range(n)]
    sc = [rng.randrange(jC.order) for _ in range(n)]
    sc[0], sc[1], sc[2] = 0, 1, jC.order - 1
    want = msm_host(jC, pts, sc)
    dev = SWDevice(tfi.bls12_381_fq(), tci.BLS12_381_G1, device="cpu")
    sm = ShardedMSM(MSM(dev, scalar_bits=255, c=4, signed=signed), mesh)
    assert sm.run(pts, sc) == want
    assert sm.run_scheduled(pts, sc) == want
    assert sm.run(pts, [0] * n) is None


def test_mesh_fold_pipeline_single_rank(mesh):
    """The mesh tree fold at D = 1 equals the port's sequential tree."""
    css = [mini_poe_cs(4, s) for s in (11, 22, 33)]
    scheme = FoldingScheme(css[0], device="cpu")
    lifted = [scheme.instance_from_cs(cs) for cs in css]
    pipe = MeshFoldPipeline(scheme, mesh)
    inst, wit = pipe.fold_stream(lifted)
    i01, w01 = scheme.fold(*lifted[0], *lifted[1])
    inst_h, wit_h = scheme.fold(i01, w01, *lifted[2])
    assert (inst.comm_w, inst.comm_e, inst.u, inst.x) == (inst_h.comm_w, inst_h.comm_e, inst_h.u, inst_h.x)
    assert (wit.w, wit.e) == (wit_h.w, wit_h.e)
    assert pipe.n_pts == len(scheme.bases_e)
    assert scheme.check(inst, wit)


def test_mesh_device_and_backend(mesh):
    assert (backend_for("cpu"), backend_for("cuda"), backend_for("cuda:0")) == ("gloo", "nccl", "nccl")
    assert (mesh.size, mesh.rank, mesh.backend, mesh.device.type, mesh.axis) == (1, 0, "gloo", "cpu", "points")
    with pytest.raises(RuntimeError):
        make_mesh(device="cuda")  # no card here, or a gloo group: never a fallback
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")
    again = make_mesh(1, device="cpu")  # joins the existing group
    assert again.size == 1 and again._store_dir is None
    x = torch.arange(24, dtype=torch.int32).reshape(4, 3, 2)
    assert torch.equal(mesh.gather(x), x)
    assert torch.equal(mesh.all_to_all(x, split_axis=1, concat_axis=0), x)
    assert torch.equal(shard_along(mesh).place(x), x) and torch.equal(replicated(mesh).place(x), x)
    with pytest.raises(ValueError):
        shard_along(mesh, "x")
    with pytest.raises(ValueError):
        ShardedMSM(None, mesh, axis="rows")
