"""The port's parallel/ across spawned gloo ranks on the CPU (the
multi-rank exchanges the card runs at world size 1): `ShardedMSM` (both
routes, signed and unsigned) against `msm_host` at D = 4 and 8 with an
all-zero shard; `FourStepNTT` and `ShardedNTT` at D = 4 against the JAX
package's four-step NTT on a 4-device mesh; `MeshFoldPipeline` at D = 4,
bases padded to a multiple of D, against the JAX package's sequential
fold tree.  The ranks (tests/torch_parallel_ranks.py) import no JAX;
JAX runs here, in the test bodies.  No JAX MSM is compiled."""

import random

import numpy as np
import pytest

from tests import torch_parallel_ranks as ranks
from tests.torch_port_util import one_torch_thread, rand_ints  # noqa: F401


@pytest.mark.parametrize("D", [4, 8])
def test_sharded_msm_across_ranks(D):
    from contangle_zkcp_tpu.curves import instances as jci
    from contangle_zkcp_tpu.ops.msm import msm_host

    C = jci.BLS12_381_G1
    rng = random.Random(70 + D)
    n = 64
    pts = [C.mul(rng.randrange(1, C.order), C.generator) for _ in range(n)]
    sc = [rng.randrange(C.order) for _ in range(n)]
    sc[0], sc[1] = 0, 1
    zero = slice(n // D, 2 * n // D)  # rank 1's shard: all zero
    sc[zero] = [0] * (n // D)
    want = msm_host(C, pts, sc)
    for out in ranks.spawn(ranks.sharded_msm, D, pts, sc, 4):
        assert out == {(r, s): want for r in ("run", "run_scheduled") for s in (False, True)}


def test_four_step_ntt_across_ranks():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from contangle_zkcp_tpu.fields import instances as jfi
    from contangle_zkcp_tpu.ops.ntt import NTT as JNTT
    from contangle_zkcp_tpu.parallel.ntt_sharded import FourStepNTT as JFourStep

    F, n, D = jfi.bls12_381_fr(), 256, 4
    a = np.asarray(F.encode(rand_ints(F.p, n - 3, seed=91)))
    mesh = Mesh(np.array(jax.devices()[:D]), ("x",))
    want = np.asarray(JFourStep(F, n, mesh, axis="x").forward(jnp.asarray(a)))
    assert np.array_equal(want, np.asarray(JNTT(F, n).forward(jnp.asarray(a))))
    for four, sharded, back in ranks.spawn(ranks.four_step, D, a, n):
        np.testing.assert_array_equal(four, want)
        np.testing.assert_array_equal(sharded, want)
        np.testing.assert_array_equal(back, a)


def test_mesh_fold_across_ranks():
    from contangle_zkcp_tpu.groth16.folding import FoldingScheme
    from tests.test_folding import _mini_poe_cs

    seeds, D = (11, 22, 33, 44), 4
    css = [_mini_poe_cs(4, s) for s in seeds]
    scheme = FoldingScheme(css[0])
    level = [scheme.instance_from_cs(cs) for cs in css]
    while len(level) > 1:
        nxt = [scheme.fold(*level[i], *level[i + 1]) for i in range(0, len(level) - 1, 2)]
        level = nxt + level[len(nxt) * 2:]
    inst, wit = level[0]
    assert len(scheme.bases_e) % D  # the pipeline pads the bases
    for acc in ranks.spawn(ranks.mesh_fold, D, seeds, 4):
        assert acc["n_pts"] == -(-len(scheme.bases_e) // D) * D
        assert (acc["comm_w"], acc["comm_e"], acc["u"], acc["x"]) == (inst.comm_w, inst.comm_e,
                                                                      inst.u, list(inst.x))
        assert (acc["w"], acc["e"]) == (list(wit.w), list(wit.e))
        assert acc["ok"] and not acc["tampered_ok"]
