"""Spawned gloo ranks for the port's parallel/ tests.

`spawn(fn, D, *args)` starts D CPU processes, each joining a gloo group
of world size D through a `file://` store (no network) and calling
fn(mesh, *args); it returns the ranks' results in rank order.  It joins
with a deadline and raises when a rank fails or the deadline passes, so
a hung collective fails its test.  The workers import torch and the port
only (never JAX: the test bodies hold the JAX side), one torch thread a
rank.
"""

import datetime
import os
import pickle
import tempfile
import time

import numpy as np
import torch.multiprocessing as mp

DEADLINE_S = 240
GROUP_TIMEOUT_S = 45


def _rank_main(rank, D, store, out_dir, fn, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=D, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        from contangle_zkcp_tpu_torch.parallel.mesh import make_mesh

        res = fn(make_mesh(D, device="cpu"), *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, D, *args, deadline_s=DEADLINE_S):
    with tempfile.TemporaryDirectory(prefix="zkcp_ranks_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(D, os.path.join(tmp, "store"), tmp, fn, args),
                                 nprocs=D, join=False, start_method="spawn")
        end = time.time() + deadline_s
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, end - time.time()))):
                if time.time() > end:
                    raise TimeoutError(f"{D} ranks did not finish in {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(D):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ----------------------------------------------------------------- workers
def sharded_msm(mesh, pts, scalars, c):
    """ShardedMSM's run and run_scheduled, unsigned and signed, on the
    global points and scalars: {(route, signed): host point}."""
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.ops.msm import MSM
    from contangle_zkcp_tpu_torch.parallel import ShardedMSM

    dev = SWDevice(fi.bls12_381_fq(), ci.BLS12_381_G1, device="cpu")
    out = {}
    for signed in (False, True):
        sm = ShardedMSM(MSM(dev, scalar_bits=255, c=c, signed=signed), mesh)
        out[("run", signed)] = sm.run(pts, scalars)
        out[("run_scheduled", signed)] = sm.run_scheduled(pts, scalars)
    return out


def four_step(mesh, limbs, n):
    """FourStepNTT.forward of the global (n, 16) Montgomery limbs."""
    import torch

    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.parallel.ntt_sharded import FourStepNTT, ShardedNTT
    from contangle_zkcp_tpu_torch.ops.ntt import NTT

    F = fi.bls12_381_fr()
    a = torch.from_numpy(np.asarray(limbs, dtype=np.int32))
    got = FourStepNTT(F, n, mesh).forward(a)
    sh = ShardedNTT(NTT(F, n, device="cpu"), mesh)
    ev = sh.forward(sh.shard(a))
    back = mesh.gather(sh.inverse(ev))
    return got.numpy(), mesh.gather(ev).numpy(), back.numpy()


def mesh_fold(mesh, seeds, n_blocks):
    """MeshFoldPipeline over the port's mini_poe_cs instances: the
    accumulator's fields, whether it checks, and whether a witness with
    w[0] + 1 is rejected."""
    from contangle_zkcp_tpu_torch.circuits.poe_shape import mini_poe_cs
    from contangle_zkcp_tpu_torch.groth16.folding import FoldingScheme
    from contangle_zkcp_tpu_torch.parallel.fold_pipeline import MeshFoldPipeline

    css = [mini_poe_cs(n_blocks, s) for s in seeds]
    scheme = FoldingScheme(css[0], device="cpu")
    lifted = [scheme.instance_from_cs(cs) for cs in css]
    pipe = MeshFoldPipeline(scheme, mesh)
    inst, wit = pipe.fold_stream(lifted)
    acc = dict(comm_w=inst.comm_w, comm_e=inst.comm_e, u=inst.u, x=list(inst.x),
               w=list(wit.w), e=list(wit.e), ok=scheme.check(inst, wit), n_pts=pipe.n_pts)
    wit.w[0] = (wit.w[0] + 1) % scheme.p
    acc["tampered_ok"] = scheme.check(inst, wit)
    return acc
