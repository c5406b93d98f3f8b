#!/usr/bin/env python3
"""Run the port's parallel/ paths across the GPUs of one host, one NCCL
rank a card, and time them against one rank.

    python3 scripts/parallel_ranks.py [--ranks D [D ...]] [--seed S] [--fold-blocks N]

For each D (default: 1, then every card the host has) the script spawns D
processes; each sets its card (rank r takes cuda:r), joins an NCCL group of
world size D through a `file://` store in a temporary directory (no
network; NCCL_SOCKET_IFNAME=lo unless set), and on the same inputs, made
from one seed on every rank:

  * ShardedMSM (parallel/msm_sharded.py) `run` and `run_scheduled` on the
    PoE's H query: 262,143 G1 points k_i G from the card's fixed-base
    multiplier with witness-like scalars (half 0/1 bits), padded with the
    identity and zero scalars to a multiple of D, on the policy's window
    (c = 16, signed); each run equal to the exact host sum (sum s_i k_i) G,
    after a checked warm-up on a 4,096-point slice;
  * FourStepNTT (parallel/ntt_sharded.py) at Fr 2^18 equal to the one-card
    NTT.forward limb for limb, and ShardedNTT's forward and inverse
    round-tripping;
  * MeshFoldPipeline over chip_smoke.py's four PoE-shaped instances of
    --fold-blocks blocks (bases padded to a multiple of D), its
    accumulator equal to the sequential tree's and its comm_T too.

Each rank times its own calls (host clock after a synchronize; the
four-step and NTT.forward by CUDA events); rank 0 prints one line a step
with the slowest rank's time, then one JSON line for the run.  A rank that
fails or a run past its deadline raises, and every process is stopped.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import random
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 900


def rank_main(rank: int, D: int, store: str, seed: int, fold_blocks: int) -> None:
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}", world_size=D, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    quiet = open(os.devnull, "w") if rank else None
    try:
        with contextlib.redirect_stdout(quiet) if quiet else contextlib.nullcontext():
            drive(D, seed, fold_blocks)
    finally:
        dist.destroy_process_group()
        if quiet:
            quiet.close()


def drive(D: int, seed: int, fold_blocks: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from chip_smoke import check, cuda_ms, fold_for_mesh, log, random_field
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.fields.bigint import ints_to_limbs
    from contangle_zkcp_tpu_torch.ops.fixed_base import FixedBaseDevice
    from contangle_zkcp_tpu_torch.ops.msm import MSM
    from contangle_zkcp_tpu_torch.ops.msm_policy import msm_config
    from contangle_zkcp_tpu_torch.ops.ntt import NTT
    from contangle_zkcp_tpu_torch.parallel import ShardedMSM, ShardedNTT
    from contangle_zkcp_tpu_torch.parallel.mesh import make_mesh
    from contangle_zkcp_tpu_torch.parallel.ntt_sharded import FourStepNTT

    mesh = make_mesh(D, device="cuda")
    tag = f"[ranks D={D}]"
    out = {"ranks": D, "device": torch.cuda.get_device_name(mesh.device)}

    def slowest(x: float) -> float:
        got = [None] * D
        dist.all_gather_object(got, x)
        return max(got)

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, slowest((time.time() - t0) * 1e3)

    # ---- ShardedMSM on the H query
    C, R = ci.BLS12_381_G1, fi.BLS12_381_R
    dev = SWDevice(fi.bls12_381_fq(), C, device=mesh.device)
    rng = random.Random(seed + 17)
    n = 262143
    ks = [rng.randrange(1, R) for _ in range(n)]
    sc = [rng.randrange(R) if rng.random() < 0.5 else rng.randrange(2) for _ in range(n)]
    pad = -(-n // D) * D - n
    pts = FixedBaseDevice(dev, C.generator, R.bit_length(), chunk=1 << 16).mul_ints(ks)
    pts = {k: torch.cat([v, dev.identity((pad,))[k]]) for k, v in pts.items()}
    limbs = ints_to_limbs(sc + [0] * pad, 16)
    want = dev.host_mul(sum(s * k for s, k in zip(sc, ks)) % R, C.generator)
    cut = 4096
    want_cut = dev.host_mul(sum(s * k for s, k in zip(sc[:cut], ks[:cut])) % R, C.generator)
    cfg = msm_config("g1", n)
    sharded = ShardedMSM(MSM(dev, 255, c=cfg.c, signed=cfg.signed), mesh)
    for name, fn in (("run", sharded.run), ("run_scheduled", sharded.run_scheduled)):
        if fn({k: v[:cut] for k, v in pts.items()}, limbs[:cut]) != want_cut:
            raise AssertionError(f"{tag} ShardedMSM.{name} on a {cut}-point slice != the exact sum")
        torch.cuda.reset_peak_memory_stats()
        got, ms = timed(lambda: fn(pts, limbs))
        if got != want:
            raise AssertionError(f"{tag} ShardedMSM.{name} g1 n={n + pad}: != the exact host sum")
        peak = slowest(torch.cuda.max_memory_allocated() / 2**30)
        out[f"msm_{name}_ms"] = ms
        log(f"{tag} ShardedMSM.{name} g1 n={n} + {pad} identities, c={cfg.c} "
            f"signed={cfg.signed}, {(n + pad) // D} points a rank: {ms:.1f} ms (slowest rank), "
            f"equal to the exact host sum; peak {peak:.2f} GiB")
    del pts
    torch.cuda.empty_cache()

    # ---- the four-step and sharded NTTs at Fr 2^18
    F, n = fi.bls12_381_fr(), 1 << 18
    a = random_field(F, n, np.random.default_rng(seed + 19)).to(mesh.device)
    ntt = NTT(F, n, device=mesh.device)
    four = FourStepNTT(F, n, mesh)
    want = ntt.forward(a)
    check("FourStepNTT", four.forward(a), want, "NTT.forward")
    sh = ShardedNTT(ntt, mesh)
    ev = sh.forward(sh.shard(a))
    check("ShardedNTT", mesh.gather(ev), want, "NTT.forward")
    check("ShardedNTT", mesh.gather(sh.inverse(ev)), a, "its input after forward and inverse")
    dist.barrier()
    ms_four = slowest(cuda_ms(lambda: four.forward(a), 10))
    ms_one = slowest(cuda_ms(lambda: ntt.forward(a), 10))
    out.update(four_step_ms=ms_four, ntt_forward_ms=ms_one)
    log(f"{tag} FourStepNTT Fr n=2^{n.bit_length() - 1} (n1 = {four.n1}, n2 = {four.n2}): equal to "
        f"NTT.forward, ShardedNTT round-trips; {ms_four:.4f} ms a call against one card's "
        f"NTT.forward {ms_one:.4f} ms (slowest rank, CUDA events)")

    # ---- the mesh fold of chip_smoke's four instances
    t0 = time.time()
    fold_for_mesh(fold_blocks, seed, mesh)
    out["fold_for_mesh_s"] = slowest(time.time() - t0)
    log(f"{tag} " + json.dumps(out, sort_keys=True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="*", default=None,
                    help="world sizes to run, one after another (default: 1, then every card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fold-blocks", type=int, default=1024)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("parallel_ranks: no CUDA device", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    sizes = args.ranks or sorted({1, cards})
    sys.path.insert(0, ROOT)
    from contangle_zkcp_tpu_torch.ops import cuda_lib

    t0 = time.time()
    cuda_lib.build()  # once, before the ranks load it
    print(f"[ranks] {cards} x {torch.cuda.get_device_name(0)}; kernels built in "
          f"{time.time() - t0:.1f} s", flush=True)
    for D in sizes:
        if D < 1 or D > cards or D & (D - 1):
            print(f"parallel_ranks: {D} ranks on {cards} cards (a power of two, one a card)",
                  file=sys.stderr)
            return 2
    for D in sizes:
        t0 = time.time()
        with tempfile.TemporaryDirectory(prefix="zkcp_ranks_") as tmp:
            ctx = mp.start_processes(rank_main, args=(D, os.path.join(tmp, "store"), args.seed,
                                                      args.fold_blocks),
                                     nprocs=D, join=False, start_method="spawn")
            end = time.time() + DEADLINE_S
            try:
                while not ctx.join(timeout=5):
                    if time.time() > end:
                        raise TimeoutError(f"{D} ranks did not finish in {DEADLINE_S} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
        print(f"[ranks D={D}] done in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
