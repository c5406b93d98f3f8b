#!/usr/bin/env python3
"""Profile one PoE prove of the PyTorch/CUDA port on the GPU.

    python3 scripts/profile_torch_prove.py [--blocks N] [--seed S]

Compiles ZkEncryption at N blocks (default 49,152), warms up with one
encrypt + prove, then traces a second one with torch.profiler (CPU and
CUDA activities; utils/profiling.py `trace`, which writes a Chrome trace
to contangle_zkcp_tpu_torch/build/trace/trace.json) and prints, one line
each: the wall time of the traced call, the device time summed over all
kernels, the device's idle share (1 - busy / wall, with overlapping
kernels merged), and the ten kernels with the most device time.  Needs a
CUDA device; exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def busy_seconds(events) -> float:
    """Union of the device kernels' [start, end) intervals, in seconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6  # microseconds -> s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=49152)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_prove: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from contangle_zkcp_tpu_torch.circuits import elgamal
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.utils import profiling
    from contangle_zkcp_tpu_torch.zkcp.zk_encryption import ZkEncryption

    build_dir = os.path.join(ROOT, "contangle_zkcp_tpu_torch", "build", "profile_zk")
    shutil.rmtree(build_dir, ignore_errors=True)
    rng = random.Random(args.seed)
    zk = ZkEncryption(build_dir, params=elgamal.ElGamalParams(curve=ci.JUBJUB, n=args.blocks))
    zk.compile(rng)
    sk, pk = zk.keygen(rng)
    msg = chip_smoke.message(args.blocks, args.seed)
    zk.encrypt(msg, pk, rng)  # warm-up: caches, allocator, twiddle tables
    torch.cuda.synchronize()

    with profiling.trace() as prof:
        t0 = time.time()
        cipher, proof = zk.encrypt(msg, pk, rng)
        torch.cuda.synchronize()
        wall = time.time() - t0
    if not zk.verify_proof(proof, cipher):
        raise AssertionError("traced proof rejected")
    events = prof.events()
    busy = busy_seconds(events)
    print(f"[profile] {torch.cuda.get_device_name(0)}; {chip_smoke.nvidia_smi()}", flush=True)
    print(f"[profile] encrypt + prove wall {wall:.3f} s, device busy {busy:.3f} s, "
          f"idle share {1 - busy / wall:.3f}", flush=True)
    per = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    print(f"[profile] Chrome trace: {os.path.join(profiling.TRACE_DIR, 'trace.json')}", flush=True)
    print("[profile] top kernels (s): " + json.dumps([[k[:60], round(v, 4)] for k, v in top]),
          flush=True)
    shutil.rmtree(build_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
