#!/usr/bin/env python3
"""Time the tensor-core kernels of several checkouts of the port in turns,
on one NVIDIA GPU.

    python3 scripts/time_k5.py [--prove] [--blocks N] [--out FILE] ROOT [ROOT ...]

Each ROOT is a directory holding a `contangle_zkcp_tpu_torch` package (this
checkout, `git archive` of an older commit, a variant of a kernel).  The
roots' kernels are first built all together, one process each; then one
process per ROOT, in the order given (name a root twice to time it twice:
parent, change, change, parent), times on the same inputs, made from one
seed:

  * K5a (`mont_mul_mma`) at Fr and Fq n = 2^18 and BW6-761 Fq n = 2^16,
    checked equal to K1, with K1 beside it;
  * one NTT transform under ZKCP_MXU=1 (whatever route the package takes:
    the one-stage K5b loop, or K5b's passes) at Fr n = 2^18, 2^15, 2^13,
    forward, checked equal to the default configuration's transform; and
    the default configuration's transform (k2_ntt_pass) at Fr n = 2^18
    and Pasta Fp n = 2^15 coset_forward;
  * the unchanged kernels K1, the one-stage K2 and K5b (Fr n/2 = 2^17),
    K3 and K5c (G1 n = 2^16, arbitrary canonical triples), for the spread;

each as the median of five batches of CUDA-graph replays (CUDA events,
chip_smoke.py cuda_ms).  With `--prove` a process instead compiles the
Proof of Encryption at N blocks (default 49,152) in the default
configuration and proves it twice under ZKCP_MXU=1, reporting each
prove's seconds and its `groth16.prove.ntt_h`.  Prints one JSON line a
process and a table; `--out` writes all records as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker_kernels(seed: int) -> dict:
    import numpy as np
    import torch

    from chip_smoke import cuda_ms, random_field
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.ops import curve_add, mont, mont_mma
    from contangle_zkcp_tpu_torch.ops.ntt import NTT

    rng = np.random.default_rng(seed)
    out = {}
    for name, F, n in (("fr", fi.bls12_381_fr(), 1 << 18), ("fq", fi.bls12_381_fq(), 1 << 18),
                       ("bw6", fi.bw6_761_fq(), 1 << 16)):
        a, b = random_field(F, n, rng), random_field(F, n, rng)
        if not torch.equal(mont_mma.mont_mul_mma(F, a, b), mont.mont_mul(F, a, b)):
            raise AssertionError(f"K5a != K1 at {name}")
        out[f"k5a_{name}"] = cuda_ms(lambda: mont_mma.mont_mul_mma(F, a, b), 100, graph=True)
        out[f"k1_{name}"] = cuda_ms(lambda: mont.mont_mul(F, a, b), 100, graph=True)

    Fr = fi.bls12_381_fr()
    for logn in (18, 15, 13):
        ntt = NTT(Fr, 1 << logn, device="cuda")
        x = random_field(Fr, 1 << logn, rng)
        want = ntt.forward(x)
        os.environ["ZKCP_MXU"] = "1"
        try:
            if not torch.equal(ntt.forward(x), want):
                raise AssertionError(f"ZKCP_MXU=1 transform != the default's at 2^{logn}")
            out[f"mxu_ntt_fr_2e{logn}"] = cuda_ms(lambda: ntt.forward(x), 10, graph=True)
        finally:
            os.environ.pop("ZKCP_MXU", None)
        if logn == 18:
            out["k2_ntt_fr_2e18"] = cuda_ms(lambda: ntt.forward(x), 20, graph=True)
    Fp = fi.pasta_fp()
    ntt = NTT(Fp, 1 << 15, device="cuda")
    x = random_field(Fp, 1 << 15, rng)
    out["k2_ntt_pasta_2e15_coset_forward"] = cuda_ms(lambda: ntt.coset_forward(x, 5), 20, graph=True)

    u, v, tw = (random_field(Fr, 1 << 17, rng) for _ in range(3))
    out["k2_fr"] = cuda_ms(lambda: mont.butterfly(Fr, u, v, tw), 100, graph=True)
    out["k5b_fr"] = cuda_ms(lambda: mont_mma.butterfly_mma(Fr, u, v, tw), 100, graph=True)
    Fq = fi.bls12_381_fq()
    b3m = SWDevice(Fq, ci.BLS12_381_G1, device="cuda")._b3m
    P, Q = (tuple(random_field(Fq, 1 << 16, rng) for _ in range(3)) for _ in range(2))
    out["k3_g1"] = cuda_ms(lambda: curve_add.sw_add(Fq, b3m, P, Q), 40, graph=True)
    out["k5c_g1"] = cuda_ms(lambda: curve_add.sw_add_mma(Fq, b3m, P, Q), 40, graph=True)
    return out


def worker_prove(blocks: int, seed: int) -> dict:
    import torch

    from chip_smoke import message
    from contangle_zkcp_tpu_torch.circuits import elgamal
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.utils import metrics
    from contangle_zkcp_tpu_torch.zkcp.zk_encryption import ZkEncryption

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="time_k5_", dir=os.path.join(ROOT, "build"))
    try:
        rng = random.Random(seed)
        zk = ZkEncryption(tmp, params=elgamal.ElGamalParams(curve=ci.JUBJUB, n=blocks), device="cuda")
        zk.compile(rng)
        _, pk_pt = zk.keygen(rng)
        msg = message(blocks, seed)
        out = {}
        os.environ["ZKCP_MXU"] = "1"
        for rep in range(2):
            metrics.registry().reset()
            t0 = time.time()
            zk.encrypt(msg, pk_pt, rng)
            torch.cuda.synchronize()
            timers = metrics.registry().snapshot()["timers"]
            out[f"encrypt_prove_{rep}"] = time.time() - t0
            out[f"prove_{rep}"] = timers["groth16.prove"]["total_sec"]
            out[f"ntt_h_{rep}"] = timers["groth16.prove.ntt_h"]["total_sec"]
        return out
    finally:
        os.environ.pop("ZKCP_MXU", None)
        shutil.rmtree(tmp, ignore_errors=True)


def worker(args) -> int:
    sys.path.insert(0, os.path.abspath(args.worker))
    sys.path.insert(1, ROOT)  # chip_smoke's timing helpers
    from contangle_zkcp_tpu_torch.ops import cuda_lib

    t0 = time.time()
    cuda_lib.build()
    cuda_lib.lib()
    if args.build_only:
        print(json.dumps({"root": args.worker, "build_s": time.time() - t0}), flush=True)
        return 0
    rec = worker_prove(args.blocks, args.seed) if args.prove else worker_kernels(args.seed)
    print(json.dumps({"root": args.worker, **rec}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkouts to time, in this order")
    ap.add_argument("--prove", action="store_true", help="the ZKCP_MXU=1 PoE prove, not the kernels")
    ap.add_argument("--blocks", type=int, default=49152, help="PoE blocks for --prove (default 49152)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the records as JSON here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    import torch

    if not torch.cuda.is_available():
        print("time_k5: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[time_k5] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    base = [sys.executable, os.path.abspath(__file__), "--seed", str(args.seed)]
    roots = list(dict.fromkeys(args.roots))
    builds = [subprocess.Popen(base + ["--worker", r, "--build-only"], stdout=subprocess.PIPE,
                               text=True) for r in roots]
    for r, p in zip(roots, builds):
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"time_k5: the build of {r} failed")
        print(f"[time_k5] built {r}: {out.strip()}", flush=True)
    recs = []
    extra = ["--prove", "--blocks", str(args.blocks)] if args.prove else []
    for r in args.roots:
        res = subprocess.run(base + ["--worker", r] + extra, stdout=subprocess.PIPE, text=True)
        if res.returncode:
            raise SystemExit(f"time_k5: {r} failed ({res.returncode})")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    keys = [k for k in recs[0] if k != "root"]
    names = [os.path.basename(os.path.normpath(r["root"])) or r["root"] for r in recs]
    print("[time_k5] " + " | ".join(["ms" if not args.prove else "s"] + names), flush=True)
    for k in keys:
        print(f"[time_k5] {k} | " + " | ".join(f"{r.get(k, float('nan')):.4f}" for r in recs),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "records": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
