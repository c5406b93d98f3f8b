#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--blocks N] [--sale-blocks N] [--plonk-rows N] [--fold-blocks N]
                          [--seed S] [--kernels-only | --plonk-only | --msm-only | --fold-only
                          | --parallel-only] [--root DIR]

Phases, one line each as it finishes:
  1. the device: name, torch and CUDA versions, nvidia-smi name and
     power limit;
  2. the build of the hand-written kernels (csrc/*.cu, one nvcc per
     source, all started together, then one link);
  3. each kernel against its plain torch twin on the card, exactly equal,
     at the main path's shapes, with times (CUDA events) and bounds; K4
     and the tensor-core kernels K5a-K5c also equal to K1/K2/K3 on the
     same inputs; the point adds K3 and K5c at n = 2^16 and 2^20, on
     points of the curve and on arbitrary triples; the PLONKish path's
     shapes (K1/K2 on Pasta Fp, K3/K5c on Vesta and Pallas in the strict
     arithmetic) and the W = 24 multiplies and butterflies (BW6-761 Fq);
     K5a also on edge values (0, 1, p - 1, p - 2); the NTT passes, K2's
     (k2_ntt_pass) and the tensor-core K5b's (k5b_ntt_pass, ZKCP_MXU=1),
     against their twins pass by pass and each whole transform against
     its passes, the stage loop and the other kernel's transform (Fr
     n = 2^19, 2^18, 2^15, 2^14, 2^13, Pasta Fp n = 2^15 and 2^12, and
     n = 2, 4, 1024), timed beside the one-stage route each replaced
     (k2_butterfly or k5b_butterfly_mma, with F.mul); both pass kernels on
     batches of transforms (B = 512 of 2^9, B = 4 of 2^18; one launch a
     pass) against their batched twins and B single-transform launches;
     with ptxas's registers and spills (`--kernels-only` stops here);
  4. the MSM engines on the card against the exact host sum msm_host:
     the lockstep engine on a 256-point G1 MSM; BalancedMSM (a 64-lane
     overflow pool, so segments, fold levels and merges run) and TreeMSM
     in G1 and G2, signed and unsigned, over witness-like and uniform
     scalars and duplicate points, P and -P pairs, identity inputs and zero
     scalars;
  5. the [msm] phase: the three engines ("lockstep", "balanced", "tree")
     at the PoE's real shapes (the G1 H query, 262,143 points, with
     witness-like and uniform scalars; the G2 B query, 202,506 points) on
     the policy's window, each held to the exact host sum (whole and on a
     4,096-point slice), lockstep then balanced, one run each, after a
     warm-up call of each engine on the slice (the tree engine, on no
     policy path, only there), with ms, launches, the balanced engine's
     trips and overflow lanes and peak memory (`--msm-only` runs phases
     1, 2, 4 and 5 alone);
  6. the [edwards] phase: 2^16 Jubjub points on the card through a 255-bit
     scalar_mul_ints, add and double (curves/edwards.py, K1), every result
     on the curve after to_affine, 64 of each equal to the host curve;
  7. a small reference: the toy Groth16 circuit of tests/test_groth16.py
     proves to the JAX package's pinned golden bytes;
  8. the Proof of Encryption in the default configuration: ZkEncryption
     at N blocks (default 49,152) — compile (setup), encrypt + prove,
     verify, decrypt, and a tampered input that must be rejected — with
     the kernels' launch counts on that path (K1, k2_ntt_pass, K3; no
     k2_butterfly) and the balanced engine's trips (every MSM of n >= 2^16
     runs on the engine the policy names), then the same prove under
     ZKCP_MXU=1 with its groth16.prove.ntt_h (K5a, k5b_ntt_pass, K5c; no
     k5b_butterfly_mma);
  9. the [property] phase: the circom Proof of Property in the default
     configuration at the same N blocks (one byte a block): the dummy
     property circuit composed with the encryption circuit into one
     Groth16 proof (ZkPropertyVerifier) — compile (the composed setup and
     its key files), encrypt and prove a true property (something =
     plaintext[0], challenge = something^2), verify, decrypt the message
     byte for byte, a tampered ciphertext rejected and a false property
     refused — with the composed system's size, _merge's seconds, the
     prove's groth16.prove.* and msm.* timers, the balanced engine's trips,
     the key files' sizes, peak memory and K1, k2_ntt_pass and K3's
     launches (no k2_butterfly);
  10. the [fold] phase: the folding accumulator and its decider in the
     default configuration (groth16/folding.py, decider.py, ipa_vec.py):
     four satisfied PoE-shaped instances of --fold-blocks blocks (default
     1,024: 1,027 constraints, 2,053 variables, commitments of 1,028 and
     1,027 entries, all on the device MSM), the bases (hashing on the host,
     cofactor clearing on the card), lifting, three folds as a tree, the
     accumulator's check, the decider's bases (padded to 2,048), prove,
     verify and two tampered cases rejected (va + 1, u + 1); every device
     commitment and the first round of both openings held to msm_host in
     host worker processes, 64 device-cleared bases to the host; seconds a
     step, opening rounds, K1 and K3 launches (K3 required; no K5 or
     k2_butterfly), peak memory; then the same four instances tree-folded
     by parallel/'s MeshFoldPipeline (bases sharded once, each level's
     comm_T as one multi-vector MSM, one all-reduce) on an NCCL group of
     world size 1, its accumulator equal to the sequential one, checked,
     its three comm_T equal to msm_host's (`--fold-only` runs phases 1, 2
     and this one alone);
  10b. the [parallel] phase (parallel/ on the same world-size-1 NCCL
     mesh, every local phase at full width): ShardedMSM on the PoE's H
     query (G1, 262,143 points, witness-like scalars, c = 16 signed), run
     and run_scheduled, each equal to the exact host sum and the lockstep
     MSM.run; the four-step NTT at Fr 2^18 (batched column and row passes,
     the twiddle slab made on the card, the transposes as all-to-alls)
     equal to NTT.forward limb for limb, default and ZKCP_MXU=1, and
     ShardedNTT round-tripping; ms, launches, peak memory
     (`--parallel-only` runs phases 1, 2, this one and the mesh fold of
     [fold]'s instances against their sequential tree);
  11. the whole sale under ZKCP_MXU=1 (the tensor-core configuration) at
     N blocks (default 65,536): compile the three circuits, seller step 0
     (PoE + SampleEntries proof), buyer step 0 (verify, with the device
     Poseidon Merkle root), step 1 (key encryption), step 2 (adaptor
     signature), step 3 (broadcast on MockChain), step 4 (recover the key,
     decrypt), with the provers' NTT domains, over the local HTTP server
     and client, every proof real Groth16; the plaintext must come back
     byte for byte, the seller must
     be paid, a tampered adaptor signature must be refused, and K5a,
     k5b_ntt_pass and K5c must launch while K1-K3 (k2_ntt_pass and
     k2_butterfly) and the one-stage k5b_butterfly_mma do not;
  12. the PLONKish path held exactly to the CPU: the n = 128 ElGamal
     circuit's key and proof (one blinding seed) on the card equal the
     same calls on the CPU (the kernels' twins), and an IPA(1024)
     opening with the device generator fold equals the host fold's;
  13. the halo2-path PLONKish prover in the default configuration: the
     ElGamal circuit over Pallas at 4,096 rows (the reference's k = 12),
     setup (8,192 IPA generators), two proves, verify, a tampered
     instance refused, with K1, k2_ntt_pass and K3's launch counts (K3 on
     Vesta in the strict arithmetic).  `--plonk-only` runs phases 1, 2 and
     13 alone, and `--root DIR` takes the port package from another
     checkout (DIR/contangle_zkcp_tpu_torch): together they time the
     prover of two trees after the same preceding work.
Prints the kernels' JSON line and the card's name and power limit, then
`{"ok": true, "device": {...}}` as the last line.  Any failure raises and
exits nonzero; without a CUDA device it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# The kernels' work counts (bytes, integer and tensor-core operations),
# the H100's peak rates and `bound` live in the port's utils/profiling.py;
# each phase imports them after main() has put the package on the path.


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def cuda_ms(fn, reps: int, batches: int = 5, graph: bool = False) -> float:
    """Per-call time: the median over `batches` batches of `reps` calls,
    each batch timed by CUDA events, after a warm-up.  With `graph` the
    `reps` calls are captured once into a CUDA graph that each batch
    replays, so the time is the device's alone: a kernel of a few tens of
    microseconds costs about as much again in its Python wrapper's launch."""
    fn()  # warm-up
    torch.cuda.synchronize()
    run, per_batch = fn, reps
    if graph:
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run, per_batch = g.replay, 1
    per = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            run()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return float(np.median(per))


def random_field(F, n: int, rng):
    """n canonical elements: random limbs, top limb below p's top limb."""
    arr = rng.integers(0, 1 << 16, size=(n, F.L), dtype=np.int64)
    arr[:, -1] = rng.integers(0, int(F.p_limbs[-1]), size=n)
    return torch.from_numpy(arr.astype(np.int32)).cuda()


def max_abs_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ------------------------------------------------------------ kernel checks
def ptxas_summary() -> str:
    """Registers and spills of the point-add kernels (every instance), of
    the W = 24 instances of K1, K2 and the one-stage K5b, of every K5a
    instance and of the NTT passes' kernels (k2_ntt_pass, k5b_ntt_pass),
    from the build's `-Xptxas -v` report."""
    from contangle_zkcp_tpu_torch.ops import cuda_lib

    out, cur, spill = [], None, ""
    for line in cuda_lib.ptxas_log().splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(k3_kernel|k5c_kernel)ILi(\d+)ELi(\d+)ELb([01])E", line)
        if m:
            arith = "strict" if m.group(4) == "1" else "lazy"
            cur = f"{m.group(1)}<{m.group(2)},{m.group(3)},{arith}>"
            continue
        m = re.search(r"Compiling entry function '_Z\d+(k1_kernel|k2_kernel|k5b_kernel)ILi(24)E", line)
        m = m or re.search(r"Compiling entry function '\S*?(k2_ntt_kernel|k5b_ntt_kernel|k5a_kernel)ILi(\d+)E", line)
        if m:
            cur = f"{m.group(1)}<{m.group(2)}>"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if cur and m:
            spill = f"stack {m.group(1)} B, spill stores {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            out.append(f"{cur} {m.group(1)} registers, {spill}")
            cur = None
    return "; ".join(out) or "no report"


def curve_batch(dev, C, Fq, n, rng):
    """Valid G1 points in random projective scalings, with identity on
    either side, P + P and P + (-P) among the pairs; returns (P, Q, a
    host spot-check of the sums)."""
    base, acc = [], None
    for _ in range(256):
        acc = C.add(acc, C.generator)
        base.append(acc)
    pts = dev.encode_points(base)
    i1 = torch.from_numpy(rng.integers(0, 256, size=n)).cuda()
    i2 = torch.from_numpy(rng.integers(0, 256, size=n)).cuda()
    P = {k: v.index_select(0, i1) for k, v in pts.items()}
    Q = {k: v.index_select(0, i2) for k, v in pts.items()}
    Q["x"][: n // 8] = P["x"][: n // 8]  # P + P
    Q["y"][: n // 8] = P["y"][: n // 8]
    Q["x"][n // 8 : n // 4] = P["x"][n // 8 : n // 4]  # P + (-P)
    Q["y"][n // 8 : n // 4] = Fq.neg(P["y"][n // 8 : n // 4])
    for X in (P, Q):
        lam = random_field(Fq, n, rng)
        X.update({k: Fq.mul(X[k], lam) for k in ("x", "y", "z")})
    ident = dev.identity((n // 8,))
    for k in ("x", "y", "z"):
        P[k][n // 4 : 3 * n // 8] = ident[k]  # O + Q
        Q[k][3 * n // 8 : n // 2] = ident[k]  # P + O
    Pt = tuple(P[k].contiguous() for k in ("x", "y", "z"))
    Qt = tuple(Q[k].contiguous() for k in ("x", "y", "z"))
    h1, h2 = i1.cpu().numpy(), i2.cpu().numpy()

    def host_check(got):
        sample = list(range(0, n, max(1, n // 64)))
        idx = torch.tensor(sample, device=got[0].device)
        R = dev.decode_points({k: g.index_select(0, idx) for k, g in zip("xyz", got)})
        for r, j in zip(R, sample):  # against host affine math
            p_ = None if n // 4 <= j < 3 * n // 8 else base[h1[j]]
            if j < n // 8:
                q_ = base[h1[j]]
            elif j < n // 4:
                q_ = C.neg(base[h1[j]])
            elif 3 * n // 8 <= j < n // 2:
                q_ = None
            else:
                q_ = base[h2[j]]
            if r != C.add(p_, q_):
                raise AssertionError(f"K3 pair {j} of {n}: wrong sum")
        return f"host spot-check of {len(sample)} sums ok"

    return Pt, Qt, host_check


def adversarial_batch(F, n, rng):
    """Arbitrary canonical triples (off the curve: the formula is defined
    for every triple), each coordinate one of 0, 1, p - 1, p - 2 half of
    the time, else uniform."""
    special = torch.from_numpy(np.stack([
        np.array(F.encode([v], mont=False, device="cpu")[0]) for v in (0, 1, F.p - 1, F.p - 2)
    ])).cuda()
    out = []
    for _ in range(6):
        x = random_field(F, n, rng)
        pick = torch.from_numpy(rng.integers(0, 8, size=n)).cuda()
        x = torch.where((pick < 4)[:, None], special[pick.clamp(max=3)], x)
        out.append(x.contiguous())
    return tuple(out[:3]), tuple(out[3:])


def k5a_edges(F, n, rng):
    """K5a on adversarial_batch's planes (each value 0, 1, p - 1 or p - 2
    half of the time), three pairs, equal to its twin and to K1."""
    from contangle_zkcp_tpu_torch.ops import mont, mont_mma

    P, Q = adversarial_batch(F, n, rng)
    for a, b in zip(P, Q):
        got = mont_mma.mont_mul_mma(F, a, b)
        check("K5a", got, mont_mma.mont_mul_mma_plain(F, a, b), f"twin (edge values, {F.name})")
        check("K5a", got, mont.mont_mul(F, a, b), f"K1 (edge values, {F.name})")
    log(f"[kernels] K5a {F.name} n={n}: edge values (0, 1, p - 1, p - 2), three pairs, equal to "
        f"its twin and K1")


def check(name, got, want, what):
    """Exact equality of two tensors or tuples; returns the max abs error."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: kernel != {what} (max err {err})")
    return err


def measure(recs, key, label, fn, plain, reps, preps, nbytes, ops, mma_ops=0.0, **extra):
    """Kernel time from CUDA-graph replays, the twin's from direct calls."""
    from contangle_zkcp_tpu_torch.utils.profiling import bound

    ms = cuda_ms(fn, reps, graph=True)
    pms = cuda_ms(plain, preps)
    bms, by = bound(nbytes, ops, mma_ops)
    log(f"[kernels] {label}: equal, {ms:.4f} ms (twin {pms:.3f} ms, bound {bms:.4f} ms by {by})")
    recs[key] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, **extra)


def check_kernels(seed: int):
    """Each kernel vs its twin on the card; returns per-kernel records."""
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.ops import curve_add, field_mul, mont, mont_mma
    from contangle_zkcp_tpu_torch.utils.profiling import bound, counts

    rng = np.random.default_rng(seed)
    recs = {}
    t_all = time.time()

    for F, n in ((fi.bls12_381_fr(), 1 << 18), (fi.bls12_381_fq(), 1 << 18)):
        a, b = random_field(F, n, rng), random_field(F, n, rng)
        k1 = mont.mont_mul(F, a, b)
        err = check("K1", k1, mont.mont_mul_plain(F, a, b), "twin")
        measure(recs, f"k1_{F.name}", f"K1 k1_mont_mul {F.name} n={n}",
                lambda: mont.mont_mul(F, a, b), lambda: mont.mont_mul_plain(F, a, b), 100, 1,
                *counts("k1_mont_mul", F, n), err=err)
        eng = field_mul.make(F)
        k4 = eng.mul(a, b)
        err = check("K4", k4, eng.mul_reference(a, b), "twin")
        check("K4", k4, k1, "K1")
        measure(recs, f"k4_{F.name}", f"K4 k4_field_mul {F.name} n={n} (and equal to K1)",
                lambda: eng.mul(a, b), lambda: eng.mul_reference(a, b), 100, 1,
                *counts("k4_field_mul", F, n), err=err)
        k5 = mont_mma.mont_mul_mma(F, a, b)
        err = check("K5a", k5, mont_mma.mont_mul_mma_plain(F, a, b), "twin")
        check("K5a", k5, k1, "K1")
        k5a_edges(F, n, rng)
        measure(recs, f"k5a_{F.name}", f"K5a k5a_mont_mul_mma {F.name} n={n} (and equal to K1)",
                lambda: mont_mma.mont_mul_mma(F, a, b), lambda: mont_mma.mont_mul_mma_plain(F, a, b),
                100, 1, *counts("k5a_mont_mul_mma", F, n), err=err)

    F, n = fi.bls12_381_fr(), 1 << 17
    u, v, tw = (random_field(F, n, rng) for _ in range(3))
    k2 = mont.butterfly(F, u, v, tw)
    err = check("K2", k2, mont.butterfly_plain(F, u, v, tw), "twin")
    measure(recs, "k2", f"K2 k2_butterfly fr n={n}", lambda: mont.butterfly(F, u, v, tw),
            lambda: mont.butterfly_plain(F, u, v, tw), 100, 1,
            *counts("k2_butterfly", F, n), err=err)
    k5 = mont_mma.butterfly_mma(F, u, v, tw)
    err = check("K5b", k5, mont_mma.butterfly_mma_plain(F, u, v, tw), "twin")
    check("K5b", k5, k2, "K2")
    measure(recs, "k5b", f"K5b k5b_butterfly_mma fr n={n} (and equal to K2)",
            lambda: mont_mma.butterfly_mma(F, u, v, tw), lambda: mont_mma.butterfly_mma_plain(F, u, v, tw),
            100, 1, *counts("k5b_butterfly_mma", F, n), err=err)

    # K3/K5c at the MSMs' bucket width (2^16) and at a first tree level's
    # (2^20): a curve batch (held to host sums too) and an adversarial one
    # (arbitrary triples), each kernel equal to its twin and to the other
    Fq = fi.bls12_381_fq()
    C = ci.BLS12_381_G1
    dev = SWDevice(Fq, C, device="cuda")
    b3m = dev._b3m
    for n in (1 << 16, 1 << 20):
        cases = (("curve", *curve_batch(dev, C, Fq, n, rng)),
                 ("adversarial", *adversarial_batch(Fq, n, rng), None))
        for kind, Pt, Qt, host_check in cases:
            got = curve_add.sw_add(Fq, b3m, Pt, Qt)
            err3 = check("K3", got, curve_add.rcb_add_plain(Fq, b3m, Pt, Qt), f"twin ({kind} n={n})")
            note = host_check(got) if host_check else "no host check (not on the curve)"
            k5 = curve_add.sw_add_mma(Fq, b3m, Pt, Qt)
            err5 = check("K5c", k5, curve_add.rcb_add_mma_plain(Fq, b3m, Pt, Qt), f"twin ({kind} n={n})")
            check("K5c", k5, got, f"K3 ({kind} n={n})")
            log(f"[kernels] K3 and K5c {kind} batch n={n}: equal to their twins and each other; {note}")
            if kind != "curve":
                continue
            if n == 1 << 16:
                measure(recs, "k3", f"K3 k3_sw_add g1 n={n}",
                        lambda: curve_add.sw_add(Fq, b3m, Pt, Qt),
                        lambda: curve_add.rcb_add_plain(Fq, b3m, Pt, Qt),
                        40, 1, *counts("k3_sw_add", Fq, n), err=err3)
                measure(recs, "k5c", f"K5c k5c_sw_add_mma g1 n={n} (and equal to K3)",
                        lambda: curve_add.sw_add_mma(Fq, b3m, Pt, Qt),
                        lambda: curve_add.rcb_add_mma_plain(Fq, b3m, Pt, Qt), 40, 1,
                        *counts("k5c_sw_add_mma", Fq, n), err=err5)
            else:
                for key, fn in (
                    ("k3", lambda: curve_add.sw_add(Fq, b3m, Pt, Qt)),
                    ("k5c", lambda: curve_add.sw_add_mma(Fq, b3m, Pt, Qt)),
                ):
                    ms = cuda_ms(fn, 10, graph=True)
                    name = "k3_sw_add" if key == "k3" else "k5c_sw_add_mma"
                    bms, by = bound(*counts(name, Fq, n))
                    recs[key].update(ms_n2e20=ms, bound_ms_n2e20=bms)
                    log(f"[kernels] {key.upper()} g1 n={n}: {ms:.4f} ms (bound {bms:.4f} ms by {by})")
    check_pasta(recs, rng)
    check_bw6(recs, rng)
    t0 = time.time()
    check_ntt(recs, rng)
    log(f"[kernels] NTT passes: {time.time() - t0:.2f} s")
    t0 = time.time()
    check_ntt_batched(recs, rng)
    log(f"[kernels] batched NTT passes: {time.time() - t0:.2f} s")
    log(f"[kernels] ptxas: {ptxas_summary()}")
    log(f"[kernels] all checks: {time.time() - t_all:.2f} s")
    return recs


def check_pasta(recs, rng):
    """The PLONKish path's shapes: K1 on Pasta Fp at the k = 12 quotient's
    ext * n = 2^15 rows, K2 at its largest NTT (2^14 butterflies), and
    the point adds in the strict arithmetic (4p > R): K3 and K5c on Vesta
    and Pallas, on curve batches (held to host sums) and adversarial
    triples, equal to their twins and each other; K3 timed at n = 4,096
    (the IPA's first fold round) and 2^16, K5c at 2^16."""
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.ops import curve_add, mont
    from contangle_zkcp_tpu_torch.utils.profiling import counts

    F, n = fi.pasta_fp(), 1 << 15
    a, b = random_field(F, n, rng), random_field(F, n, rng)
    err = check("K1", mont.mont_mul(F, a, b), mont.mont_mul_plain(F, a, b), "twin (pasta_fp)")
    measure(recs, "k1_pasta_fp", f"K1 k1_mont_mul pasta_fp n={n}",
            lambda: mont.mont_mul(F, a, b), lambda: mont.mont_mul_plain(F, a, b), 100, 1,
            *counts("k1_mont_mul", F, n), err=err, shape="pasta_fp n=2^15")
    n //= 2
    u, v, tw = (random_field(F, n, rng) for _ in range(3))
    err = check("K2", mont.butterfly(F, u, v, tw), mont.butterfly_plain(F, u, v, tw), "twin (pasta_fp)")
    measure(recs, "k2_pasta_fp", f"K2 k2_butterfly pasta_fp n={n}",
            lambda: mont.butterfly(F, u, v, tw), lambda: mont.butterfly_plain(F, u, v, tw), 100, 1,
            *counts("k2_butterfly", F, n), err=err, shape="pasta_fp n/2=2^14")

    for cname, C, Fq, sizes in (("vesta", ci.VESTA, fi.pasta_fq(), (1 << 12, 1 << 16)),
                                ("pallas", ci.PALLAS, fi.pasta_fp(), (1 << 12,))):
        dev = SWDevice(Fq, C, device="cuda")
        b3m = dev._b3m
        if curve_add.kernel_b3(Fq, b3m)[2] != 1:
            raise AssertionError(f"{cname}: the strict arithmetic was not picked")
        for n in sizes:
            cases = (("curve", *curve_batch(dev, C, Fq, n, rng)),
                     ("adversarial", *adversarial_batch(Fq, n, rng), None))
            for kind, Pt, Qt, host_check in cases:
                got = curve_add.sw_add(Fq, b3m, Pt, Qt)
                err3 = check("K3", got, curve_add.rcb_add_plain(Fq, b3m, Pt, Qt),
                             f"twin ({cname} {kind} n={n})")
                note = host_check(got) if host_check else "no host check (not on the curve)"
                k5 = curve_add.sw_add_mma(Fq, b3m, Pt, Qt)
                err5 = check("K5c", k5, curve_add.rcb_add_mma_plain(Fq, b3m, Pt, Qt),
                             f"twin ({cname} {kind} n={n})")
                check("K5c", k5, got, f"K3 ({cname} {kind} n={n})")
                log(f"[kernels] K3 and K5c strict, {cname} {kind} batch n={n}: equal to their "
                    f"twins and each other; {note}")
                if kind != "curve" or cname != "vesta":
                    continue
                tag = f"2e{n.bit_length() - 1}"
                measure(recs, f"k3_vesta_{tag}", f"K3 k3_sw_add vesta (strict) n={n}",
                        lambda: curve_add.sw_add(Fq, b3m, Pt, Qt),
                        lambda: curve_add.rcb_add_plain(Fq, b3m, Pt, Qt), 40, 1,
                        *counts("k3_sw_add", Fq, n), err=err3,
                        shape=f"vesta n=2^{n.bit_length() - 1}")
                if n == 1 << 12:
                    fold_launch_cost(recs, dev, Pt, Qt)
                if n == 1 << 16:
                    measure(recs, "k5c_vesta", f"K5c k5c_sw_add_mma vesta (strict) n={n}",
                            lambda: curve_add.sw_add_mma(Fq, b3m, Pt, Qt),
                            lambda: curve_add.rcb_add_mma_plain(Fq, b3m, Pt, Qt), 40, 1,
                            *counts("k5c_sw_add_mma", Fq, n), err=err5, shape="vesta n=2^16")


def fold_launch_cost(recs, dev, Pt, Qt):
    """What one K3 launch of the IPA's generator fold costs at its sizes
    (h = 256 .. 4,096 points on Vesta): the device time by CUDA-graph
    replay beside the wall time of one `SWDevice.add` call (operand
    checks, allocation, launch), as the fold's ladders make them."""
    out = {}
    for h in (256, 1024, 4096):
        P = {k: t[:h] for k, t in zip("xyz", Pt)}
        Q = {k: t[:h] for k, t in zip("xyz", Qt)}
        dms = cuda_ms(lambda: dev.add(P, Q), 100, graph=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            dev.add(P, Q)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 500 * 1e3
        out[h] = {"device_ms": dms, "wall_ms": wall}
        log(f"[kernels] K3 vesta fold size h={h}: device {dms:.4f} ms, wall per SWDevice.add "
            f"{wall:.4f} ms")
    recs["k3_fold"] = out


def check_bw6(recs, rng):
    """The multiplies and butterflies at W = 24 (BW6-761 Fq, 761 bits),
    n = 2^16: K1, K4 and K5a against their twins and each other, K2 and
    K5b likewise."""
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.ops import field_mul, mont, mont_mma
    from contangle_zkcp_tpu_torch.utils.profiling import counts

    F, n = fi.bw6_761_fq(), 1 << 16
    a, b = random_field(F, n, rng), random_field(F, n, rng)
    k1 = mont.mont_mul(F, a, b)
    err = check("K1", k1, mont.mont_mul_plain(F, a, b), "twin (bw6_761_fq)")
    measure(recs, "k1_bw6", f"K1 k1_mont_mul bw6_761_fq n={n}",
            lambda: mont.mont_mul(F, a, b), lambda: mont.mont_mul_plain(F, a, b), 100, 1,
            *counts("k1_mont_mul", F, n), err=err, shape="bw6_761_fq n=2^16")
    eng = field_mul.make(F)
    err = check("K4", eng.mul(a, b), eng.mul_reference(a, b), "twin (bw6_761_fq)")
    check("K4", eng.mul(a, b), k1, "K1 (bw6_761_fq)")
    measure(recs, "k4_bw6", f"K4 k4_field_mul bw6_761_fq n={n} (and equal to K1)",
            lambda: eng.mul(a, b), lambda: eng.mul_reference(a, b), 100, 1,
            *counts("k4_field_mul", F, n), err=err, shape="bw6_761_fq n=2^16")
    k5 = mont_mma.mont_mul_mma(F, a, b)
    err = check("K5a", k5, mont_mma.mont_mul_mma_plain(F, a, b), "twin (bw6_761_fq)")
    check("K5a", k5, k1, "K1 (bw6_761_fq)")
    k5a_edges(F, n, rng)
    measure(recs, "k5a_bw6", f"K5a k5a_mont_mul_mma bw6_761_fq n={n} (and equal to K1)",
            lambda: mont_mma.mont_mul_mma(F, a, b), lambda: mont_mma.mont_mul_mma_plain(F, a, b),
            100, 1, *counts("k5a_mont_mul_mma", F, n), err=err, shape="bw6_761_fq n=2^16")
    u, v, tw = (random_field(F, n, rng) for _ in range(3))
    k2 = mont.butterfly(F, u, v, tw)
    err = check("K2", k2, mont.butterfly_plain(F, u, v, tw), "twin (bw6_761_fq)")
    measure(recs, "k2_bw6", f"K2 k2_butterfly bw6_761_fq n={n}",
            lambda: mont.butterfly(F, u, v, tw), lambda: mont.butterfly_plain(F, u, v, tw), 100, 1,
            *counts("k2_butterfly", F, n), err=err, shape="bw6_761_fq n/2=2^16")
    k5 = mont_mma.butterfly_mma(F, u, v, tw)
    err = check("K5b", k5, mont_mma.butterfly_mma_plain(F, u, v, tw), "twin (bw6_761_fq)")
    check("K5b", k5, k2, "K2 (bw6_761_fq)")
    measure(recs, "k5b_bw6", f"K5b k5b_butterfly_mma bw6_761_fq n={n} (and equal to K2)",
            lambda: mont_mma.butterfly_mma(F, u, v, tw),
            lambda: mont_mma.butterfly_mma_plain(F, u, v, tw), 100, 1,
            *counts("k5b_butterfly_mma", F, n), err=err, shape="bw6_761_fq n/2=2^16")


NTT_OPS = ("forward", "inverse", "coset_forward", "coset_inverse")


def ntt_time(recs, key, label, F, n, ntt, op, a, g, fn, twin, route, nbytes, ops, mma_ops, err):
    """One transform's device time (CUDA-graph replays) beside the
    one-stage route's and the twin's (first operation), its bound, and the
    wall time of one call; logs a line and keeps a record."""
    from contangle_zkcp_tpu_torch.utils.profiling import bound

    ms = cuda_ms(fn, 20, graph=True)
    old = cuda_ms(route, 10, graph=True)
    pms = cuda_ms(twin, 1, batches=1) if op == NTT_OPS[0] else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 50 * 1e3
    bms, by = bound(nbytes, ops, mma_ops)
    plan = "+".join(str(t) for _, t in ntt.plan)
    twin_note = f"twin {pms:.3f} ms, " if pms is not None else ""
    log(f"[kernels] {label}: equal pass by pass, to the stage loop and across kernels; "
        f"{ms:.4f} ms a transform in {len(ntt.plan)} passes ({plan}) ({twin_note}bound "
        f"{bms:.4f} ms by {by}, {bms / ms:.0%}); one-stage route {old:.4f} ms "
        f"({old / ms:.1f}x); wall of one call {wall:.4f} ms")
    recs[key] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, err=err, old_ms=old,
                     wall_ms=wall, plan=plan, shape=f"{F.name} n=2^{ntt.logn} {op}")


def check_ntt(recs, rng):
    """The NTT passes, K2's (k2_ntt_pass) and, under ZKCP_MXU=1, K5b's
    (k5b_ntt_pass), at the main paths' transforms (NTT_SHAPES): the Groth16
    quotient's Fr n = 2^18 (the PoE at 49,152 blocks), and the sale's
    2^19 (its PoE at 65,536 blocks: three passes), 2^14 (SampleEntries)
    and 2^13 (key encryption), with 2^15 beside them; the PLONK prover's
    Pasta Fp n = 2^15 (coset_forward, coset_inverse) and 2^12 (inverse);
    and n = 2, 4, 1024 on both fields; all four operations at each (g = 7
    and 5).  Every pass of each kernel equal to its twin on the same
    input (`ntt_pass_plain`, `ntt_pass_mma_plain`), each whole transform
    equal to its passes, to the
    stage loop (K2's twin; under ZKCP_MXU=1 the one-stage route through
    K5b's butterfly and K5a, ntt.stage_route) and to the other kernel's
    transform.  At n >= 2^12, for each kernel: one transform's device time
    (CUDA-graph replays), its bound, the twin's time (first operation),
    the one-stage route it replaced (ntt.stage_route: k2_butterfly, or
    k5b_butterfly_mma, with its F.mul scalings) timed beside it, and the
    wall time of one call."""
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.ops import mont, mont_mma
    from contangle_zkcp_tpu_torch.ops.ntt import NTT
    from contangle_zkcp_tpu_torch.utils.profiling import k2_ntt_int_ops, k5b_ntt_counts

    Fr, Fp = fi.bls12_381_fr(), fi.pasta_fp()
    fields = {F.name: F for F in (Fr, Fp)}
    shapes = [(fields[f], 1 << k) for f, k in NTT_SHAPES]
    shapes += [(F, n) for F in (Fr, Fp) for n in (2, 4, 1024)]
    small = []
    for F, n in shapes:
        g = fi.FIELD_GENERATORS[F.p]
        ntt = NTT(F, n, device="cuda")
        logn = ntt.logn
        a = random_field(F, n, rng)
        for op in NTT_OPS:
            tag = f"{F.name} n=2^{logn} {op}"
            args = (g,) if op.startswith("coset") else ()
            table, pre, post = ntt.pass_operands(op, g)
            outs, errs = {}, {}
            for name, run, plain in (("k2", mont.ntt_pass, mont.ntt_pass_plain),
                                     ("k5b", mont_mma.ntt_pass_mma, mont_mma.ntt_pass_mma_plain)):
                x, last, err = a, len(ntt.plan) - 1, 0
                for i, (s0, t) in enumerate(ntt.plan):
                    kw = dict(pre=pre if i == 0 else None, post=post if i == last else None,
                              gather=i == 0)
                    got = run(F, x, table, s0, t, **kw)
                    err = max(err, check(f"{name}_ntt_pass", got, plain(F, x, table, s0, t, **kw),
                                         f"twin ({tag}, pass {s0}+{t})"))
                    x = got
                outs[name], errs[name] = x, err

            def twin():
                return mont.ntt_pass_plain(F, a, table, 0, logn, pre, post, gather=True)

            def mxu(fn):
                os.environ["ZKCP_MXU"] = "1"
                try:
                    return fn()
                finally:
                    os.environ.pop("ZKCP_MXU", None)

            res = getattr(ntt, op)(a, *args)
            check("NTT", res, outs["k2"], f"its passes ({tag})")
            check("NTT", res, twin(), f"the stage loop's twin ({tag})")
            res5 = mxu(lambda: getattr(ntt, op)(a, *args))
            check("NTT under ZKCP_MXU=1", res5, outs["k5b"], f"its passes ({tag})")
            check("NTT under ZKCP_MXU=1", res5, mxu(lambda: ntt.stage_route(op, a, g)),
                  f"the stage loop through K5b and K5a ({tag})")
            check("NTT under ZKCP_MXU=1", res5, res, f"k2_ntt_pass's transform ({tag})")
            if n < 1 << 12:
                small.append(f"{F.name} n={n} {op}")
                continue
            scale = pre if pre is not None else post  # words: n rows, or 1 (n^-1)
            # limbs in and out, the table and the scale as 32-bit words
            nbytes = 2 * n * 4 * F.L + (n // 2 + (0 if scale is None else scale.shape[0])) * 2 * F.L
            ntt_time(recs, f"k2_ntt_{F.name}_2e{logn}_{op}", f"K2 k2_ntt_pass {tag}", F, n, ntt, op,
                     a, g, lambda: getattr(ntt, op)(a, *args), twin,
                     lambda: ntt.stage_route(op, a, g), nbytes,
                     k2_ntt_int_ops(F, n, scale is not None), 0.0, errs["k2"])
            ops5, mma5 = k5b_ntt_counts(F, n, scale is not None)
            ntt_time(recs, f"k5b_ntt_{F.name}_2e{logn}_{op}", f"K5b k5b_ntt_pass (ZKCP_MXU=1) {tag}",
                     F, n, ntt, op, a, g, lambda: mxu(lambda: getattr(ntt, op)(a, *args)),
                     lambda: mont_mma.ntt_pass_mma_plain(F, a, table, 0, logn, pre, post, gather=True),
                     lambda: mxu(lambda: ntt.stage_route(op, a, g)), nbytes, ops5, mma5, errs["k5b"])
    log(f"[kernels] k2_ntt_pass and k5b_ntt_pass at small n, {len(small)} transforms each equal pass "
        f"by pass, to the stage loops and to each other: {small[0]} .. {small[-1]}")


# the batched passes' shapes: the four-step NTT's column and row transforms
# at Fr 2^18 on one card (512 transforms of 2^9: one pass with the gather)
# and a batch of four whole 2^18 transforms (two passes)
NTT_BATCHES = ((512, 9), (4, 18))


def check_ntt_batched(recs, rng):
    """The NTT passes on a batch (B, n, L) of transforms, each pass ONE
    launch (NTT.forward_batched; k2_ntt_pass, and k5b_ntt_pass under
    ZKCP_MXU=1) at NTT_BATCHES: every pass equal to its batched twin and
    to B launches on one transform each, the whole batch equal to
    NTT.forward on its last transform; the batch's device time (CUDA-graph
    replays) beside B single-transform launches a pass (`old_ms`), its
    bound (B x one transform's counts) and the wall of one call."""
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.ops import mont, mont_mma
    from contangle_zkcp_tpu_torch.ops.ntt import NTT
    from contangle_zkcp_tpu_torch.utils.profiling import bound, counts

    F = fi.bls12_381_fr()
    for B, logn in NTT_BATCHES:
        n = 1 << logn
        ntt = NTT(F, n, device="cuda")
        a = random_field(F, B * n, rng).reshape(B, n, F.L)
        table = ntt.pass_operands("forward")[0]
        for key, kernel, run, plain in (("k2", "k2_ntt_pass", mont.ntt_pass, mont.ntt_pass_plain),
                                        ("k5b", "k5b_ntt_pass", mont_mma.ntt_pass_mma,
                                         mont_mma.ntt_pass_mma_plain)):
            tag = f"B={B} x n=2^{logn} forward"
            env = {"ZKCP_MXU": "1"} if key == "k5b" else {}
            x, err = a, 0
            for i, (s0, t) in enumerate(ntt.plan):
                got = run(F, x, table, s0, t, gather=i == 0)
                err = max(err, check(kernel, got, plain(F, x, table, s0, t, gather=i == 0),
                                     f"batched twin ({tag}, pass {s0}+{t})"))
                one = torch.stack([run(F, x[b], table, s0, t, gather=i == 0) for b in range(B)])
                check(kernel, got, one, f"{B} single-transform launches ({tag}, pass {s0}+{t})")
                x = got
            os.environ.update(env)
            try:
                res = ntt.forward_batched(a)
                check(kernel, res, x, f"its passes ({tag})")
                check(kernel, res[B - 1], ntt.forward(a[B - 1]), f"NTT.forward ({tag})")

                def batched():
                    return ntt.forward_batched(a)

                def singles():
                    y = a
                    for i, (s0, t) in enumerate(ntt.plan):
                        y = torch.stack([run(F, y[b], table, s0, t, gather=i == 0) for b in range(B)])
                    return y

                ms = cuda_ms(batched, 20, graph=True)
                old = cuda_ms(singles, 2, graph=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    batched()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / 20 * 1e3
            finally:
                for k in env:
                    os.environ.pop(k, None)
            pms = cuda_ms(lambda: plain(F, a, table, 0, logn, gather=True), 1, batches=1)
            nbytes, ops, mma = counts(kernel, F, n)
            bms, by = bound(B * nbytes, B * ops, B * mma)
            plan = "+".join(str(t) for _, t in ntt.plan)
            log(f"[kernels] {kernel} batched {tag}: equal pass by pass to its batched twin and to "
                f"{B} single-transform launches; {ms:.4f} ms a batch in {len(ntt.plan)} launches "
                f"({plan}) (twin {pms:.3f} ms, bound {bms:.4f} ms by {by}, {bms / ms:.0%}); {B} "
                f"single-transform launches a pass {old:.4f} ms ({old / ms:.1f}x); wall of one call "
                f"{wall:.4f} ms")
            recs[f"{key}_ntt_batch_{B}x2e{logn}"] = dict(
                ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by, err=err, old_ms=old, wall_ms=wall,
                plan=plan, shape=f"bls12_381_fr B={B} x n=2^{logn} forward, batched")


# --------------------------------------------------------------------- msm
def msm_check(seed: int) -> str:
    """The card's MSM engines against the exact host sum msm_host.  The
    lockstep engine (the port's bucket program on K3): G1, 256 points,
    scalars alternately uniform and 0/1 bits (the PoE witness's skew),
    unsigned and signed windows, the signed run peeling its heavy buckets.
    BalancedMSM (a 64-lane overflow pool, so that segments, fold levels and
    merges run) and TreeMSM: G1 and G2, signed and unsigned windows, over
    witness-like scalars (half 0/1 bits), uniform scalars, and duplicate
    points, P and -P pairs, identity inputs and zero scalars."""
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.curves.fq2_device import Fq2Device
    from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.fields.bigint import ints_to_limbs
    from contangle_zkcp_tpu_torch.ops.msm import MSM, msm_host
    from contangle_zkcp_tpu_torch.ops.msm_balanced import BalancedMSM
    from contangle_zkcp_tpu_torch.ops.msm_tree import TreeMSM

    C, R = ci.BLS12_381_G1, fi.BLS12_381_R
    Fq = fi.bls12_381_fq()
    dev = SWDevice(Fq, C, device="cuda")
    rng = np.random.default_rng(seed + 1)
    n = 256
    step = C.mul(int(rng.integers(2, 1 << 30)), C.generator)
    pts, acc = [], None
    for _ in range(n):
        acc = C.add(acc, step)
        pts.append(acc)
    bits = rng.integers(0, 2, size=n)
    sc = [int.from_bytes(rng.bytes(32), "little") % R if i % 2 else int(bits[i])
          for i in range(n)]
    want = msm_host(C, pts, sc)
    P = dev.encode_points(pts)
    for signed in (False, True):
        eng = MSM(dev, scalar_bits=255, c=8, signed=signed)
        if signed:
            eng.HEAVY_CNT = 16
        if eng.run(P, sc) != want:
            raise AssertionError(f"MSM n={n} signed={signed}: card result != msm_host")

    class G2Host:  # msm_host's curve interface over the host G2 math
        def __init__(self, d):
            self.add, self.mul = d.host_add, d.host_mul

    g2dev = SWDevice(Fq2Device(Fq), b=ci.BLS12_381_G2_B, device="cuda")
    prng = random.Random(seed + 3)
    runs = 0
    for name, d, host, gen, m in (
        ("g1", dev, C, C.generator, 160),
        ("g2", g2dev, G2Host(g2dev), (ci.BLS12_381_G2_GX, ci.BLS12_381_G2_GY), 32),
    ):
        base = [host.mul(prng.randrange(1, R), gen) for _ in range(m)]
        for kind in ("witness", "uniform", "adversarial"):
            pts = list(base)
            if kind == "uniform":
                sc = [prng.randrange(R) for _ in range(m)]
            else:
                sc = [prng.randrange(R) if prng.random() < 0.5 else prng.randrange(2) for _ in range(m)]
            if kind == "adversarial":
                Q = pts[0]
                negQ = (Q[0], (C.p - Q[1]) if name == "g1" else tuple((-c) % C.p for c in Q[1]))
                pts[:6] = [Q, Q, Q, negQ, pts[4], pts[4]]
                s0 = prng.randrange(R)
                sc[:9] = [s0, s0, s0, s0, 7, 7, 5, 5, 0]
                pts[6] = pts[7] = None  # identity inputs
            live = [(p_, s_) for p_, s_ in zip(pts, sc) if p_ is not None]
            want = msm_host(host, [p_ for p_, _ in live], [s_ for _, s_ in live])
            P = d.encode_points(pts)
            for signed in (False, True):
                bal = BalancedMSM(d, 255, c=6, signed=signed, overflow_lanes=64)
                sch = bal.schedule(ints_to_limbs(sc, 16))
                if kind == "witness" and not (sch["nlev"] >= 1 and sch["merge_mask"].any()):
                    raise AssertionError(f"BalancedMSM {name}: the overflow pool was not exercised")
                for eng in (bal, TreeMSM(d, 255, c=6, signed=signed)):
                    if eng.run(P, sc) != want:
                        raise AssertionError(f"{type(eng).__name__} {name} {kind} signed={signed}: "
                                             f"card result != msm_host")
                    runs += 1
    return (f"lockstep n={n}, unsigned and signed (heavy peel), and {runs} BalancedMSM (64 overflow "
            f"lanes) and TreeMSM runs (G1 n=160, G2 n=32; witness-like, uniform, duplicates, P and -P, "
            f"identities, zero scalars; signed and unsigned) equal to msm_host")


ENGINES = ("lockstep", "balanced", "tree")
# the full-size runs, one each (their second turns, B A, were cut to keep
# the smoke wall near 600 s); the tree engine, on no policy path, runs its
# checked warm-up on a 4,096-point slice only
TURNS = ("lockstep", "balanced")
# the PoE's proving MSMs at N = 49,152 blocks: the H query (d - 1 points,
# d = 2^18) in G1 with witness-like and uniform scalars, and the B query
# in G2 (one point per variable: 202,506)
MSM_SHAPES = (("g1", 262143, "witness"), ("g1", 262143, "uniform"), ("g2", 202506, "witness"))


def run_msm(seed: int):
    """The three engines at the PoE's real shapes, on the policy's window
    (c = 16 in G1, 12 in G2, signed digits).  The points are k_i G from the
    card's fixed-base multiplier, so the exact answer is (sum s_i k_i) G,
    one host multiply: it holds every run, and on a 4,096-point slice each
    engine's warm-up call.  Then the lockstep and balanced engines run once
    each (TURNS) in this process; each run prints its ms, launches per
    kernel, the balanced engine's trips T and overflow lanes and the peak
    device memory.  Returns (launches over the phase, seconds)."""
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.curves.fq2_device import Fq2Device
    from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.fields.bigint import ints_to_limbs
    from contangle_zkcp_tpu_torch.ops import cuda_lib
    from contangle_zkcp_tpu_torch.ops.fixed_base import FixedBaseDevice
    from contangle_zkcp_tpu_torch.ops.msm import MSM
    from contangle_zkcp_tpu_torch.ops.msm_balanced import BalancedMSM
    from contangle_zkcp_tpu_torch.ops.msm_policy import msm_config
    from contangle_zkcp_tpu_torch.ops.msm_tree import TreeMSM
    from contangle_zkcp_tpu_torch.utils import metrics

    C, R = ci.BLS12_381_G1, fi.BLS12_381_R
    Fq = fi.bls12_381_fq()
    devs = {"g1": (SWDevice(Fq, C, device="cuda"), C.generator),
            "g2": (SWDevice(Fq2Device(Fq), b=ci.BLS12_381_G2_B, device="cuda"),
                   (ci.BLS12_381_G2_GX, ci.BLS12_381_G2_GY))}
    kinds = {"lockstep": MSM, "balanced": BalancedMSM, "tree": TreeMSM}
    rng = random.Random(seed + 11)
    t_phase = time.time()
    cuda_lib.reset_launches()
    table = {}
    for group, n, kind in MSM_SHAPES:
        dev, gen = devs[group]
        ks = [rng.randrange(1, R) for _ in range(n)]
        if kind == "uniform":
            sc = [rng.randrange(R) for _ in range(n)]
        else:  # the PoE witness's skew: half the scalars 0/1 bits
            sc = [rng.randrange(R) if rng.random() < 0.5 else rng.randrange(2) for _ in range(n)]
        t0 = time.time()
        pts = FixedBaseDevice(dev, gen, R.bit_length(), chunk=1 << 16).mul_ints(ks)
        limbs = ints_to_limbs(sc, 16)
        want = dev.host_mul(sum(s * k for s, k in zip(sc, ks)) % R, gen)
        cut = 4096
        want_cut = dev.host_mul(sum(s * k for s, k in zip(sc[:cut], ks[:cut])) % R, gen)
        torch.cuda.synchronize()
        cfg = msm_config(group, n)
        engines = {e: kinds[e](dev, 255, c=cfg.c, signed=cfg.signed) for e in ENGINES}
        log(f"[msm] {group} n={n} {kind} scalars: points made on the card in {time.time() - t0:.2f} s; "
            f"policy c={cfg.c} signed={cfg.signed} engine={cfg.engine}")
        for e, eng in engines.items():  # warm-up: the 4,096-point slice
            if eng.run({k: v[:cut] for k, v in pts.items()}, limbs[:cut]) != want_cut:
                raise AssertionError(f"[msm] {e} {group} on the {cut}-point slice != the host sum")
        rows = {e: [] for e in TURNS}
        for e in TURNS:
            metrics.registry().reset()
            before = dict(cuda_lib.LAUNCHES)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            got = engines[e].run(pts, limbs)
            torch.cuda.synchronize()
            ms = (time.time() - t0) * 1e3
            if got != want:
                raise AssertionError(f"[msm] {e} {group} n={n} {kind}: result != the host sum")
            snap = metrics.registry().snapshot()
            rows[e].append(dict(
                ms=round(ms, 1),
                launches={k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items() if v - before.get(k, 0)},
                timers_ms={k.split(".")[1]: round(v["total_sec"] * 1e3, 1) for k, v in sorted(snap["timers"].items())},
                gauges={k.split(".")[1]: v for k, v in snap["gauges"].items()
                        if k in ("msm.balanced_trips", "msm.balanced_overflow_lanes",
                                 "msm.balanced_fold_levels", "msm.heavy_buckets")},
                peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2)))
        for e in rows:
            log(f"[msm] {group} n={n} {kind} {e}: ms {[r['ms'] for r in rows[e]]}; launches "
                f"{json.dumps(rows[e][0]['launches'], sort_keys=True)}; {json.dumps(rows[e][0]['gauges'])}; "
                f"timers (ms) {[r['timers_ms'] for r in rows[e]]}; peak {rows[e][0]['peak_gib']} GiB")
        table[f"{group}_{n}_{kind}"] = {e: [r["ms"] for r in rows[e]] for e in rows}
        del pts
        torch.cuda.empty_cache()
    launches = dict(cuda_lib.LAUNCHES)
    log(f"[msm] all three engines equal the host sum at every shape (the tree engine on the "
        f"4,096-point slice); ms ({', '.join(TURNS)}): {json.dumps(table)}")
    log(f"[msm] launches over the phase: {json.dumps(launches, sort_keys=True)}")
    for k in ("k1_mont_mul", "k3_sw_add"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched by the [msm] phase")
    for k in MXU_KERNELS + OFF_PATH:
        if launches.get(k, 0):
            raise AssertionError(f"kernel {k} launched in the default configuration")
    return launches, {"msm": time.time() - t_phase}


def run_edwards(seed: int):
    """The Jubjub device curve on the card: 2^16 points through a 255-bit
    scalar_mul_ints of the generator, add and double; every result on the
    curve after to_affine (checked on the card), and 64 of each equal to the
    host EdwardsCurve.  Returns (launches over the phase, seconds)."""
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.curves.edwards import EdwardsDevice
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.ops import cuda_lib

    J, F = ci.JUBJUB, fi.jubjub_fq()
    n = 1 << 16
    rng = random.Random(seed + 21)
    ks = [rng.getrandbits(255) for _ in range(n)]
    cuda_lib.reset_launches()
    t_phase = time.time()
    dev = EdwardsDevice(F, J, device="cuda")
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        times[name] = round(time.time() - t0, 4)
        return out

    G = dev.encode_points([J.generator] * n)
    A = timed("scalar_mul_ints", lambda: dev.scalar_mul_ints(G, ks, nbits=255))
    rolled = {k: torch.roll(v, 1, 0) for k, v in A.items()}
    B = timed("add", lambda: dev.add(A, rolled))
    D = timed("double", lambda: dev.double(A))
    a_m, d_m, one = F.encode(J.a, device="cuda"), F.encode(J.d, device="cuda"), F.one_mont((), device="cuda")
    for name, P in (("scalar_mul_ints", A), ("add", B), ("double", D)):
        x, y = timed(f"to_affine {name}", lambda: dev.to_affine(P))
        xx, yy = F.mul(torch.stack([x, y]), torch.stack([x, y]))
        lhs = F.add(F.mul(a_m, xx), yy)
        rhs = F.add(one, F.mul(d_m, F.mul(xx, yy)))
        if not bool(F.eq(lhs, rhs).all()):
            raise AssertionError(f"[edwards] {name}: a point off the curve")
    m = 64
    host_a = [J.mul(k, J.generator) for k in ks[:m]]
    sub = {k: v[:m] for k, v in A.items()}
    if dev.decode_points(sub) != host_a:
        raise AssertionError("[edwards] scalar_mul_ints != the host curve")
    host_prev = [J.mul(ks[-1], J.generator)] + host_a[:-1]  # the rolled operand
    if dev.decode_points({k: v[:m] for k, v in B.items()}) != [J.add(a, b) for a, b in zip(host_a, host_prev)]:
        raise AssertionError("[edwards] add != the host curve")
    if dev.decode_points({k: v[:m] for k, v in D.items()}) != [J.add(p, p) for p in host_a]:
        raise AssertionError("[edwards] double != the host curve")
    launches = dict(cuda_lib.LAUNCHES)
    log(f"[edwards] n={n}: scalar_mul_ints (255 bits), add, double and to_affine on the card, every "
        f"point on the curve, 64 of each equal to the host curve; s {json.dumps(times)}; launches "
        f"{json.dumps(launches, sort_keys=True)}")
    if launches.get("k1_mont_mul", 0) <= 0:
        raise AssertionError("kernel k1_mont_mul was not launched by the [edwards] phase")
    return launches, {"edwards": time.time() - t_phase}


# ------------------------------------------------------------------ golden
def toy_golden():
    """tests/test_groth16.py toy_circuit, seed 20260819, on the card: the
    pk/vk/proof bytes must hash to the JAX package's pinned golden."""
    from contangle_zkcp_tpu_torch.groth16 import Groth16
    from contangle_zkcp_tpu_torch.groth16.serialize import pk_to_bytes, proof_to_bytes, vk_to_bytes
    from contangle_zkcp_tpu_torch.r1cs.builder import ConstraintSystem
    from contangle_zkcp_tpu_torch.r1cs.gadgets import Gadgets

    eng = Groth16("bls12_381", device="cuda")
    p = eng.ctx.r
    cs = ConstraintSystem(p=p)
    g = Gadgets(cs)
    xv, yv = g.witness(3), g.witness(5)
    prod = g.mul(xv, yv)
    zin, win = g.input(15 % p), g.input(8 % p)
    g.enforce_equal(prod, zin)
    g.enforce_equal(xv + yv, win)
    cube = g.mul(prod, xv)
    b = g.alloc_bit(1)
    g.enforce_equal(g.mul(cube, b), cube)
    rng = random.Random(20260819)
    pk, vk = eng.setup(cs, rng)
    proof = eng.prove(pk, cs, rng)
    with open(os.path.join(ROOT, "tests", "conformance", "groth16_golden_bls12_381.json")) as f:
        want = json.load(f)
    for name, blob in (("pk", pk_to_bytes(pk)), ("vk", vk_to_bytes(vk)), ("proof", proof_to_bytes(proof))):
        if hashlib.sha256(blob).hexdigest() != want[name]["sha256"]:
            raise AssertionError(f"toy Groth16 {name} bytes differ from the golden")
    if not eng.verify(vk, cs.public_inputs(), proof):
        raise AssertionError("toy proof rejected")


# ------------------------------------------------------------------- slice
def balanced_note() -> str:
    """The balanced engine's runs and trips since the metrics were reset."""
    from contangle_zkcp_tpu_torch.utils import metrics

    snap = metrics.registry().snapshot()
    c, g = snap["counters"], snap["gauges"]
    return (f"BalancedMSM runs {int(c.get('msm.balanced_runs', 0))}, trips "
            f"{int(c.get('msm.balanced_trips_total', 0))} in all (last run T="
            f"{g.get('msm.balanced_trips')}, overflow lanes {g.get('msm.balanced_overflow_lanes')})")


DEFAULT_KERNELS = ("k1_mont_mul", "k2_ntt_pass", "k3_sw_add")
MXU_KERNELS = ("k5a_mont_mul_mma", "k5b_ntt_pass", "k5c_sw_add_mma")
# the one-stage entries of K2 and K5b: launched by no path since the passes
OFF_PATH = ("k2_butterfly", "k5b_butterfly_mma")

def message(n_blocks: int, seed: int) -> bytes:
    """n 32-byte chunks that each parse as one field element and survive
    the chunk round trip (no trailing zero byte, top byte < 0x70)."""
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 256, size=(n_blocks, 32), dtype=np.uint8)
    m[:, 31] = rng.integers(1, 0x70, size=n_blocks)
    return m.tobytes()


def run_slice(n_blocks: int, seed: int):
    from contangle_zkcp_tpu_torch.circuits import elgamal
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.ops import cuda_lib
    from contangle_zkcp_tpu_torch.utils import metrics
    from contangle_zkcp_tpu_torch.utils import serialize as ser
    from contangle_zkcp_tpu_torch.zkcp.zk_encryption import ZkEncryption

    build_dir = os.path.join(ROOT, "contangle_zkcp_tpu_torch", "build", "chip_smoke_zk")
    shutil.rmtree(build_dir, ignore_errors=True)
    params = elgamal.ElGamalParams(curve=ci.JUBJUB, n=n_blocks)
    rng = random.Random(seed)
    msg = message(n_blocks, seed)
    metrics.registry().reset()
    cuda_lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = {}

    t0 = time.time()
    zk = ZkEncryption(build_dir, params=params, device="cuda")
    zk.compile(rng)
    torch.cuda.synchronize()
    times["compile"] = time.time() - t0
    log(f"[slice] compile (setup + key files) n={n_blocks}: {times['compile']:.3f} s, "
        f"zkey {os.path.getsize(os.path.join(build_dir, 'circuit.zkey'))} bytes")

    sk, pk_pt = zk.keygen(rng)
    before = dict(cuda_lib.LAUNCHES)
    t0 = time.time()
    cipher, proof = zk.encrypt(msg, pk_pt, rng)
    torch.cuda.synchronize()
    times["encrypt_prove"] = time.time() - t0
    per_prove = {k: cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in cuda_lib.KERNELS}
    log(f"[slice] encrypt + prove: {times['encrypt_prove']:.3f} s, "
        f"ciphertext {len(cipher)} bytes, proof {len(proof)} bytes, "
        f"launches {json.dumps(per_prove, sort_keys=True)}; {balanced_note()}")

    t0 = time.time()
    ok = zk.verify_proof(proof, cipher)
    times["verify"] = time.time() - t0
    if not ok:
        raise AssertionError("verifier rejected the proof")
    log(f"[slice] verify: accepted, {times['verify']:.3f} s")

    bad = bytearray(cipher)
    bad[32 + 8] ^= 1  # low bit of the first ciphertext block
    t0 = time.time()
    if zk.verify_proof(proof, bytes(bad)):
        raise AssertionError("verifier accepted a tampered public input")
    log(f"[slice] tampered public input: rejected, {time.time() - t0:.3f} s")

    t0 = time.time()
    plain = zk.decrypt(ser.fp_to_bytes(sk, params.curve.order), cipher)
    times["decrypt"] = time.time() - t0
    if plain != msg:
        raise AssertionError("decrypted bytes differ from the message")
    log(f"[slice] decrypt: {len(plain)} bytes equal to the message, {times['decrypt']:.3f} s")

    launches = dict(cuda_lib.LAUNCHES)
    log(f"[slice] launches on the main path: {json.dumps(launches, sort_keys=True)}")
    for k in DEFAULT_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    for k in MXU_KERNELS + OFF_PATH:
        if launches.get(k, 0):
            raise AssertionError(f"kernel {k} launched in the default configuration")
    snap = metrics.registry().snapshot()
    timers = {k: round(v["total_sec"], 4) for k, v in sorted(snap["timers"].items())
              if k.startswith(("groth16.", "msm."))}
    log(f"[slice] timers (s): {json.dumps(timers)}")
    log(f"[slice] peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # The same encrypt + prove under ZKCP_MXU=1, on the same key: the
    # tensor-core configuration's prove time beside the default's.
    os.environ["ZKCP_MXU"] = "1"
    try:
        before = dict(cuda_lib.LAUNCHES)
        timers0 = metrics.registry().snapshot()["timers"]
        t0 = time.time()
        cipher, proof = zk.encrypt(msg, pk_pt, rng)
        torch.cuda.synchronize()
        times["encrypt_prove_mxu"] = time.time() - t0
        timers1 = metrics.registry().snapshot()["timers"]
        prove, ntt_h = (timers1[k]["total_sec"] - timers0[k]["total_sec"]
                        for k in ("groth16.prove", "groth16.prove.ntt_h"))
        times["ntt_h_mxu"] = ntt_h
        if not zk.verify_proof(proof, cipher):
            raise AssertionError("verifier rejected the ZKCP_MXU=1 proof")
        delta = {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items() if v - before.get(k, 0)}
        log(f"[slice] encrypt + prove under ZKCP_MXU=1: {times['encrypt_prove_mxu']:.3f} s "
            f"(prove {prove:.3f} s, of which groth16.prove.ntt_h {ntt_h:.4f} s), verifies; "
            f"launches {json.dumps(delta, sort_keys=True)}; since the first prove: {balanced_note()}")
        for k in MXU_KERNELS:
            if not delta.get(k):
                raise AssertionError(f"kernel {k} was not launched by the ZKCP_MXU=1 prove")
        for k in DEFAULT_KERNELS + OFF_PATH:
            if delta.get(k):
                raise AssertionError(f"kernel {k} launched by the ZKCP_MXU=1 prove")
    finally:
        os.environ.pop("ZKCP_MXU", None)
    shutil.rmtree(build_dir, ignore_errors=True)
    return launches, times


# ---------------------------------------------------------------- property
def run_property(n_blocks: int, seed: int):
    """The circom Proof of Property in the default configuration: the
    dummy property circuit (something = plaintext[0], challenge =
    something^2) composed with the encryption circuit at n_blocks one-byte
    blocks into one Groth16 proof (zkcp/property.py), through its entry
    points: compile, encrypt and prove a true property, verify, decrypt,
    a tampered ciphertext and a false property refused.  Returns (launches
    over the phase, seconds)."""
    from contangle_zkcp_tpu_torch.ops import cuda_lib
    from contangle_zkcp_tpu_torch.utils import metrics
    from contangle_zkcp_tpu_torch.utils import serialize as ser
    from contangle_zkcp_tpu_torch.utils.errors import ProofError
    from contangle_zkcp_tpu_torch.circuits import elgamal
    from contangle_zkcp_tpu_torch.zkcp import CircomParams, ZkEncryption, ZkPropertyVerifier

    build_dir = os.path.join(ROOT, "contangle_zkcp_tpu_torch", "build", "chip_smoke_property")
    shutil.rmtree(build_dir, ignore_errors=True)
    rng = random.Random(seed + 31)
    msg = np.random.default_rng(seed + 31).integers(1, 256, size=n_blocks, dtype=np.uint8).tobytes()
    metrics.registry().reset()
    cuda_lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = {}

    def merge_s():
        return metrics.registry().snapshot()["timers"].get("property.merge", {}).get("total_sec", 0.0)

    t0 = time.time()
    # no circom artifact at r1cs_path: the verifier takes the dummy circuit
    pv = ZkPropertyVerifier(build_dir, CircomParams(r1cs_path=os.path.join(build_dir, "none.r1cs")),
                            n_blocks, device="cuda")
    pv.compile(rng)
    torch.cuda.synchronize()
    times["compile"] = time.time() - t0
    gauges = metrics.registry().snapshot()["gauges"]
    sizes = {f: os.path.getsize(os.path.join(build_dir, f)) for f in ("circuit.zkey", "verification.key")}
    times["merge_compile"] = merge_s()
    log(f"[property] compile (composed setup + key files) n={n_blocks}: {times['compile']:.3f} s; "
        f"composed system: {int(gauges['property.constraints'])} constraints, "
        f"{int(gauges['property.variables'])} variables, domain {pv.proving_key.domain}; "
        f"_merge {times['merge_compile']:.3f} s; key files (bytes) {json.dumps(sizes)}")

    sk, pk_pt = elgamal.keygen(pv.params, rng)
    p = pv.params.curve.p
    s = msg[0]
    before = dict(cuda_lib.LAUNCHES)
    metrics.registry().reset()
    t0 = time.time()
    cipher, pop = pv.assess_property_and_encrypt(msg, sk, pk_pt, {"something": s, "challenge": s * s % p}, rng)
    torch.cuda.synchronize()
    times["encrypt_prove"] = time.time() - t0
    times["merge_prove"] = merge_s()
    per_prove = {k: cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in cuda_lib.KERNELS}
    snap = metrics.registry().snapshot()
    prove_timers = {k: round(v["total_sec"], 4) for k, v in sorted(snap["timers"].items())
                    if k.startswith(("groth16.", "msm.", "property."))}
    log(f"[property] encrypt + compose + prove: {times['encrypt_prove']:.3f} s (_merge "
        f"{times['merge_prove']:.3f} s), ciphertext {len(cipher)} bytes, proof {len(pop.proof)} bytes, "
        f"launches {json.dumps(per_prove, sort_keys=True)}; {balanced_note()}")
    log(f"[property] prove timers (s): {json.dumps(prove_timers)}")

    t0 = time.time()
    if not pv.verify_proof(pop, cipher):
        raise AssertionError("[property] verifier rejected the proof of a true property")
    times["verify"] = time.time() - t0
    log(f"[property] verify: accepted, {times['verify']:.3f} s")

    t0 = time.time()
    plain = ZkEncryption(os.path.join(build_dir, "decrypt"), params=pv.params, device="cuda").decrypt(
        ser.fp_to_bytes(sk, pv.params.curve.order), cipher)
    times["decrypt"] = time.time() - t0
    if plain != msg:
        raise AssertionError("[property] decrypted bytes differ from the message")
    log(f"[property] decrypt: {len(plain)} bytes equal to the message, {times['decrypt']:.3f} s")

    bad = bytearray(cipher)
    bad[32 + 8] ^= 1  # low bit of the first ciphertext block
    t0 = time.time()
    if pv.verify_proof(pop, bytes(bad)):
        raise AssertionError("[property] verifier accepted a tampered ciphertext")
    log(f"[property] tampered ciphertext: rejected, {time.time() - t0:.3f} s")

    t0 = time.time()
    try:
        pv.assess_property_and_encrypt(msg, sk, pk_pt, {"something": s, "challenge": (s * s + 1) % p}, rng)
    except ProofError as e:
        refusal = f"ProofError({e})"
    else:
        raise AssertionError("[property] a false property (challenge != something^2) gave a proof")
    log(f"[property] false property: refused before any proof ({refusal}), {time.time() - t0:.3f} s")

    launches = dict(cuda_lib.LAUNCHES)
    log(f"[property] launches over the phase: {json.dumps(launches, sort_keys=True)}")
    for k in DEFAULT_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched by the [property] phase")
    for k in MXU_KERNELS + OFF_PATH:
        if launches.get(k, 0):
            raise AssertionError(f"kernel {k} launched in the default configuration")
    log(f"[property] peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    shutil.rmtree(build_dir, ignore_errors=True)
    return launches, times


# -------------------------------------------------------------------- fold
def run_fold(n_blocks: int, seed: int, mesh):
    """The folding accumulator and its decider in the default
    configuration (groth16/folding.py, decider.py, ipa_vec.py): four
    satisfied PoE-shaped instances of n_blocks blocks (circuits/
    poe_shape.py, the structure the reference's folding tests fold), the
    scheme's bases (hashing on the host, the cofactor cleared on the card),
    the four lifted, folded as a tree ((0+1), (2+3), then the two) and the
    accumulator checked; the decider's bases (padded to powers of two), a
    proof of the accumulator, its verification, and a proof with va + 1
    and an instance with u + 1 rejected.  Every device MSM of the scheme
    and of the first round of both openings is held to msm_host on the
    same points and scalars, and 64 device-cleared bases to the host's
    cofactor multiply.  The host sums run beside the phase in spawned
    worker processes (pure host integers; no worker touches the card),
    one core left to the phase, all shut down before this returns.  Then
    the same four instances tree-folded by parallel/fold_pipeline.py
    MeshFoldPipeline on `mesh`: its accumulator equal to the sequential
    one, and its three comm_T to the ones held to msm_host.
    Returns (launches over the phase, seconds)."""
    import concurrent.futures
    import multiprocessing

    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        return fold_phase(n_blocks, seed, pool, workers, mesh)
    finally:
        pool.shutdown(cancel_futures=True)


def fold_phase(n_blocks: int, seed: int, pool, workers: int, mesh):
    import dataclasses

    from contangle_zkcp_tpu_torch.circuits.poe_shape import mini_poe_cs
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.groth16 import folding
    from contangle_zkcp_tpu_torch.groth16.decider import Decider
    from contangle_zkcp_tpu_torch.ops import cuda_lib
    from contangle_zkcp_tpu_torch.ops.msm import msm_host

    C, P = ci.BLS12_381_G1, folding._R
    css = [mini_poe_cs(n_blocks, seed + 11 * (i + 1)) for i in range(4)]
    cs = css[0]
    log(f"[fold] structure n={n_blocks}: {cs.num_constraints} constraints, {cs.num_variables} "
        f"variables ({cs.num_instance} instance), four satisfied instances")
    checks = {}  # tag -> [(points, device result, future of msm_host)]

    def record(eng, tag, first=None):
        """Hand the engine's MSMs (all, or the first `first`) to the
        host oracle as they are made."""
        run = eng.run

        def recorded(points, scalars):
            out = run(points, scalars)
            runs = checks.setdefault(tag, [])
            if first is None or len(runs) < first:
                runs.append((len(points), out, pool.submit(msm_host, C, list(points), list(scalars))))
            return out

        eng.run = recorded

    cuda_lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = {}

    def step(name, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.time() - t0
        return out

    scheme = step("bases", lambda: folding.FoldingScheme(cs, device="cuda"))
    if scheme._msm is None:
        raise AssertionError("[fold] the scheme's commitments are not on the device MSM")
    record(scheme._msm, "scheme")
    lifted = step("lift", lambda: [scheme.instance_from_cs(c) for c in css])

    def tree():
        i01, w01 = scheme.fold(*lifted[0], *lifted[1])
        i23, w23 = scheme.fold(*lifted[2], *lifted[3])
        return scheme.fold(i01, w01, i23, w23)

    acc_i, acc_w = step("fold", tree)
    if not step("check", lambda: scheme.check(acc_i, acc_w)):
        raise AssertionError("[fold] the folded accumulator does not check")
    log(f"[fold] bases {times['bases']:.3f} s ({len(scheme.bases_w)} + {len(scheme.bases_e)}), "
        f"lift {times['lift']:.3f} s, three folds {times['fold']:.3f} s, check {times['check']:.3f} s; "
        f"accumulator u != 1: {acc_i.u != 1}; {len(checks['scheme'])} device commitments")

    dec = step("decider_bases", lambda: Decider(scheme))
    for ipa, tag in ((dec.ipa_e, "open_e"), (dec.ipa_w, "open_w")):
        if ipa._msm is None:
            raise AssertionError(f"[fold] the decider's {tag} is not on the device MSM")
        record(ipa._msm, tag, first=2)  # round 1: L, R
    proof = step("prove", lambda: dec.prove(acc_i, acc_w))
    if not step("verify", lambda: dec.verify(acc_i, proof)):
        raise AssertionError("[fold] the decider rejected its own proof")
    bad_proof = dataclasses.replace(proof, va=(proof.va + 1) % P)
    if step("reject_va", lambda: dec.verify(acc_i, bad_proof)):
        raise AssertionError("[fold] the decider accepted a proof with va + 1")
    bad_inst = dataclasses.replace(acc_i, u=(acc_i.u + 1) % P)
    if step("reject_u", lambda: dec.verify(bad_inst, proof)):
        raise AssertionError("[fold] the decider accepted an instance with u + 1")
    launches = dict(cuda_lib.LAUNCHES)
    log(f"[fold] decider (NC {dec.NC}, NZ {dec.NZ}): bases {times['decider_bases']:.3f} s, prove "
        f"{times['prove']:.3f} s ({len(proof.outer_polys)} outer and {len(proof.inner_polys)} "
        f"inner sumcheck rounds, {len(proof.open_e.rounds)} + {len(proof.open_w.rounds)} opening "
        f"rounds), verify {times['verify']:.3f} s; va + 1 rejected {times['reject_va']:.3f} s, "
        f"u + 1 rejected {times['reject_u']:.3f} s")
    log(f"[fold] launches over the phase: {json.dumps(launches, sort_keys=True)}")
    log(f"[fold] peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches.get("k3_sw_add", 0) <= 0:
        raise AssertionError("kernel k3_sw_add was not launched by the [fold] phase")
    for k in MXU_KERNELS + OFF_PATH:
        if launches.get(k, 0):
            raise AssertionError(f"kernel {k} launched by the [fold] phase")

    # ---- exact checks against the host (none of them launches a kernel)
    t0 = time.time()
    raw = folding._hash_points_raw(b"contangle-fold-w", 64)
    if scheme.bases_w[:64] != [C.mul(folding._H1, pt) for pt in raw]:
        raise AssertionError("[fold] device-cleared bases differ from the host's")
    if len(checks["scheme"]) != 9:
        raise AssertionError(f"[fold] {len(checks['scheme'])} device commitments, not 4 lifts + "
                             f"3 comm_T + 2 checks")
    for ipa, tag in ((dec.ipa_e, "open_e"), (dec.ipa_w, "open_w")):
        if [n for n, _, _ in checks[tag]] != [ipa.n // 2] * 2:
            raise AssertionError(f"[fold] {tag}'s first round did not run on the device MSM")
    want = {}
    for tag, runs in checks.items():
        want[tag] = [fut.result() for _, _, fut in runs]
        for (n, got, _), w in zip(runs, want[tag]):
            if got != w:
                raise AssertionError(f"[fold] a device MSM of {tag} ({n} points) != msm_host")
    if ([i.comm_w for i, _ in lifted] != want["scheme"][:4]
            or [acc_i.comm_w, acc_i.comm_e] != want["scheme"][7:9]):
        raise AssertionError("[fold] a lifted or accumulated commitment differs from msm_host")
    times["host_checks"] = time.time() - t0
    log(f"[fold] exact: 13 device MSMs (4 lifted comm_w, 3 comm_T, the accumulator's comm_w and "
        f"comm_e, L and R of both openings' first round) equal msm_host, the accumulator's "
        f"commitments too, 64 device-cleared bases equal C.mul(_H1, P); msm_host in {workers} host "
        f"processes beside the phase, {times['host_checks']:.2f} s waited after it")

    # ---- the same instances through the mesh pipeline (parallel/)
    del scheme._msm.run  # stop recording: the mesh fold's check recommits
    comms, times["mesh_fold"], _ = mesh_fold(scheme, lifted, (acc_i, acc_w), mesh)
    if comms != want["scheme"][4:7]:
        raise AssertionError("[fold] the mesh fold's comm_T differ from msm_host's")
    log("[fold] the mesh fold's three comm_T equal msm_host's")
    return dict(cuda_lib.LAUNCHES), times


# ---------------------------------------------------------------- parallel
# the PoE's proving shapes at 49,152 blocks: the H query (d - 1 G1 points,
# d = 2^18) and the quotient's domain
PARALLEL_MSM_N = 262143
PARALLEL_NTT_LOG = 18


def open_mesh():
    """The parallel paths' mesh on the card: an NCCL group of world size 1
    (parallel/mesh.py make_mesh: a file store, no network)."""
    from contangle_zkcp_tpu_torch.parallel.mesh import make_mesh

    t0 = time.time()
    mesh = make_mesh(device="cuda")
    log(f"[mesh] {mesh.backend} group of world size {mesh.size}, rank {mesh.rank} on {mesh.device}, "
        f"axis {mesh.axis!r}: {time.time() - t0:.2f} s")
    return mesh


def mesh_fold(scheme, lifted, acc, mesh):
    """MeshFoldPipeline.fold_stream over the lifted instances: its
    accumulator must equal `acc` (the sequential tree's) in comm_w, comm_e,
    u, x, w and e, and check.  Returns (its comm_T in the tree's order, the
    seconds of the fold, the launches it made)."""
    from contangle_zkcp_tpu_torch.ops import cuda_lib
    from contangle_zkcp_tpu_torch.parallel.fold_pipeline import MeshFoldPipeline

    before = dict(cuda_lib.LAUNCHES)
    t0 = time.time()
    pipe = MeshFoldPipeline(scheme, mesh)
    comms, commit = [], pipe.commit_many

    def recorded(vecs):
        out = commit(vecs)
        comms.extend(out)
        return out

    pipe.commit_many = recorded
    inst, wit = pipe.fold_stream(lifted)
    torch.cuda.synchronize()
    secs = time.time() - t0
    acc_i, acc_w = acc
    for name, got, want in (("comm_w", inst.comm_w, acc_i.comm_w), ("comm_e", inst.comm_e, acc_i.comm_e),
                            ("u", inst.u, acc_i.u), ("x", inst.x, acc_i.x), ("w", wit.w, acc_w.w),
                            ("e", wit.e, acc_w.e)):
        if got != want:
            raise AssertionError(f"[fold] the mesh-folded accumulator's {name} differs from the "
                                 f"sequential tree's")
    if not scheme.check(inst, wit):
        raise AssertionError("[fold] the mesh-folded accumulator does not check")
    launches = {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items() if v - before.get(k, 0)}
    log(f"[fold] MeshFoldPipeline ({mesh.backend}, world size {mesh.size}; {pipe.n_pts} bases "
        f"sharded once, c = {pipe.msm.c}): tree fold {secs:.3f} s, {len(comms)} comm_T in "
        f"{len(lifted).bit_length() - 1} multi-vector MSMs; accumulator equal to the sequential "
        f"tree's (comm_w, comm_e, u, x, w, e) and checks; launches {json.dumps(launches, sort_keys=True)}")
    return comms, secs, launches


def fold_for_mesh(n_blocks: int, seed: int, mesh):
    """--parallel-only's fold: the [fold] phase's four instances, the
    sequential tree, and the mesh fold held to it (its comm_T equal to the
    tree's)."""
    from contangle_zkcp_tpu_torch.circuits.poe_shape import mini_poe_cs
    from contangle_zkcp_tpu_torch.groth16 import folding

    css = [mini_poe_cs(n_blocks, seed + 11 * (i + 1)) for i in range(4)]
    scheme = folding.FoldingScheme(css[0], device=mesh.device)
    lifted = [scheme.instance_from_cs(c) for c in css]
    seq, run = [], scheme._msm.run

    def recorded(points, scalars):
        seq.append(run(points, scalars))
        return seq[-1]

    scheme._msm.run = recorded
    i01, w01 = scheme.fold(*lifted[0], *lifted[1])
    i23, w23 = scheme.fold(*lifted[2], *lifted[3])
    acc = scheme.fold(i01, w01, i23, w23)
    del scheme._msm.run
    comms, _, _ = mesh_fold(scheme, lifted, acc, mesh)
    if comms != seq:
        raise AssertionError("[fold] the mesh fold's comm_T differ from the sequential tree's")


def run_parallel(seed: int, mesh):
    """The [parallel] phase (parallel/) on the card through the mesh (NCCL,
    world size 1: every local phase at full width, the collectives run):
    ShardedMSM on the PoE's H query (G1, 262,143 points k_i G from the
    card's fixed-base multiplier, witness-like scalars, the policy's
    window), run and run_scheduled each once, both equal to the exact host
    sum (sum s_i k_i) G and to the lockstep MSM.run on the same inputs; the
    four-step NTT at Fr 2^18 (n1 = n2 = 2^9: one batched pass of 512
    transforms a side) equal to NTT.forward limb for limb, in the default
    configuration and under ZKCP_MXU=1; ShardedNTT forward and inverse
    round-tripping at 2^18.  Prints ms, launches and peak memory.
    Returns (launches over the phase, seconds)."""
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.fields.bigint import ints_to_limbs
    from contangle_zkcp_tpu_torch.ops import cuda_lib
    from contangle_zkcp_tpu_torch.ops.fixed_base import FixedBaseDevice
    from contangle_zkcp_tpu_torch.ops.msm import MSM
    from contangle_zkcp_tpu_torch.ops.msm_policy import msm_config
    from contangle_zkcp_tpu_torch.ops.ntt import NTT
    from contangle_zkcp_tpu_torch.parallel import ShardedMSM, ShardedNTT
    from contangle_zkcp_tpu_torch.parallel.ntt_sharded import FourStepNTT

    C, R = ci.BLS12_381_G1, fi.BLS12_381_R
    dev = SWDevice(fi.bls12_381_fq(), C, device=mesh.device)
    rng = random.Random(seed + 17)
    cuda_lib.reset_launches()
    t_phase = time.time()
    times = {}

    def diff(before):
        return {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items() if v - before.get(k, 0)}

    # ---- ShardedMSM on the H query
    n = PARALLEL_MSM_N
    t0 = time.time()
    ks = [rng.randrange(1, R) for _ in range(n)]
    sc = [rng.randrange(R) if rng.random() < 0.5 else rng.randrange(2) for _ in range(n)]
    pts = FixedBaseDevice(dev, C.generator, R.bit_length(), chunk=1 << 16).mul_ints(ks)
    limbs = ints_to_limbs(sc, 16)
    want = dev.host_mul(sum(s * k for s, k in zip(sc, ks)) % R, C.generator)
    cut = 4096
    want_cut = dev.host_mul(sum(s * k for s, k in zip(sc[:cut], ks[:cut])) % R, C.generator)
    torch.cuda.synchronize()
    cfg = msm_config("g1", n)
    msm = MSM(dev, 255, c=cfg.c, signed=cfg.signed)
    sharded = ShardedMSM(msm, mesh)
    log(f"[parallel] ShardedMSM g1 n={n} witness-like scalars, c={cfg.c} signed={cfg.signed} "
        f"({sharded.slots} partial slots a rank): points and the exact sum in {time.time() - t0:.2f} s")
    runs = (("msm_lockstep", "lockstep MSM.run", msm.run),
            ("msm_run", "ShardedMSM.run", sharded.run),
            ("msm_run_scheduled", "ShardedMSM.run_scheduled", sharded.run_scheduled))
    for _, name, fn in runs:  # warm-up, checked: the 4,096-point slice
        if fn({k: v[:cut] for k, v in pts.items()}, limbs[:cut]) != want_cut:
            raise AssertionError(f"[parallel] {name} on the {cut}-point slice != the exact host sum")
    for key, name, fn in runs:
        before = dict(cuda_lib.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got = fn(pts, limbs)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        if got != want:
            raise AssertionError(f"[parallel] {name} g1 n={n}: result != the exact host sum")
        times[key] = ms / 1e3
        log(f"[parallel] {name}: {ms:.1f} ms, equal to the exact host sum"
            f"{' and to the lockstep MSM.run' if 'Sharded' in name else ''}; launches "
            f"{json.dumps(diff(before), sort_keys=True)}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pts
    torch.cuda.empty_cache()

    # ---- the four-step and sharded NTTs at the PoE's domain
    F, logn = fi.bls12_381_fr(), PARALLEL_NTT_LOG
    n = 1 << logn
    a = random_field(F, n, np.random.default_rng(seed + 19))
    ntt = NTT(F, n, device=mesh.device)
    t0 = time.time()
    four = FourStepNTT(F, n, mesh)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    want = ntt.forward(a)
    before = dict(cuda_lib.LAUNCHES)
    check("FourStepNTT", four.forward(a), want, f"NTT.forward (Fr 2^{logn})")
    calls = {"default": diff(before)}
    os.environ["ZKCP_MXU"] = "1"
    try:
        before = dict(cuda_lib.LAUNCHES)
        check("FourStepNTT under ZKCP_MXU=1", four.forward(a), want, f"NTT.forward (Fr 2^{logn})")
        calls["ZKCP_MXU=1"] = diff(before)
        ms_four5 = cuda_ms(lambda: four.forward(a), 10)
        ms_one5 = cuda_ms(lambda: ntt.forward(a), 10)
    finally:
        os.environ.pop("ZKCP_MXU", None)
    sh = ShardedNTT(ntt, mesh)
    ev = sh.forward(sh.shard(a))
    check("ShardedNTT", mesh.gather(ev), want, f"NTT.forward (Fr 2^{logn})")
    check("ShardedNTT", mesh.gather(sh.inverse(ev)), a, "its input after forward and inverse")
    ms_four = cuda_ms(lambda: four.forward(a), 10)
    ms_one = cuda_ms(lambda: ntt.forward(a), 10)
    mat = a.reshape(four.n1, four.n2, F.L)
    ms_a2a = cuda_ms(lambda: mesh.all_to_all(mat, split_axis=1, concat_axis=0), 10)
    times.update(ntt_four_step_ms=ms_four, ntt_forward_ms=ms_one, ntt_four_step_mxu_ms=ms_four5,
                 ntt_forward_mxu_ms=ms_one5, ntt_setup=t_setup, all_to_all_ms=ms_a2a)
    log(f"[parallel] FourStepNTT Fr n=2^{logn} (n1 = {four.n1}, n2 = {four.n2}; twiddle slab made on "
        f"the card in {t_setup:.3f} s): equal to NTT.forward limb for limb, default and ZKCP_MXU=1; "
        f"ShardedNTT forward equal and inverse round-trips; ms a transform (CUDA events, no graph) "
        f"four-step {ms_four:.4f} vs NTT.forward {ms_one:.4f} ({ms_four / ms_one:.2f}x), under "
        f"ZKCP_MXU=1 {ms_four5:.4f} vs {ms_one5:.4f}; one of its three all-to-alls {ms_a2a:.4f} ms; "
        f"launches a four-step call {json.dumps(calls, sort_keys=True)}")
    launches = dict(cuda_lib.LAUNCHES)
    times["parallel"] = time.time() - t_phase
    log(f"[parallel] launches over the phase: {json.dumps(launches, sort_keys=True)}; "
        f"{times['parallel']:.2f} s")
    for k in ("k1_mont_mul", "k2_ntt_pass", "k3_sw_add", "k5a_mont_mul_mma", "k5b_ntt_pass"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched by the [parallel] phase")
    for k in OFF_PATH + ("k5c_sw_add_mma",):
        if launches.get(k, 0):
            raise AssertionError(f"kernel {k} launched by the [parallel] phase")
    return launches, times


# -------------------------------------------------------------------- sale
def run_sale(n_blocks: int, seed: int):
    """The whole ZKCP sale under ZKCP_MXU=1, real Groth16 throughout: the
    reference's real-proof drive (benchmarks/drive_protocol_real.py, after
    the Rust CLI's compile -> sell -> buy) on the port, at n_blocks one-byte
    data blocks.  Returns (launches over the sale, per-step seconds)."""
    import asyncio
    import tempfile
    from pathlib import Path

    from contangle_zkcp_tpu_torch.circuits import elgamal
    from contangle_zkcp_tpu_torch.curves import instances as ci
    from contangle_zkcp_tpu_torch.groth16 import groth16 as g16mod
    from contangle_zkcp_tpu_torch.ops import cuda_lib
    from contangle_zkcp_tpu_torch.utils import metrics
    from contangle_zkcp_tpu_torch.utils.errors import ProtocolError
    from contangle_zkcp_tpu_torch.zkcp import (
        Buyer, BuyerConfig, CircomParams, LocalWallet, Seller, SellerConfig, ZkConfig,
        ZkSampleEntries, ZkVerifiableEncryption, secp,
    )
    from contangle_zkcp_tpu_torch.zkcp.cipher_host import LocalHost
    from contangle_zkcp_tpu_torch.zkcp.client import SellerClient
    from contangle_zkcp_tpu_torch.zkcp.ethereum import MockChain
    from contangle_zkcp_tpu_torch.zkcp.server import SellerServer
    from contangle_zkcp_tpu_torch.zkcp.zk_encryption import ZkEncryption

    price = 0.25
    base = os.path.join(ROOT, "contangle_zkcp_tpu_torch", "build")
    os.makedirs(base, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sale_", dir=base))
    cfg = ZkConfig(
        prop_verifier_dir=str(tmp / "prop"),
        data_encryption_dir=str(tmp / "data_enc"),
        data_encryption_limit=n_blocks,
        key_encryption_dir=str(tmp / "key_enc"),
        circom_params=CircomParams(),
        backend="groth16",
    )
    # one byte per block; no zero byte: the protocol's chunks_to_bytes
    # drops zero bytes (the reference's circuits-ark/src/utils.rs quirk,
    # utils/chunks.py)
    data = np.random.default_rng(seed + 2).integers(1, 256, size=n_blocks, dtype=np.uint8).tobytes()
    rng = random.Random(seed)
    times = {}
    os.environ["ZKCP_MXU"] = "1"
    metrics.registry().reset()
    cuda_lib.reset_launches()
    seen = {}
    domains = set()  # the Groth16 provers' NTT sizes over the sale
    engine = g16mod._ntt_engine
    g16mod._ntt_engine = lambda Fr, d, device: domains.add(d) or engine(Fr, d, device)

    def proving_s():
        return metrics.registry().snapshot()["timers"].get("groth16.prove", {}).get("total_sec", 0.0)

    def step(name, t0, note=""):
        """One line per step: seconds, Groth16 proving seconds within them,
        and the kernel launches since the last step."""
        torch.cuda.synchronize()
        times[name] = time.time() - t0
        now = dict(cuda_lib.LAUNCHES, prove=proving_s())
        delta = {k: v - seen.get(k, 0) for k, v in now.items() if v - seen.get(k, 0)}
        seen.update(now)
        prove = delta.pop("prove", 0.0)
        log(f"[sale] {name}: {times[name]:.3f} s{note}; proving {prove:.3f} s; "
            f"launches {json.dumps(delta, sort_keys=True)}")

    try:

        t0 = time.time()
        ZkVerifiableEncryption(
            cfg.data_encryption_dir,
            ZkSampleEntries(cfg.prop_verifier_dir, n_blocks),
            elgamal.ElGamalParams(curve=ci.JUBJUB, n=n_blocks),
        ).compile(rng)
        ZkEncryption(cfg.key_encryption_dir).compile(rng)
        step("compile", t0, f" (data encryption n={n_blocks}, SampleEntries, key encryption n=1)")

        chain = MockChain()
        seller_wallet = LocalWallet.new(random.Random(seed + 63))
        buyer_wallet = LocalWallet.new(random.Random(seed + 64))
        t0 = time.time()
        seller = Seller(
            SellerConfig(price=price, cache_dir=str(tmp / "cache"), zk=cfg),
            chain, LocalHost(tmp / "hosted"), ZkSampleEntries(cfg.prop_verifier_dir, n_blocks),
            seller_wallet,
        )
        step("seller start (read the key files)", t0)
        t0 = time.time()
        seller.step0_setup(data)
        step("seller step 0 (PoE + SampleEntries proof)", t0)

        async def scenario():
            server = SellerServer(seller, price, port=0)
            await server.start()
            actor = asyncio.create_task(seller.run())

            def buyer_flow():
                client = SellerClient(f"http://127.0.0.1:{server.port}")
                if client.price() != price:
                    raise AssertionError("seller quotes another price")
                t = time.time()
                buyer = Buyer(
                    BuyerConfig(zk=cfg), chain,
                    ZkSampleEntries.new_verifier(cfg.prop_verifier_dir, n_blocks), buyer_wallet,
                )
                step("buyer start (read the key files)", t)
                t = time.time()
                ve = client.download()
                if not buyer.step0_verify(ve):
                    raise AssertionError("buyer rejected the verifiable encryption")
                step("buyer step 0 (download, verify PoE + property, device Merkle root)", t,
                     f", ciphertext {len(ve.ciphertext)} bytes")
                t = time.time()
                step1 = client.step1(chain.address_from_pk(buyer_wallet.pub_key()))
                step("seller step 1 (key encryption + proof)", t)
                t = time.time()
                enc_sig = buyer.step2(step1.ciphertext, step1.proof_of_encryption, step1.data_pk,
                                      step1.seller_address, price)
                step("buyer step 2 (verify key PoE, adaptor-sign the payment)", t)
                t = time.time()
                tx_hash = client.step3(buyer_wallet.pub_key(), enc_sig)
                step("seller step 3 (check adaptor signature, broadcast)", t)
                # a second buyer signs another amount: the seller must refuse
                cheat = LocalWallet.new(random.Random(seed + 65))
                t = time.time()
                s1 = client.step1(chain.address_from_pk(cheat.pub_key()))
                _, wrong = chain.compose_tx(chain.address_from_pk(cheat.pub_key()),
                                            s1.seller_address, price / 2)
                try:
                    client.step3(cheat.pub_key(), secp.encrypted_sign(cheat.sec_key(), s1.data_pk, wrong))
                except ProtocolError as e:
                    if "invalid adaptor signature" not in str(e):
                        raise
                else:
                    raise AssertionError("seller accepted a tampered adaptor signature")
                step("tampered adaptor signature refused at step 3", t)
                return buyer, ve, tx_hash

            try:
                buyer, ve, tx_hash = await asyncio.get_running_loop().run_in_executor(None, buyer_flow)
                t = time.time()
                plain = await buyer.step4(tx_hash, ve.ciphertext)
                step("buyer step 4 (recover the key, decrypt)", t)
                return plain
            finally:
                server.close()
                actor.cancel()

        t_sale = time.time()
        plain = asyncio.run(scenario())
        if plain != data:
            raise AssertionError("the buyer's plaintext differs from the seller's data")
        paid = chain.balances.get(chain.address_from_pk(seller_wallet.pub_key()), 0)
        if paid != int(price * 10**18):
            raise AssertionError(f"seller balance {paid} wei, expected the price")
        times["protocol"] = time.time() - t_sale
        log(f"[sale] plaintext {len(plain)} bytes equal to the data; seller paid {paid} wei; "
            f"steps 0b-4 {times['protocol']:.3f} s")
    finally:
        os.environ.pop("ZKCP_MXU", None)
        g16mod._ntt_engine = engine
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(cuda_lib.LAUNCHES)
    log(f"[sale] NTT domains: {', '.join(f'2^{d.bit_length() - 1}' for d in sorted(domains))}")
    log(f"[sale] launches over the sale: {json.dumps(launches, sort_keys=True)}")
    for k in MXU_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched in the sale under ZKCP_MXU=1")
    for k in DEFAULT_KERNELS + OFF_PATH:
        if launches.get(k, 0):
            raise AssertionError(f"kernel {k} launched under ZKCP_MXU=1")
    snap = metrics.registry().snapshot()
    timers = {k: round(v["total_sec"], 4) for k, v in sorted(snap["timers"].items())
              if k.startswith(("groth16.", "seller.", "buyer."))}
    log(f"[sale] timers (s): {json.dumps(timers)}; {balanced_note()}")
    return launches, times


# ------------------------------------------------------------------ plonk
def elgamal_instance(n: int, seed: int):
    """The reference's ElGamal circuit over Pallas (benchmarks/
    drive_plonk_k12.py) synthesized at n rows: (meta, assignment,
    instances, tampered instances)."""
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.plonkish import (
        Assignment, CircuitMeta, ElGamalCircuit, ElGamalPallas,
    )

    scheme = ElGamalPallas()
    rng = random.Random(seed)
    _, pk = scheme.keygen(rng)
    r = rng.randrange(1, scheme.curve.order)
    m = rng.randrange(scheme.curve.p)
    (c1, c2), s = scheme.encrypt(pk, m, r)
    meta = CircuitMeta(p=fi.PASTA_P)
    circ = ElGamalCircuit.build(meta, s, c1, m, c2)
    asg = Assignment(meta, n)
    circ.synthesize(meta, asg)
    return meta, asg, [[c1[0], c1[1], c2]], [[c1[0], c1[1], (c2 + 1) % fi.PASTA_P]]


def plonk_exact(seed: int) -> str:
    """The card's PLONKish path held exactly to the same code on the CPU
    (the kernels' twins): the n = 128 ElGamal key and proof, with one
    blinding seed, must be equal field for field.  Its IPA has 256
    generators, so it folds them on the host; one opening of IPA(1024)
    on the card, whose generator fold runs on the device (255-bit ladders
    of K3 on Vesta), must equal the host fold's (the twins take minutes
    for that fold on a CPU; tests/test_torch_plonk_jax.py holds them to
    the reference's host fold)."""
    from contangle_zkcp_tpu_torch.fields import instances as fi
    from contangle_zkcp_tpu_torch.plonkish.convert import fields
    from contangle_zkcp_tpu_torch.plonkish.ipa import IPA
    from contangle_zkcp_tpu_torch.plonkish.prover import PlonkSystem

    meta, asg, inst, _ = elgamal_instance(128, seed + 201)
    proofs = []
    for device in ("cuda", "cpu"):
        system = PlonkSystem(meta, 128, asg, use_device=True, device=device)
        proofs.append(fields(system.prove(asg, inst, rng=random.Random(seed + 5))))
        proofs.append(fields(system.pk))
    if proofs[0] != proofs[2] or proofs[1] != proofs[3]:
        raise AssertionError("n=128 PLONK proof or key on the card != the CPU's")
    rng = random.Random(seed + 6)
    coeffs = [rng.randrange(fi.PASTA_P) for _ in range(1024)]
    x = rng.randrange(fi.PASTA_P)
    card = fields(IPA(1024, use_device_msm=True, device="cuda").open(coeffs, x))
    if card != fields(IPA(1024).open(coeffs, x)):
        raise AssertionError("IPA(1024) opening (device fold) on the card != the host fold's")
    return ("n=128 key and proof equal to the CPU's; an IPA(1024) opening with the device "
            "fold equal to the host fold's")


def run_plonk(n: int, seed: int, own: bool = True):
    """The halo2-path PLONKish prover on the card (benchmarks/
    drive_plonk_k12.py on the port): the ElGamal circuit over Pallas at
    n rows (the reference's k = 12), setup, two proves (the second warm),
    verify, a tampered instance refused; in the default configuration
    (K1-K3).  `own`: the package is this checkout's, so the kernels it
    launched must be this tree's path.  Returns (launches over the phase,
    seconds)."""
    from contangle_zkcp_tpu_torch.ops import cuda_lib
    from contangle_zkcp_tpu_torch.plonkish.prover import PlonkSystem
    from contangle_zkcp_tpu_torch.utils import metrics

    meta, asg, inst, bad = elgamal_instance(n, seed + 7)
    times = {}
    metrics.registry().reset()
    cuda_lib.reset_launches()
    t0 = time.time()
    system = PlonkSystem(meta, n, asg, use_device=True, device="cuda")
    torch.cuda.synchronize()
    times["setup"] = time.time() - t0
    timers = {k: round(v["total_sec"], 4) for k, v in sorted(metrics.registry().snapshot()["timers"].items())
              if k.startswith("plonk.setup.")}
    log(f"[plonk] setup n={n} (ext {system.ext}, IPA {system.ipa.n} generators): "
        f"{times['setup']:.3f} s; launches {json.dumps(dict(cuda_lib.LAUNCHES), sort_keys=True)}; "
        f"timers (s) {json.dumps(timers)}")
    for rep, name in enumerate(("prove_cold", "prove_warm")):
        metrics.registry().reset()
        before = dict(cuda_lib.LAUNCHES)
        t0 = time.time()
        proof = system.prove(asg, inst, rng=random.Random(seed + 100 + rep))
        torch.cuda.synchronize()
        times[name] = time.time() - t0
        delta = {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items() if v - before.get(k, 0)}
        timers = {k: round(v["total_sec"], 4) for k, v in sorted(metrics.registry().snapshot()["timers"].items())
                  if k.startswith(("plonk.", "msm."))}
        log(f"[plonk] {name.replace('_', ' ')}: {times[name]:.3f} s; launches "
            f"{json.dumps(delta, sort_keys=True)}; timers (s) {json.dumps(timers)}")
    t0 = time.time()
    if not system.verify(proof, inst):
        raise AssertionError("PLONK verifier rejected the proof")
    times["verify"] = time.time() - t0
    log(f"[plonk] verify: accepted, {times['verify']:.3f} s")
    t0 = time.time()
    if system.verify(proof, bad):
        raise AssertionError("PLONK verifier accepted a tampered instance")
    log(f"[plonk] tampered instance: rejected, {time.time() - t0:.3f} s")
    launches = dict(cuda_lib.LAUNCHES)
    log(f"[plonk] launches over the phase: {json.dumps(launches, sort_keys=True)}")
    for k in DEFAULT_KERNELS if own else ():
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"kernel {k} was not launched on the PLONKish path")
    for k in MXU_KERNELS + OFF_PATH if own else ():
        if launches.get(k, 0):
            raise AssertionError(f"kernel {k} launched in the default configuration")
    return launches, times


# name, source, TPU kernel it replaces, record key (Fr or the only shape),
# Fq record key, shape
KERNEL_ROWS = (
    ("k1_mont_mul", "k1_mont_mul.cu", "contangle_zkcp_tpu/ops/pallas_mont.py:287",
     "k1_bls12_381_fr", "k1_bls12_381_fq", "fr n=2^18"),
    ("k2_butterfly", "k2_butterfly.cu", "contangle_zkcp_tpu/ops/pallas_mont.py:371",
     "k2", None, "fr n/2=2^17"),
    ("k2_ntt_pass", "k2_ntt.cu", "contangle_zkcp_tpu/ops/pallas_mont.py:371",
     "k2_ntt_bls12_381_fr_2e18_forward", None, "fr n=2^18 forward, one transform"),
    ("k3_sw_add", "k3_sw_add.cu", "contangle_zkcp_tpu/ops/pallas_curve.py:188",
     "k3", None, "g1 n=2^16"),
    ("k4_field_mul", "k1_mont_mul.cu", "contangle_zkcp_tpu/ops/pallas_field.py:156",
     "k4_bls12_381_fr", "k4_bls12_381_fq", "fr n=2^18"),
    ("k5a_mont_mul_mma", "k5a_mont_mul_mma.cu", "contangle_zkcp_tpu/ops/pallas_mont.py:272",
     "k5a_bls12_381_fr", "k5a_bls12_381_fq", "fr n=2^18"),
    ("k5b_butterfly_mma", "k5b_butterfly_mma.cu", "contangle_zkcp_tpu/ops/pallas_mont.py:325",
     "k5b", None, "fr n/2=2^17"),
    ("k5b_ntt_pass", "k5b_ntt_mma.cu", "contangle_zkcp_tpu/ops/pallas_mont.py:325",
     "k5b_ntt_bls12_381_fr_2e18_forward", None, "fr n=2^18 forward, one transform (ZKCP_MXU=1)"),
    ("k5c_sw_add_mma", "k5c_sw_add_mma.cu", "contangle_zkcp_tpu/ops/pallas_curve.py:153",
     "k5c", None, "g1 n=2^16"),
)


# the transforms timed (check_ntt; the sale's domains as its "[sale] NTT
# domains" line reads them), and the PLONKish path's shapes and the W = 24
# ones, per kernel (record keys)
NTT_SHAPES = (("bls12_381_fr", 18), ("bls12_381_fr", 19), ("bls12_381_fr", 15),
              ("bls12_381_fr", 14), ("bls12_381_fr", 13), ("pasta_fp", 15), ("pasta_fp", 12))
MORE_SHAPES = {
    "k1_mont_mul": ("k1_pasta_fp", "k1_bw6"),
    "k2_butterfly": ("k2_pasta_fp", "k2_bw6"),
    "k2_ntt_pass": tuple(f"k2_ntt_{f}_2e{k}_{op}" for f, k in NTT_SHAPES for op in NTT_OPS)[1:]
    + tuple(f"k2_ntt_batch_{b}x2e{k}" for b, k in NTT_BATCHES),
    "k5b_ntt_pass": tuple(f"k5b_ntt_{f}_2e{k}_{op}" for f, k in NTT_SHAPES for op in NTT_OPS)[1:]
    + tuple(f"k5b_ntt_batch_{b}x2e{k}" for b, k in NTT_BATCHES),
    "k3_sw_add": ("k3_vesta_2e12", "k3_vesta_2e16"),
    "k4_field_mul": ("k4_bw6",),
    "k5a_mont_mul_mma": ("k5a_bw6",),
    "k5b_butterfly_mma": ("k5b_bw6",),
    "k5c_sw_add_mma": ("k5c_vesta",),
}


def kernel_line(recs, launches):
    """The {"kernels": [...]} records.  `launches` is the sum over the
    driven paths (the [msm] and [edwards] phases, the PoE, the Proof of
    Property, the folding accumulator and its decider with the mesh fold
    ([fold]), the parallel paths ([parallel]: the sharded MSM, the
    four-step NTT, default and ZKCP_MXU=1) and the PLONKish prover in the
    default configuration, the sale under ZKCP_MXU=1),
    `launches_by_path` each path's own count (K4 is on none: reached only through its own entry
    point, ops/field_mul.py); `more` holds the other shapes checked."""
    out = []
    for name, src, replaces, key, fq_key, shape in KERNEL_ROWS:
        r = recs[key]
        by_path = {p: c.get(name, 0) for p, c in launches.items()}
        row = dict(name=name, route="cuda", source="contangle_zkcp_tpu_torch/csrc/" + src,
                   replaces=replaces, launches=sum(by_path.values()),
                   max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                   bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
                   shape=shape, launches_by_path=by_path,
                   more=[{k: recs[m][k] for k in ("shape", "err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by")}
                         for m in MORE_SHAPES[name]])
        if "ms_n2e20" in r:
            row.update(ms_n2e20=r["ms_n2e20"], bound_ms_n2e20=r["bound_ms_n2e20"])
        if name == "k3_sw_add":
            row.update(fold=recs["k3_fold"])
        if name in ("k2_ntt_pass", "k5b_ntt_pass"):
            row.update(old_ms=r["old_ms"], wall_ms=r["wall_ms"], plan=r["plan"])
            for m, rec in zip(MORE_SHAPES[name], row["more"]):
                rec.update(old_ms=recs[m]["old_ms"], wall_ms=recs[m]["wall_ms"], plan=recs[m]["plan"])
        if fq_key:
            f = recs[fq_key]
            row.update(fq_ms=f["ms"], fq_plain_ms=f["plain_ms"], fq_bound_ms=f["bound_ms"])
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=49152, help="PoE blocks (default 49152)")
    ap.add_argument("--sale-blocks", type=int, default=65536,
                    help="data blocks of the sale, a power of two (default 65536)")
    ap.add_argument("--plonk-rows", type=int, default=4096,
                    help="rows of the PLONKish ElGamal circuit, a power of two (default 4096, k = 12)")
    ap.add_argument("--fold-blocks", type=int, default=1024,
                    help="blocks of each PoE-shaped instance the [fold] phase folds (default 1024)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (a quick run; prints no result line)")
    ap.add_argument("--plonk-only", action="store_true",
                    help="the build and the [plonk] phase alone (prints no result line)")
    ap.add_argument("--msm-only", action="store_true",
                    help="the build, the MSM checks and the [msm] phase alone (prints no result line)")
    ap.add_argument("--fold-only", action="store_true",
                    help="the build and the [fold] phase alone (prints no result line)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="the build and the [parallel] phase alone, with the mesh fold of the [fold] "
                         "phase's instances (prints no result line)")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose port package is driven (default: this script's)")
    args = ap.parse_args()
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    try:
        from contangle_zkcp_tpu_torch.ops import cuda_lib
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 2
    os.environ.pop("ZKCP_MXU", None)  # the default configuration until the sale

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}; nvidia-smi: {smi}")

    t0 = time.time()
    path = cuda_lib.build(verbose=False)
    cuda_lib.lib()
    log(f"[build] {os.path.relpath(path, ROOT)} in {time.time() - t0:.2f} s "
        f"(one nvcc per source, all started together, sm_90a)")

    mesh = None
    try:
        if args.plonk_only:
            run_plonk(args.plonk_rows, args.seed, own=os.path.samefile(args.root, ROOT))
            log(f"[done] plonk phase only: wall {time.time() - t_start:.1f} s")
            return 0
        if args.fold_only or args.parallel_only:
            mesh = open_mesh()
        if args.fold_only:
            run_fold(args.fold_blocks, args.seed, mesh)
            log(f"[done] fold phase only: wall {time.time() - t_start:.1f} s")
            return 0
        if args.parallel_only:
            run_parallel(args.seed, mesh)
            fold_for_mesh(args.fold_blocks, args.seed, mesh)
            log(f"[done] parallel phase only: wall {time.time() - t_start:.1f} s")
            return 0
        recs = {}
        if not args.msm_only:
            from contangle_zkcp_tpu_torch.utils import profiling

            log(f"[bound] integer rate: {profiling.set_int_rate()}; int8 tensor rate "
                f"{profiling.INT8_MMA_OPS_PER_S:.4g} op/s")
            recs = check_kernels(args.seed)
        if args.kernels_only:
            log(f"[done] kernel checks only: wall {time.time() - t_start:.1f} s")
            return 0

        t0 = time.time()
        note = msm_check(args.seed)
        log(f"[msm] {note}: {time.time() - t0:.2f} s")
        launches, times = {}, {}
        launches["msm"], times["msm"] = run_msm(args.seed)
        if args.msm_only:
            log(f"[done] msm phases only: wall {time.time() - t_start:.1f} s")
            return 0
        launches["edwards"], times["edwards"] = run_edwards(args.seed)

        t0 = time.time()
        toy_golden()
        log(f"[golden] toy Groth16 pk/vk/proof bytes equal the pinned golden, "
            f"proof verifies: {time.time() - t0:.2f} s")

        launches["poe"], times["poe"] = run_slice(args.blocks, args.seed)
        launches["property"], times["property"] = run_property(args.blocks, args.seed)
        mesh = open_mesh()
        launches["fold"], times["fold"] = run_fold(args.fold_blocks, args.seed, mesh)
        launches["parallel"], times["parallel"] = run_parallel(args.seed, mesh)
        launches["sale"], times["sale"] = run_sale(args.sale_blocks, args.seed)

        t0 = time.time()
        note = plonk_exact(args.seed)
        log(f"[plonk] exact check: {note}: {time.time() - t0:.2f} s")
        launches["plonk"], times["plonk"] = run_plonk(args.plonk_rows, args.seed)
    finally:
        if mesh is not None:
            mesh.close()

    log(f"[done] wall {time.time() - t_start:.1f} s; phases (s): "
        f"{json.dumps({p: {k: round(v, 3) for k, v in t.items()} for p, t in times.items()})}")
    print(json.dumps({"kernels": kernel_line(recs, launches)}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
