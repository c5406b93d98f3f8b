"""Profiling helpers: a torch.profiler trace, and the kernels' cost table.

Port of `contangle_zkcp_tpu/utils/profiling.py`.  Where the reference asks
XLA's profiler for a trace and its cost model for a program's FLOPs and
bytes, the port's kernels are hand-written, so their work is counted
here from their designs:

  * `trace(log_dir)`: a torch.profiler context (CPU and, when a card is
    present, CUDA activities) that writes a Chrome trace;
  * the counts of each kernel's work — bytes moved (each input read once,
    each output written once), 32-bit integer instructions and int8
    tensor-core operations (`madds`, `k3_int_ops`, `k2_ntt_int_ops`,
    `k5b_ntt_counts`, ...) — and `bound`, the least time the card could
    take for them;
  * `cost_table(kernel, F, n, wall_sec)` and `report(...)`: one kernel's
    counts, bound and, given a wall time, its share of that bound.

chip_smoke.py takes its bounds from here.

The rates are an NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit:
  * memory: 3.35 TB/s (NVIDIA data sheet);
  * integer: the data sheet gives no integer rate, so the bound uses the
    integer pipe's issue rate on compute capability 9.0, 64 32-bit integer
    multiply-add (or add) results a clock an SM (CUDA C++ Programming
    Guide, arithmetic instruction throughput), times the SMs and the
    maximum SM clock: 132 x 64 x 1980 MHz = 16.73 T/s by default, read
    from the card by `set_int_rate()`.  A 32x32->64-bit multiply-add is
    two instructions (low and high halves); only the multiply-adds and
    the word-wise add/subtract chains are counted, so the bound stays a
    floor;
  * int8 tensor cores (dense): 1,979 T op/s (data sheet), for the K5
    kernels' constant products.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess

import torch

PEAK_BYTES_PER_S = 3.35e12
INT8_MMA_OPS_PER_S = 1.979e15
MMA_OPS = 2 * 16 * 8 * 32  # one mma.sync.m16n8k32: 4096 multiply-adds
INT_OPS_PER_CLOCK_PER_SM = 64
H100_SMS = 132
H100_MAX_SM_MHZ = 1980.0
PEAK_OPS_PER_S = H100_SMS * INT_OPS_PER_CLOCK_PER_SM * H100_MAX_SM_MHZ * 1e6

TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "trace"
)


@contextlib.contextmanager
def trace(log_dir: str = TRACE_DIR):
    """Profile the body with torch.profiler (CPU activities, and CUDA
    when a card is present); yields the profiler, whose events the caller
    may read after the block, and writes `log_dir/trace.json`, a Chrome
    trace (chrome://tracing, Perfetto)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def set_int_rate() -> str:
    """PEAK_OPS_PER_S = SMs x 64 per clock x max SM clock of card 0;
    returns a note."""
    global PEAK_OPS_PER_S
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    src = "nvidia-smi clocks.max.sm"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
        )
        mhz = float(out.stdout.split()[0])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        mhz, src = H100_MAX_SM_MHZ, "H100 SXM data-sheet boost clock (nvidia-smi gave none)"
    PEAK_OPS_PER_S = sms * INT_OPS_PER_CLOCK_PER_SM * mhz * 1e6
    return (f"{sms} SMs x {INT_OPS_PER_CLOCK_PER_SM}/clock x {mhz:.0f} MHz ({src}) "
            f"= {PEAK_OPS_PER_S:.4g} int32 op/s")


def bound(nbytes: float, ops: float, mma_ops: float = 0.0):
    """Least time in ms: bytes at the memory rate, integer instructions at
    the integer rate, tensor-core operations at the int8 rate."""
    tb = nbytes / PEAK_BYTES_PER_S
    to = max(ops / PEAK_OPS_PER_S, mma_ops / INT8_MMA_OPS_PER_S)
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


# ------------------------------------------------------------------ counts
def madds(F):
    """32x32->64-bit multiply-adds of one CIOS Montgomery product (K1)."""
    w = F.L // 2
    return 2 * w * w + w


def mma_int_ops(F):
    """Integer instructions left to a K5 Montgomery product: the a*b
    schoolbook (W^2 multiply-adds, two instructions each), the fold of 3W
    output words and the final subtract (one per word)."""
    w = F.L // 2
    return 2 * w * w + 4 * w


def mma_ops_per_elem(F):
    """Tensor-core operations of one K5 Montgomery product: the mma.sync
    issued per 8 elements (structurally zero tiles skipped, as
    csrc/k5_mma.cuh tile_used does), over 8."""
    from ..ops import mont_mma

    w, ks, mt_np, mt_p = mont_mma.mma_shape(F.L)
    tiles = sum(mont_mma.tile_used(mt, k, w) for mt in range(mt_np) for k in range(ks))
    tiles += sum(mont_mma.tile_used(mt, k, w) for mt in range(mt_p) for k in range(ks))
    return tiles * MMA_OPS / 8


def k2_ntt_int_ops(F, n: int, scaled: bool):
    """Integer instructions of one n-point transform through k2_ntt_pass:
    (n/2) log2 n butterflies of 2 madds + 4W (a Montgomery product, two
    instructions a multiply-add, and the add and subtract chains of 2W
    each; chip_smoke's K2 count), plus n Montgomery products when a pre-
    or post-scale is fused."""
    w = F.L // 2
    logn = n.bit_length() - 1
    return (n // 2) * logn * (2 * madds(F) + 4 * w) + (n * 2 * madds(F) if scaled else 0)


def k3_int_ops(F):
    """Integer instructions of one K3 point add as csrc/fp_lazy.cuh and
    k3_sw_add.cu issue them (selects and masks not counted, so a floor):
    10 multiplies of 4W^2 + 5W - 2 (row 0: 2W products + a reduction of
    2W + 2; rows 1..W-1: 4W + 4; the final shift W), 6 sums of canonical
    inputs (W each), 16 lazy adds and 5 lazy subtracts (2W each: the
    chain and its correction) and 3 canonicalisations (W): 40W^2 + 101W
    - 20, 6,952 for W = 12."""
    w = F.L // 2
    return 10 * (4 * w * w + 5 * w - 2) + 6 * w + 21 * 2 * w + 3 * w


def k5c_int_ops(F):
    """Integer instructions of one K5c point add (csrc/k5c_sw_add_mma.cu):
    10 a*b schoolbooks of 2W^2 + 2W - 1 and folds of 3W words (m: W, m p:
    2W; one each, as mma_int_ops), and the adds of k3_int_ops: 20W^2 +
    101W - 10, 4,082 for W = 12."""
    w = F.L // 2
    return 10 * (2 * w * w + 5 * w - 1) + 6 * w + 21 * 2 * w + 3 * w


def k3_strict_int_ops(F):
    """Integer instructions of one K3 point add in the strict arithmetic
    (csrc/fp_lazy.cuh S = true, mont.cuh's operations), counted as
    k3_int_ops counts: 12 multiplies (3b = 15 takes the general multiply
    twice) of 4W^2 + 5W (the two W^2 multiply-add rows, each row's top
    words and m, the final subtract and select), and 19 modular adds and
    subtracts of 3W (the chain, the correction chain, the select):
    48W^2 + 117W, 4,008 for W = 8 (the lazy count's formula gives 3,348
    there)."""
    w = F.L // 2
    return 12 * (4 * w * w + 5 * w) + 19 * 3 * w


def k5c_strict_int_ops(F):
    """K5c's integer instructions in the strict arithmetic: 12 a*b
    schoolbooks and folds (as k5c_int_ops), a conditional subtract of p
    after each (2W), and the 19 modular adds and subtracts of
    k3_strict_int_ops."""
    w = F.L // 2
    return 12 * (2 * w * w + 5 * w - 1) + 12 * 2 * w + 19 * 3 * w


def k5b_ntt_counts(F, n: int, scaled: bool):
    """(integer instructions, tensor-core operations) of one n-point
    transform through k5b_ntt_pass: (n/2) log2 n butterflies of a K5
    Montgomery product (mma_int_ops, mma_ops_per_elem) and an add and a
    subtract (4W), plus n products when a pre- or post-scale is fused."""
    w = F.L // 2
    bfs = (n // 2) * (n.bit_length() - 1)
    muls = bfs + (n if scaled else 0)
    return bfs * 4 * w + muls * mma_int_ops(F), muls * mma_ops_per_elem(F)


def strict(F) -> bool:
    """The point adds' arithmetic for F: strict where 4p >= R (the Pasta
    fields), lazy otherwise (ops/curve_add.py kernel_b3)."""
    return 4 * F.p >= F.R


def counts(kernel: str, F, n: int):
    """(bytes, integer instructions, tensor-core operations) of one
    launch's work, as chip_smoke.py counts it: n products (K1, K4, K5a),
    n butterflies (the one-stage K2, K5b), one unscaled n-point transform
    (the NTT passes) or n point adds (K3, K5c) over the field F."""
    w, limb_bytes = F.L // 2, 4 * F.L
    if kernel in ("k1_mont_mul", "k4_field_mul"):
        return 3 * n * limb_bytes, 2 * n * madds(F), 0.0
    if kernel == "k5a_mont_mul_mma":
        return 3 * n * limb_bytes, n * mma_int_ops(F), n * mma_ops_per_elem(F)
    if kernel == "k2_butterfly":
        return 5 * n * limb_bytes, n * (2 * madds(F) + 4 * w), 0.0
    if kernel == "k5b_butterfly_mma":
        return 5 * n * limb_bytes, n * (mma_int_ops(F) + 4 * w), n * mma_ops_per_elem(F)
    if kernel in ("k2_ntt_pass", "k5b_ntt_pass"):
        nbytes = 2 * n * limb_bytes + (n // 2) * 2 * F.L  # limbs in and out, the twiddles
        if kernel == "k2_ntt_pass":
            return nbytes, k2_ntt_int_ops(F, n, False), 0.0
        return (nbytes, *k5b_ntt_counts(F, n, False))
    if kernel == "k3_sw_add":
        return 9 * n * limb_bytes, n * (k3_strict_int_ops(F) if strict(F) else k3_int_ops(F)), 0.0
    if kernel == "k5c_sw_add_mma":
        if strict(F):
            return 9 * n * limb_bytes, n * k5c_strict_int_ops(F), n * 12 * mma_ops_per_elem(F)
        return 9 * n * limb_bytes, n * k5c_int_ops(F), n * 10 * mma_ops_per_elem(F)
    raise ValueError(f"unknown kernel {kernel!r}")


def cost_table(kernel: str, F, n: int, wall_sec: float | None = None) -> dict:
    """One launch's bytes, integer and tensor-core operations and bound
    (`counts`, `bound`); given its wall time, the achieved rates and the
    share of the bound reached (bound over wall)."""
    nbytes, ops, mma = counts(kernel, F, n)
    bms, by = bound(nbytes, ops, mma)
    out = {
        "kernel": kernel,
        "field": F.name,
        "n": n,
        "bytes": nbytes,
        "int_ops": ops,
        "mma_ops": mma,
        "bound_ms": bms,
        "bound_by": by,
    }
    if wall_sec:
        out["bytes_per_sec"] = nbytes / wall_sec
        out["int_ops_per_sec"] = ops / wall_sec
        out["bound_share"] = bms / (wall_sec * 1e3)
    return out


def report(kernel: str, F, n: int, wall_sec: float | None = None) -> str:
    """cost_table as one JSON line."""
    return json.dumps(cost_table(kernel, F, n, wall_sec))
