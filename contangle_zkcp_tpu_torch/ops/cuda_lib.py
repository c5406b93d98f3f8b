"""Build, load and count the port's hand-written CUDA kernels.

The kernels (csrc/k1_mont_mul.cu with K4's entry, k2_butterfly.cu,
k2_ntt.cu, k3_sw_add.cu, k5a_mont_mul_mma.cu, k5b_butterfly_mma.cu,
k5b_ntt_mma.cu, k5c_sw_add_mma.cu)
are compiled for `sm_90a`, one `nvcc` per source, all started together,
and linked into one plain shared library with a C interface, loaded with
ctypes.  The build happens at first use,
never at import, into `contangle_zkcp_tpu_torch/build/` (git-ignored); the
library's file name carries a hash of the sources, so an edited source
is never served by a stale build.

Every wrapper that launches a kernel adds one to `LAUNCHES[name]` right
where it launches, and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from collections import Counter

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

KERNELS = (
    "k1_mont_mul",
    "k2_butterfly",
    "k2_ntt_pass",
    "k3_sw_add",
    "k4_field_mul",
    "k5a_mont_mul_mma",
    "k5b_butterfly_mma",
    "k5b_ntt_pass",
    "k5c_sw_add_mma",
)
LAUNCHES: Counter = Counter()

_LIB = None


def reset_launches() -> None:
    LAUNCHES.clear()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))) + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib_path() -> str:
    h = hashlib.sha256()
    for s in _sources():
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libzkcp_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile every kernel source with its own nvcc, all started together,
    then link them into one library (no-op when already built); ptxas's
    report on each kernel is kept beside it (`ptxas_log`)."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", obj, src]
        objs.append(obj)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, failed = [], []
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=900)
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(proc.args[-1])} ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out + f".{tag}"
        res = subprocess.run([_nvcc(), *flags, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        with open(out + ".ptxas.log", "w") as f:
            f.write("".join(logs))
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if verbose:
        print("".join(logs), flush=True)
    return out


def ptxas_log() -> str:
    """What `-Xptxas -v` said when the current library was built."""
    path = build() + ".ptxas.log"
    return open(path).read() if os.path.exists(path) else ""


def lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(build())
        vp, ll, i32, u32 = (
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_uint32,
        )
        so.k1_mont_mul.argtypes = [vp, vp, vp, ll, i32, vp, u32, vp]
        so.k2_butterfly.argtypes = [vp, vp, vp, vp, vp, ll, i32, vp, u32, vp]
        so.k2_ntt_pass.argtypes = [vp] * 5 + [i32, ll, ll] + [i32] * 4 + [vp, u32, vp]
        so.k3_sw_add.argtypes = [vp] * 9 + [ll, i32, vp, u32, vp, i32, i32, vp]
        so.k4_field_mul.argtypes = [vp, vp, vp, ll, i32, vp, u32, vp]
        so.k5a_mont_mul_mma.argtypes = [vp, vp, vp, ll, i32, vp, u32, vp, vp]
        so.k5b_butterfly_mma.argtypes = [vp, vp, vp, vp, vp, ll, i32, vp, u32, vp, vp]
        so.k5b_ntt_pass.argtypes = [vp] * 5 + [i32, ll, ll] + [i32] * 4 + [vp, u32, vp, vp]
        so.k5c_sw_add_mma.argtypes = [vp] * 9 + [ll, i32, vp, u32, vp, i32, i32, vp, vp]
        for name in KERNELS:
            getattr(so, name).restype = ctypes.c_int
        _LIB = so
    return _LIB


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(t) -> int:
    """The current CUDA stream of t's device, as an address."""
    return torch.cuda.current_stream(t.device).cuda_stream
