#!/usr/bin/env python3
"""What nvcc made of the point-add kernels K3 and K5c, of K2's two entries,
of K5a and of K5b's NTT passes: registers, spills and SASS instruction
counts.

    python3 scripts/kernel_sass.py [--root DIR] [--out FILE]

Compiles `k3_sw_add.cu`, `k5c_sw_add_mma.cu`, `k2_butterfly.cu`,
`k2_ntt.cu`, `k5a_mont_mul_mma.cu` and `k5b_ntt_mma.cu` of the port under
DIR (default: this checkout; another tree, such as an older commit
unpacked with `git archive`, compares designs; a source the tree lacks is
skipped) to cubins for sm_90a with `-Xptxas -v`, then disassembles them
with `cuobjdump -sass`.  Prints, for each instance of `k3_kernel`,
`k5c_kernel`, `k2_kernel`, `k2_ntt_kernel`, `k5a_kernel` and
`k5b_ntt_kernel`: registers, stack and spill
bytes, the number of SASS instructions and the most frequent opcodes
(with their modifiers: IMAD.WIDE.U32, IADD3.X, ...).  The point adds and
`k2_kernel` are straight-line code per point or butterfly (K5c: per point
and lane of its loop), so the static count is the count per point or
butterfly; `k2_ntt_kernel` loops over its stages, and its static count
holds five inlined Montgomery products (one a butterfly, two each for the
pre- and post-scales); `k5a_kernel` is one multiply an element, and
`k5b_ntt_kernel` holds three (a butterfly's and the two scalings').  `--out` also writes the full
histograms as JSON.  Needs nvcc and cuobjdump (the CUDA toolkit); no GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("k3_sw_add.cu", "k5c_sw_add_mma.cu", "k2_butterfly.cu", "k2_ntt.cu",
           "k5a_mont_mul_mma.cu", "k5b_ntt_mma.cu")
KERNEL = re.compile(r"(k3_kernel|k5c_kernel|k2_kernel|k2_ntt_kernel|k5a_kernel|k5b_ntt_kernel)"
                    r"ILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?")
SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
GROUPS = {  # opcode families reported apart, by prefix
    "IMAD": ("IMAD",),
    "IADD3": ("IADD3",),
    "select/logic": ("SEL", "LOP3", "PRMT", "SHF", "ISETP", "PLOP3"),
    "moves": ("MOV", "IMAD.MOV"),
    "memory": ("LDG", "STG", "LDS", "STS", "LDC", "LDL", "STL"),
    "tensor": ("IMMA", "HMMA"),
}


def tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        sys.exit(f"kernel_sass: {name} not found")
    return path


def label(mangled: str) -> str | None:
    m = KERNEL.search(mangled)
    if not m:
        return None
    args = [a for a in m.groups()[1:3] if a]
    if m.group(4) is not None:  # the arithmetic flag: strict or lazy
        args.append("strict" if m.group(4) == "1" else "lazy")
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_report(text: str) -> dict:
    """{kernel label: {regs, stack, spill_stores, spill_loads}}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = label(m.group(1))
            if cur:
                out[cur] = {}
            continue
        if not cur:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["regs"] = int(m.group(1))
    return out


def sass_histograms(cubin: str) -> dict:
    """{kernel label: Counter of opcodes} from cuobjdump -sass."""
    text = subprocess.run([tool("cuobjdump"), "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = label(m.group(1))
            if cur:
                out[cur] = collections.Counter()
            continue
        m = SASS_LINE.search(line)
        if cur and m and m.group(1) != "NOP":
            out[cur][m.group(1)] += 1
    return out


def family(hist: collections.Counter) -> dict:
    fam = collections.Counter()
    for op, n in hist.items():
        for name, prefixes in GROUPS.items():
            if op.startswith(prefixes) and not (name == "IMAD" and op.startswith("IMAD.MOV")):
                fam[name] += n
                break
        else:
            fam["other"] += n
    return dict(fam)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose csrc/ to compile")
    ap.add_argument("--out", help="write the histograms as JSON here")
    args = ap.parse_args()
    csrc = os.path.join(os.path.abspath(args.root), "contangle_zkcp_tpu_torch", "csrc")
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in (s for s in SOURCES if os.path.exists(os.path.join(csrc, s))):
            cubin = os.path.join(tmp, src + ".cubin")
            res = subprocess.run(
                [tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xptxas", "-v", "-cubin", "-o", cubin, os.path.join(csrc, src)],
                capture_output=True, text=True)
            if res.returncode != 0:
                sys.exit(f"kernel_sass: nvcc failed on {src}:\n{res.stderr}")
            res_use = ptxas_report(res.stderr)
            for name, hist in sass_histograms(cubin).items():
                report[name] = dict(res_use.get(name, {}), sass=sum(hist.values()),
                                    families=family(hist), ops=dict(hist.most_common()))
    print(f"[sass] {csrc}")
    for name in sorted(report):
        r = report[name]
        top = ", ".join(f"{op} {n}" for op, n in list(r["ops"].items())[:10])
        print(f"[sass] {name}: {r.get('regs')} registers, stack {r.get('stack')} B, spills "
              f"{r.get('spill_stores')}/{r.get('spill_loads')} B; {r['sass']} instructions "
              f"{json.dumps(r['families'], sort_keys=True)}; top: {top}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
