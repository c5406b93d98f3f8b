"""utils/profiling.py (torch only, seconds): the kernels' work counts give
the figures PERF.md's kernel table quotes, cost_table's share is the
bound over the wall, and trace writes a Chrome trace."""

import json
import os

import pytest
import torch

from contangle_zkcp_tpu_torch.fields import instances as fi
from contangle_zkcp_tpu_torch.utils import profiling as prof


@pytest.mark.parametrize(
    "count, field, want",
    [
        (prof.k3_int_ops, fi.bls12_381_fq, 6952),  # W = 12, a point add
        (prof.k3_strict_int_ops, fi.pasta_fq, 4008),  # W = 8, strict
        (prof.k5c_int_ops, fi.bls12_381_fq, 4082),
        (lambda F: prof.k2_ntt_int_ops(F, 2, False), fi.bls12_381_fr, 304),  # a butterfly
        (prof.madds, fi.bls12_381_fr, 136),
    ],
    ids=["k3", "k3_strict", "k5c", "k2_ntt_butterfly", "madds"],
)
def test_counts(count, field, want):
    assert count(field()) == want


@pytest.mark.parametrize(
    "kernel, field, n, want_ms, by",
    [
        ("k1_mont_mul", fi.bls12_381_fr, 1 << 18, 0.0150, "bytes"),
        ("k1_mont_mul", fi.bls12_381_fq, 1 << 18, 0.0225, "bytes"),
        ("k3_sw_add", fi.bls12_381_fq, 1 << 16, 0.0272, "operations"),
        ("k3_sw_add", fi.pasta_fq, 1 << 16, 0.0157, "operations"),
        ("k2_ntt_pass", fi.bls12_381_fr, 1 << 18, 0.0429, "operations"),
        ("k5c_sw_add_mma", fi.bls12_381_fq, 1 << 16, 0.0169, "bytes"),
    ],
)
def test_bounds_of_the_kernel_table(kernel, field, n, want_ms, by):
    """At the data-sheet integer rate (132 SMs x 64 x 1980 MHz), the
    bounds PERF.md's table gives at these shapes."""
    row = prof.cost_table(kernel, field(), n)
    assert round(row["bound_ms"], 4) == want_ms
    assert row["bound_by"] == by


def test_cost_table_share_is_bound_over_wall():
    F = fi.bls12_381_fr()
    row = prof.cost_table("k1_mont_mul", F, 1 << 18, wall_sec=2e-5)
    assert row["bound_share"] == pytest.approx(row["bound_ms"] / 0.02, rel=1e-12)
    assert row["bytes"] == 3 * (1 << 18) * F.L * 4
    assert row["int_ops"] == 2 * (1 << 18) * prof.madds(F)
    assert json.loads(prof.report("k1_mont_mul", F, 1 << 18, 2e-5)) == row
    assert "bound_share" not in prof.cost_table("k1_mont_mul", F, 1 << 18)
    with pytest.raises(ValueError):
        prof.counts("no_such_kernel", F, 1)


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path)) as p:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(str(tmp_path), "trace.json")
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert p.events()
