"""The port's NTT passes (ops/ntt.py pass_plan, ops/mont.py ntt_pass,
ops/mont_mma.py ntt_pass_mma and their twins), torch only: the plan covers
every stage once, a numpy replay of csrc/ntt_tile.cuh's tile and butterfly
index maps keeps every butterfly inside one block, a replay of
csrc/k5b_ntt_mma.cu's rounds gives every multiply all 32 lanes of a warp
and stores from live lanes only, and the passes' twins (K2's, and K5b's
under ZKCP_MXU=1) composed over forced plans equal the stage loop with its
`F.mul` scalings, limb for limb.  The NTT against the JAX package is
tests/test_torch_ntt.py; the pass kernels on the card are
tests/test_torch_cuda.py."""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.ops import mont, mont_mma
from contangle_zkcp_tpu_torch.ops.ntt import NTT, PASS_BITS, pass_plan

from tests.torch_port_util import one_torch_thread, rand_ints  # noqa: F401

FIELDS = {"bls12_381_fr": (tfi.bls12_381_fr, 7), "pasta_fp": (tfi.pasta_fp, 5)}
OPS = ("forward", "inverse", "coset_forward", "coset_inverse")
CSRC = pathlib.Path(mont.__file__).resolve().parent.parent / "csrc"
# the launch limits, declared once in the sources: the passes' shared
# geometry, and the tensor-core pass's warps a block
LIMITS = {k: int(v) for k, v in re.findall(r"constexpr int (NTT_\w+) = (\d+);",
                                           (CSRC / "ntt_tile.cuh").read_text())}
K5B_WARPS = int(re.search(r"constexpr int K5B_NTT_WARPS = (\d+);",
                          (CSRC / "k5b_ntt_mma.cu").read_text()).group(1))


def test_pass_plan_covers_every_stage_once():
    assert PASS_BITS <= LIMITS["NTT_TILE_LOG"]
    for logn in range(1, 23):
        plan = pass_plan(1 << logn)
        stages = [s for s0, t in plan for s in range(s0, s0 + t)]
        assert stages == list(range(logn)), logn
        assert len(plan) == max(1, -(-logn // PASS_BITS)) and max(t for _, t in plan) <= PASS_BITS
    assert [pass_plan(1 << k) for k in (18, 15, 12)] == [[(0, 9), (9, 9)], [(0, 8), (8, 7)],
                                                       [(0, 6), (6, 6)]]


def brev(i, logn):
    """The kernel's __brev(i) >> (32 - log2 n), on uint32 arrays."""
    x = np.asarray(i, dtype=np.uint64)
    r = np.zeros_like(x)
    for b in range(32):
        r |= ((x >> np.uint64(b)) & np.uint64(1)) << np.uint64(31 - b)
    return (r >> np.uint64(32 - logn)).astype(np.int64)


def pass_geometry(n, s0, t):
    """csrc/ntt_tile.cuh ntt_geometry and csrc/k2_ntt.cu launch_k2_ntt's
    launch shape for one pass: (lg, threads, blocks); a block takes 2^lg
    groups of 2^t elements."""
    groups_log = n.bit_length() - 1 - t
    lg = min(max(0, LIMITS["NTT_MIN_BF_LOG"] + 1 - t), groups_log)
    return lg, min(LIMITS["NTT_THREADS"], 1 << (t + lg - 1)), n >> (t + lg)


def replay_pass(n, s0, t):
    """csrc/ntt_tile.cuh's index maps for one pass, vectorized over blocks:
    checks the tiles and each stage's butterflies and twiddle indices."""
    logn = n.bit_length() - 1
    lg, threads, blocks = pass_geometry(n, s0, t)
    tile = 1 << (t + lg)
    assert 1 <= threads <= LIMITS["NTT_THREADS"] and t + lg <= LIMITS["NTT_TILE_LOG"]
    b = np.arange(blocks, dtype=np.int64)[:, None]
    e = np.arange(tile, dtype=np.int64)[None, :]
    g = (b << lg) + (e & ((1 << lg) - 1))
    idx = ((g >> s0) << (s0 + t)) | ((e >> lg) << s0) | (g & ((1 << s0) - 1))
    assert np.array_equal(np.sort(idx.ravel()), np.arange(n))  # each element in one tile
    cols = min(1 << lg, 1 << s0) if s0 else 1  # a block's groups: neighbouring columns
    assert np.all(np.diff(idx[:, :cols], axis=1) == 1)
    for ls in range(t):
        s, h = s0 + ls, 1 << ls
        bf = np.arange(tile // 2, dtype=np.int64)[None, :]
        c, r = bf & ((1 << lg) - 1), bf >> lg
        ku = ((r >> ls) << (ls + 1)) | (r & (h - 1))
        pu = (ku << lg) | c
        pv = pu + (h << lg)
        j = ((ku & (h - 1)) << s0) | (((b << lg) + c) & ((1 << s0) - 1))
        iu = np.take_along_axis(idx, np.broadcast_to(pu, (blocks, tile // 2)), axis=1)
        iv = np.take_along_axis(idx, np.broadcast_to(pv, (blocks, tile // 2)), axis=1)
        assert np.all((iu >> s) & 1 == 0) and np.array_equal(iv, iu + (1 << s))
        assert np.array_equal(np.broadcast_to(j, iu.shape), iu & ((1 << s) - 1))
        assert np.all(np.broadcast_to(j, iu.shape) << (logn - s - 1) < n // 2)
        want = np.arange(n)[(np.arange(n) >> s) & 1 == 0]
        assert np.array_equal(np.sort(iu.ravel()), want)  # every butterfly once
    return blocks


@pytest.mark.parametrize("n", [2, 8, 1024, 1 << 12, 1 << 15, 1 << 18])
def test_kernel_index_maps_keep_butterflies_in_one_tile(n):
    logn = n.bit_length() - 1
    assert np.array_equal(brev(np.arange(n), logn), mont.bit_reverse_perm(n).numpy())
    for s0, t in pass_plan(n):
        replay_pass(n, s0, t)
    for t in (1, 2, 5) if n <= 1 << 12 else ():  # forced plans: many groups a block
        for s0 in range(0, logn, t):
            replay_pass(n, s0, min(t, logn - s0))


@pytest.mark.parametrize("B,n", [(512, 512), (4, 1 << 18), (3, 1024), (5, 2)])
def test_batched_grid_covers_every_transform_once(B, n):
    """csrc/ntt_tile.cuh's batched grid: B x (n >> tile_log) blocks, block
    k taking tile k mod 2^nblk_log of transform k >> nblk_log, whose
    elements lie b n further on; every element of the batch is read and
    written by exactly one slot of one block, and every block's slots stay
    in its own transform.  The launch limit: B << nblk_log below 2^31."""
    logn = n.bit_length() - 1
    for s0, t in pass_plan(n):
        lg, _, per = pass_geometry(n, s0, t)
        nblk_log = logn - t - lg
        assert per == 1 << nblk_log
        k = np.arange(B << nblk_log, dtype=np.int64)[:, None]
        e = np.arange(1 << (t + lg), dtype=np.int64)[None, :]
        g = ((k & ((1 << nblk_log) - 1)) << lg) + (e & ((1 << lg) - 1))
        idx = ((g >> s0) << (s0 + t)) | ((e >> lg) << s0) | (g & ((1 << s0) - 1))
        assert idx.min() >= 0 and idx.max() < n
        flat = ((k >> nblk_log) << logn) + idx
        assert np.array_equal(np.sort(flat.ravel()), np.arange(B * n))
        assert B <= ((1 << 31) - 1) >> nblk_log


def k5b_rounds(n, s0, t):
    """csrc/k5b_ntt_mma.cu's launch and rounds for one pass: the warps of a
    block (launch_k5b_ntt), and for each warp-uniform loop (the tile's
    slots for the pre- and post-scales, a stage's butterflies) which lanes
    run each multiply and which of them are live.  Returns (warps, {count:
    [(warp, round base, lanes, live lanes)]})."""
    lg, _, _ = pass_geometry(n, s0, t)
    tile = 1 << (t + lg)
    rounds = (tile // 2) // 32
    warps = 1 if rounds < 1 else min(rounds, K5B_WARPS)
    out = {}
    for count in (tile, tile // 2):  # the scalings' loop, a stage's loop
        runs = []
        for warp in range(warps):
            for base in range(32 * warp, count, 32 * warps):  # base: warp-uniform
                lanes = base + np.arange(32)
                runs.append((warp, base, lanes, lanes[lanes < count]))
        out[count] = runs
    return warps, out


@pytest.mark.parametrize("n", [2, 4, 8, 1024, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 18, 1 << 19])
def test_k5b_rounds_give_every_multiply_a_whole_warp(n):
    """Every multiply of k5b_ntt_pass runs on all 32 lanes of its warp (the
    warp-collective mma.sync), each warp of the block takes part in the
    same rounds at every size, every slot and butterfly is taken by
    exactly one live lane, and the dead lanes (past the end) store
    nothing: at n = 2 and 4 a single warp with 31 or 30 dead lanes."""
    logn = n.bit_length() - 1
    plans = [pass_plan(n)] + [[(s0, min(t, logn - s0)) for s0 in range(0, logn, t)]
                              for t in (1, 2, 5) if n <= 1 << 12]
    for plan in plans:
        for s0, t in plan:
            warps, loops = k5b_rounds(n, s0, t)
            assert 1 <= warps <= K5B_WARPS
            for count, runs in loops.items():
                live = np.concatenate([lv for *_, lv in runs])
                assert np.array_equal(np.sort(live), np.arange(count))  # each once
                assert all(len(lanes) == 32 for _, _, lanes, _ in runs)
                per_warp = np.bincount([w for w, *_ in runs], minlength=warps)
                assert per_warp.max() - per_warp.min() <= 1 and per_warp.min() >= 1
                for _, _, lanes, lv in runs:  # stores: exactly the live lanes
                    assert np.array_equal(lanes[lanes < count], lv)
    if n <= 4:
        warps, loops = k5b_rounds(n, 0, logn)
        assert warps == 1 and len(loops[n // 2]) == 1 and len(loops[n // 2][0][3]) == n // 2


@functools.lru_cache(maxsize=None)
def engine(name, n):
    return NTT(FIELDS[name][0](), n, device="cpu")


def forced_passes(ntt, op, a, g, t):
    """The twins of the passes of a plan of t stages each."""
    logn = ntt.logn
    table, pre, post = ntt.pass_operands(op, g)
    plan = [(s0, min(t, logn - s0)) for s0 in range(0, logn, t)]
    x = a
    for i, (s0, tt) in enumerate(plan):
        x = mont.ntt_pass_plain(ntt.F, x, table, s0, tt, pre=pre if i == 0 else None,
                                post=post if i == len(plan) - 1 else None, gather=i == 0)
    return x


@pytest.mark.parametrize("n", [2, 8, 256, 1024])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_forced_plans_equal_stage_loop(name, n):
    ntt = engine(name, n)
    F, g = ntt.F, FIELDS[name][1]
    a = F.encode(rand_ints(F.p, max(n - 3, 0), seed=n)[:n], device="cpu")
    logn = ntt.logn
    for op in OPS:
        want = ntt.stage_route(op, a, g)  # the stage loop and F.mul, on the K2 twin
        args = (g,) if op.startswith("coset") else ()
        assert torch.equal(getattr(ntt, op)(a, *args), want), op
        for t in sorted({min(t, logn) for t in (1, 2, 5, logn)}):
            if n == 1024 and t < 5:
                continue  # the same passes as at n <= 256, more of them
            assert torch.equal(forced_passes(ntt, op, a, g, t), want), (op, t)


def forced_mma_passes(ntt, op, a, g, t):
    """The tensor-core pass twins (ntt_pass_mma_plain) over a plan of t
    stages each."""
    logn = ntt.logn
    table, pre, post = ntt.pass_operands(op, g)
    plan = [(s0, min(t, logn - s0)) for s0 in range(0, logn, t)]
    x = a
    for i, (s0, tt) in enumerate(plan):
        x = mont_mma.ntt_pass_mma(ntt.F, x, table, s0, tt, pre=pre if i == 0 else None,
                                  post=post if i == len(plan) - 1 else None, gather=i == 0)
    return x


@pytest.mark.parametrize("n", [2, 8, 256])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_mxu_forced_plans_equal_stage_loop(name, n, monkeypatch):
    """Under ZKCP_MXU=1 the transform takes the tensor-core passes' twin;
    over forced plans it equals the stage loop through butterfly_mma_plain
    with the scalings through K5a's twin (F.mul), and K2's passes."""
    ntt = engine(name, n)
    F, g = ntt.F, FIELDS[name][1]
    a = F.encode(rand_ints(F.p, max(n - 3, 0), seed=n + 7)[:n], device="cpu")
    logn = ntt.logn
    calls = []
    twin = mont_mma.ntt_pass_mma_plain
    monkeypatch.setattr(mont_mma, "ntt_pass_mma_plain", lambda *a, **k: calls.append(1) or twin(*a, **k))
    for op in OPS:
        args = (g,) if op.startswith("coset") else ()
        k2 = getattr(ntt, op)(a, *args)  # the default configuration: K2's passes
        monkeypatch.setenv("ZKCP_MXU", "1")
        want = ntt.stage_route(op, a, g)  # butterfly -> K5b's twin, F.mul -> K5a's twin
        del calls[:]
        assert torch.equal(getattr(ntt, op)(a, *args), want), op
        assert len(calls) == len(ntt.plan), op
        assert torch.equal(want, k2), op
        for t in sorted({min(t, logn) for t in (1, 2, 5, logn)}):
            assert torch.equal(forced_mma_passes(ntt, op, a, g, t), want), (op, t)
        monkeypatch.delenv("ZKCP_MXU")


def test_fused_scalings_equal_f_mul_route():
    """pre and post of one pass are F.mul before the gather and after the
    stages: by position, and post as one scalar row."""
    F, n = tfi.pasta_fp(), 64
    rng = np.random.default_rng(3)
    a, pre, post, tw = (F.encode([int(x) for x in rng.integers(0, 1 << 62, size=m)], device="cpu")
                        for m in (n, n, n, n // 2))
    scalar = F.encode(int(rng.integers(1, 1 << 62)), device="cpu")
    tw_w = mont.pack_words(tw)
    x = F.mul(a, pre).index_select(0, mont.bit_reverse_perm(n))
    for s in range(3):
        x = mont.ntt_stage(F, x, tw, s, mont.butterfly_plain)
    got = mont.ntt_pass(F, a, tw_w, 0, 3, pre=mont.pack_words(pre), post=mont.pack_words(post),
                        gather=True)
    assert torch.equal(got, F.mul(x, post))
    y = F.mul(x, post)
    got = mont.ntt_pass(F, y, tw_w, 3, 2, post=mont.pack_words(scalar[None]))
    for s in (3, 4):
        y = mont.ntt_stage(F, y, tw, s, mont.butterfly_plain)
    assert torch.equal(got, F.mul(y, scalar))


def test_pack_words_round_trip():
    F = tfi.bls12_381_fr()
    a = F.encode(rand_ints(F.p, 29, seed=5), mont=False, device="cpu")
    w = mont.pack_words(a)
    assert w.dtype == torch.int32 and w.shape == (32, 8)
    assert torch.equal(mont.unpack_words(w), a)
    top = int(w[2, 0]) & 0xFFFFFFFF  # p - 1's low word, through the sign bit
    assert top == (F.p - 1) & 0xFFFFFFFF


def test_ntt_pass_operand_checks():
    F, n = tfi.pasta_fp(), 16
    ntt = engine("pasta_fp", n)
    a = F.encode(list(range(n)), device="cpu")
    for s0, t, gather in ((0, 5, True), (2, 2, True), (-1, 2, False), (0, 0, False)):
        with pytest.raises(ValueError):
            mont.ntt_pass(F, a, ntt._tw_fwd_w, s0, t, gather=gather)
    with pytest.raises(ValueError):
        mont.ntt_pass(F, a, ntt._tw_fwd, 0, 4, gather=True)  # limbs, not words
    with pytest.raises(ValueError):
        mont.ntt_pass(F, a, ntt._tw_fwd_w, 0, 4, post=ntt._tw_fwd_w, gather=True)  # n/2 rows
    with pytest.raises(ValueError):
        mont.ntt_pass(F, a[:12], ntt._tw_fwd_w[:6], 0, 2)  # n not a power of two
