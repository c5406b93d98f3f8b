"""The port's proving-scale MSM engines (ops/msm_balanced.py BalancedMSM,
ops/msm_tree.py TreeMSM), its policy (ops/msm_policy.py) and the engine
choice of groth16 CurveCtx._msm_for, against the JAX package.

The host schedules and layouts are compared with the reference's array for
array; the engines' points with the exact host sum msm_host (G1 and G2,
skewed, uniform, duplicate, cancelling, identity and zero cases) on the
kernels' twins.  No reference MSM runs: its bucket programs take minutes
to compile on XLA:CPU."""

import functools
import random

import numpy as np
import pytest

from contangle_zkcp_tpu.curves import instances as jci
from contangle_zkcp_tpu.curves.weierstrass import SWDevice as JSWDevice
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu.ops import msm_policy as jpolicy
from contangle_zkcp_tpu.ops import msm_sched_native as jsched
from contangle_zkcp_tpu.ops.msm_balanced import BalancedMSM as JBalancedMSM
from contangle_zkcp_tpu.ops.msm_tree import TreeMSM as JTreeMSM
from contangle_zkcp_tpu_torch.curves import instances as ci
from contangle_zkcp_tpu_torch.curves.fq2_device import Fq2Device
from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.fields.bigint import ints_to_limbs
from contangle_zkcp_tpu_torch.groth16 import Groth16
from contangle_zkcp_tpu_torch.groth16 import groth16 as g16mod
from contangle_zkcp_tpu_torch.groth16 import serialize as tser
from contangle_zkcp_tpu_torch.ops import msm_policy, msm_sched_native
from contangle_zkcp_tpu_torch.ops.msm import MSM, msm_host
from contangle_zkcp_tpu_torch.ops.msm_balanced import BalancedMSM
from contangle_zkcp_tpu_torch.ops.msm_tree import TreeMSM
from contangle_zkcp_tpu_torch.utils import metrics
from tests.test_torch_groth16 import GOLDEN, SEED, sha, toy_circuit
from tests.torch_port_util import one_torch_thread  # noqa: F401

R = tfi.BLS12_381_R
C = ci.BLS12_381_G1
G2_GEN = (ci.BLS12_381_G2_GX, ci.BLS12_381_G2_GY)


class _G2Host:
    """msm_host's curve interface over the port's host G2 math."""

    def __init__(self, dev):
        self.add, self.mul = dev.host_add, dev.host_mul


@functools.lru_cache(maxsize=None)
def group(name):
    Fq = tfi.bls12_381_fq()
    if name == "g1":
        return SWDevice(Fq, C, device="cpu"), C
    dev = SWDevice(Fq2Device(Fq), b=ci.BLS12_381_G2_B, device="cpu")
    return dev, _G2Host(dev)


@functools.lru_cache(maxsize=None)
def jax_g1():
    return JSWDevice(jfi.bls12_381_fq(), jci.BLS12_381_G1)


def scalars(n, kind, seed):
    """"skewed": the PoE witness's skew (half 0/1 bits, a few small bytes,
    one in eight uniform); "uniform": uniform in [0, r), with 0 and r - 1."""
    rng = random.Random(seed)
    if kind == "uniform":
        return [0, R - 1] + [rng.randrange(R) for _ in range(n - 2)]
    return [rng.randrange(R) if i % 8 == 0 else rng.choice([0, 1, 1, 1, 3, 255]) for i in range(n)]


# ------------------------------------------------------------ host side
@pytest.mark.parametrize("native", [True, False], ids=["native_schedule", "numpy_schedule"])
@pytest.mark.parametrize("kind", ["skewed", "uniform"])
@pytest.mark.parametrize("c,signed,E", [(4, False, 32), (4, True, 32), (6, True, 32), (8, True, 1 << 16)])
def test_balanced_schedule_equals_reference(c, signed, E, kind, native, monkeypatch):
    if not native:
        monkeypatch.setattr(msm_sched_native, "schedule", lambda *a: None)
        monkeypatch.setattr(jsched, "schedule", lambda *a: None)
    limbs = ints_to_limbs(scalars(160, kind, seed=c + E), 16)
    ours = BalancedMSM(group("g1")[0], 255, c=c, signed=signed, overflow_lanes=E).schedule(limbs)
    ref = JBalancedMSM(jax_g1(), 255, c=c, signed=signed, overflow_lanes=E).schedule(limbs)
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    if kind == "skewed" and E == 32:
        assert ours["nlev"] >= 1  # overflow segments, fold levels and merges
    # the gauge counts the pool's lanes in use (the reference's sums their
    # segment sizes): at least the lanes given points, at most E
    lanes = metrics.registry().snapshot()["gauges"]["msm.balanced_overflow_lanes"]
    assert np.count_nonzero(ours["lcnt"][-E:]) <= lanes <= E


@pytest.mark.parametrize("kind", ["skewed", "uniform"])
@pytest.mark.parametrize("c,signed", [(4, False), (8, False), (8, True)])
def test_tree_layout_equals_reference_on_real_slots(c, signed, kind):
    limbs = ints_to_limbs(scalars(200, kind, seed=c), 16)
    eng = TreeMSM(group("g1")[0], 255, c=c, signed=signed)
    jeng = JTreeMSM(jax_g1(), 255, c=c, signed=signed)
    sched = eng.host_schedule_signed(limbs) if signed else (*eng.host_schedule(limbs), None)
    order, start, cnt, sgn = sched
    idx0, v0, sgn0, pairs, harvest, P0 = eng._tree_layout(start, cnt, order, sgn)
    jidx0, jv0, jsgn0, jpairs, jharvest, _ = jeng._tree_layout(start, cnt, order, sgn)
    assert len(idx0) == P0 and not jv0[P0:].any()
    for a, b in ((idx0, jidx0), (v0, jv0), (sgn0, jsgn0)):
        np.testing.assert_array_equal(a, b[:P0])
    assert pairs == jpairs
    assert harvest.keys() == jharvest.keys()
    for lvl in harvest:
        for a, b in zip(harvest[lvl], jharvest[lvl]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("group_name", ["g1", "g2"])
def test_policy_equals_reference_and_cap_holds(group_name):
    for n in (1, 100, (1 << 16) - 1, 1 << 16, 153351, 202506, 262143, 792330, 1 << 24):
        cfg = msm_policy.msm_config(group_name, n)
        ref = jpolicy.msm_config(group_name, n)
        assert (cfg.c, cfg.signed, cfg.engine) == (ref.c, ref.signed, ref.engine), n
        assert msm_policy.grid_bytes(group_name, cfg.c, cfg.signed) <= msm_policy.BUCKET_GRID_BYTES_CAP
    assert msm_policy.SMALL_N == jpolicy.SMALL_N
    # the port's rows: 3 coordinates of 24 int32 limbs (x2 for Fq2)
    assert msm_policy.grid_bytes("g1", 16, True) == 16 * (1 << 15) * 288
    assert msm_policy.grid_bytes("g2", 12, True) == 22 * (1 << 11) * 576


# ------------------------------------------------------------ the engines
CASES = [
    # tests/test_msm_balanced.py: skewed, signed and unsigned, overflow
    ("g1", 48, "skewed", 4, False, "plain"),
    ("g1", 48, "skewed", 6, True, "plain"),
    ("g1", 32, "uniform", 6, True, "plain"),
    ("g2", 16, "skewed", 4, True, "plain"),
    # tests/test_msm_tree.py: zero scalars, duplicates, P and -P, identity
    ("g1", 73, "uniform", 8, False, "plain"),
    ("g1", 12, "uniform", 8, True, "adversarial"),
    ("g2", 12, "uniform", 5, True, "adversarial"),
]


def case_inputs(name, n, kind, adv, seed):
    """Points k_i G (distinct, or with duplicates, negations and identity
    inputs under "adversarial") and scalars (repeated under
    "adversarial", so the same points meet in a bucket)."""
    dev, host = group(name)
    gen = C.generator if name == "g1" else G2_GEN
    rng = random.Random(seed)
    pts = [host.mul(rng.randrange(1, R), gen) for _ in range(n)]
    sc = scalars(n, kind, seed)
    if adv == "adversarial":
        P, s = pts[0], sc[2]
        negP = (P[0], C.p - P[1]) if name == "g1" else (P[0], tuple((-c) % C.p for c in P[1]))
        pts[:6] = [P, P, P, negP, pts[4], pts[4]]
        sc[:6] = [s, s, s, s, 7, 7]
        pts[6], pts[7] = None, None  # identity inputs
        sc[8] = 0
    return dev, host, pts, sc


@pytest.mark.parametrize("engine", ["balanced", "tree"])
@pytest.mark.parametrize("name,n,kind,c,signed,adv", CASES)
def test_engine_equals_msm_host(engine, name, n, kind, c, signed, adv):
    dev, host, pts, sc = case_inputs(name, n, kind, adv, seed=n + c)
    if engine == "balanced":
        eng = BalancedMSM(dev, 255, c=c, signed=signed, overflow_lanes=16 if name == "g2" else 32)
    else:
        eng = TreeMSM(dev, 255, c=c, signed=signed)
    got = eng.run(dev.encode_points(pts), ints_to_limbs(sc, 16))
    live = [(p, s) for p, s in zip(pts, sc) if p is not None]
    assert got == msm_host(host, [p for p, _ in live], [s for _, s in live])


def test_tree_multichunk():
    """Several chunks through a small level-0 budget, their grids added."""
    dev, _, pts, sc = case_inputs("g1", 40, "skewed", "plain", seed=8)
    eng = TreeMSM(dev, 255, c=8, signed=True)
    eng.A0_BUDGET_BYTES = 16 * eng.K * (2 * eng._cw * 4 + 1)  # 8 points a chunk
    assert eng._chunk_rows() == 8
    assert eng.run(pts, sc) == msm_host(C, pts, sc)


@pytest.mark.parametrize("engine,signed", [("balanced", True), ("tree", False), ("tree", True)])
def test_grid_reduction_equals_host_weighted_sum(engine, signed):
    """GridMSM's window reduction and Horner combine of a (K, nb) grid of
    points a_kb G against (sum_k 2^(kc) sum_b w_kb a_kb) G, w_kb = (b mod
    m_k) + 1 (signed) or b mod m_k (unsigned): 22-bit scalars at c = 4,
    so the tree engine's top window spans fewer digits than its lanes and
    its alias lanes fold; some buckets hold the identity."""
    dev, _ = group("g1")
    if engine == "balanced":
        eng = BalancedMSM(dev, 22, c=4, signed=signed, overflow_lanes=16)
    else:
        eng = TreeMSM(dev, 22, c=4, signed=signed)
    assert engine == "balanced" or min(eng.window_m) < eng.nb
    rng = random.Random(41 + signed)
    a = [[rng.randrange(R) if rng.random() < 0.8 else 0 for _ in range(eng.nb)] for _ in range(eng.K)]
    grid = dev.encode_points([C.mul(x, C.generator) if x else None for row in a for x in row])
    grid = {k: v.reshape((eng.K, eng.nb) + v.shape[1:]) for k, v in grid.items()}
    off = 1 if signed else 0
    want = sum((x << (k * eng.c)) * (b % eng.window_m[k] + off)
               for k, row in enumerate(a) for b, x in enumerate(row)) % R
    got = eng._combine_host(dev.decode_points(eng._staged_windows(grid)))
    assert got == C.mul(want, C.generator)


# ------------------------------------------------------- engine choice
def test_msm_for_builds_the_named_engine(monkeypatch):
    ctx = g16mod.curve_ctx("bls12_381", device="cpu")
    monkeypatch.setattr(ctx, "_msm_cache", {})
    for grp, get in (("g1", ctx.msm_g1), ("g2", ctx.msm_g2)):
        assert type(get(100)) is MSM and (get(100).c, get(100).signed) == (8, False)
        big = get(1 << 16)
        assert type(big) is BalancedMSM
        assert (big.c, big.signed) == ((16, True) if grp == "g1" else (12, True))
    monkeypatch.setattr(msm_policy, "msm_config",
                        lambda g, n, bits=255: msm_policy.MSMConfig(c=8, signed=True, engine="tree"))
    assert type(ctx.msm_g1(1 << 16)) is TreeMSM and type(ctx.msm_g2(5)) is TreeMSM


@functools.lru_cache(maxsize=None)
def golden_setup():
    eng = Groth16("bls12_381", device="cpu")
    rng = random.Random(SEED)
    cs = toy_circuit(eng.ctx.r)
    pk, vk = eng.setup(cs, rng)
    return eng, cs, pk, vk, rng.getstate()


@pytest.mark.parametrize("engine", ["balanced", "tree"])
def test_golden_proof_under_engine(engine, monkeypatch):
    """The toy circuit's proof, every MSM forced onto one engine at a small
    window (c = 4; balanced with E = 32), is the golden bytes."""
    eng, cs, pk, vk, state = golden_setup()
    monkeypatch.setattr(eng.ctx, "_msm_cache", {})
    monkeypatch.setattr(BalancedMSM, "OVERFLOW_LANES", 32)
    monkeypatch.setattr(msm_policy, "msm_config",
                        lambda g, n, bits=255: msm_policy.MSMConfig(c=4, signed=True, engine=engine))
    rng = random.Random()
    rng.setstate(state)
    proof = eng.prove(pk, cs, rng)
    assert {type(m) for m in eng.ctx._msm_cache.values()} == {BalancedMSM if engine == "balanced" else TreeMSM}
    assert sha(tser.proof_to_bytes(proof)) == GOLDEN["proof"]["sha256"]
    assert eng.verify(vk, cs.public_inputs(), proof)
