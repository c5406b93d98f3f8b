"""The port's CUDA kernels (K1-K3, K4, and the tensor-core K5a-K5c) against
their plain torch twins on the card, at awkward sizes (empty, one element,
odd counts, a ragged last warp) and through the wrappers' operand checks;
K2's NTT passes (k2_ntt_pass) and K5b's (k5b_ntt_pass, ZKCP_MXU=1) against
their twins pass by pass, and whole transforms against the stage loop and
each other, from n = 2 to 2^15, and batches of transforms (B x n, one
launch a pass) against the batched twins and one launch a transform; K5a on edge values (0, 1, p - 1, p - 2);
the multiplies and butterflies also at W = 24 (BW6-761 Fq), the point adds
also over the Pasta curves (the strict arithmetic of csrc/fp_lazy.cuh).  Needs an NVIDIA Hopper GPU and nvcc; skips
elsewhere.  Run on the card (this file imports no JAX, so the suite's
conftest is not needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from contangle_zkcp_tpu_torch.curves import instances as ci
from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.ops import cuda_lib, curve_add, field_mul, mont, mont_mma
from contangle_zkcp_tpu_torch.ops.ntt import NTT

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda_lib.lib()  # builds the kernels; raises if nvcc is missing
    return torch.device("cuda")


def rand(F, n, seed):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 1 << 16, size=(n, F.L), dtype=np.int64)
    arr[:, -1] = rng.integers(0, int(F.p_limbs[-1]), size=n)
    return torch.from_numpy(arr.astype(np.int32))


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 4099])
@pytest.mark.parametrize("name", ["bls12_381_fr", "bls12_381_fq", "bw6_761_fq"])
def test_k1_equals_twin(card, name, n):
    F = getattr(tfi, name)()
    a, b = rand(F, n, 1), rand(F, n, 2)
    before = cuda_lib.LAUNCHES["k1_mont_mul"]
    got = mont.mont_mul(F, a.to(card), b.to(card)).cpu()
    assert torch.equal(got, mont.mont_mul_plain(F, a, b))
    assert cuda_lib.LAUNCHES["k1_mont_mul"] == before + (1 if n else 0)


@pytest.mark.parametrize("n", [1, 33, 2048])
@pytest.mark.parametrize("name", ["bls12_381_fr", "bw6_761_fq"])
def test_k2_equals_twin(card, name, n):
    F = getattr(tfi, name)()
    u, v, w = rand(F, n, 3), rand(F, n, 4), rand(F, n, 5)
    hi, lo = mont.butterfly(F, u.to(card), v.to(card), w.to(card))
    phi, plo = mont.butterfly_plain(F, u, v, w)
    assert torch.equal(hi.cpu(), phi) and torch.equal(lo.cpu(), plo)


NTT_OPS = ("forward", "inverse", "coset_forward", "coset_inverse")


@pytest.mark.parametrize("n", [2, 4, 1024, 4096, 1 << 15])
@pytest.mark.parametrize("name,g", [("bls12_381_fr", 7), ("pasta_fp", 5)])
def test_k2_ntt_pass_equals_twin_and_stage_loop(card, name, g, n):
    """Each pass of each operation equal to ntt_pass_plain on the same
    input; the transform equal to the stage loop's twin (one pass of all
    stages) and launching k2_ntt_pass once a pass of the plan."""
    F = getattr(tfi, name)()
    ntt = NTT(F, n, device=card)
    a = rand(F, n, 21).to(card)
    for op in NTT_OPS:
        table, pre, post = ntt.pass_operands(op, g)
        x, last = a, len(ntt.plan) - 1
        for i, (s0, t) in enumerate(ntt.plan):
            kw = dict(pre=pre if i == 0 else None, post=post if i == last else None, gather=i == 0)
            got = mont.ntt_pass(F, x, table, s0, t, **kw)
            assert torch.equal(got, mont.ntt_pass_plain(F, x, table, s0, t, **kw)), (op, s0, t)
            x = got
        before = cuda_lib.LAUNCHES["k2_ntt_pass"]
        res = getattr(ntt, op)(a, *((g,) if op.startswith("coset") else ()))
        assert cuda_lib.LAUNCHES["k2_ntt_pass"] == before + len(ntt.plan)
        assert torch.equal(res, x)
        assert torch.equal(res, mont.ntt_pass_plain(F, a, table, 0, ntt.logn, pre, post, gather=True))


def test_k2_ntt_pass_operand_checks(card):
    """L != 16, misaligned or misplaced operands, and a pass of more stages
    than the kernel's tile holds raise on the card."""
    F = tfi.bls12_381_fq()  # 24 limbs: no instance
    ntt = NTT(tfi.bls12_381_fr(), 64, device="cpu")
    a = rand(F, 64, 22).to(card)
    with pytest.raises(ValueError):
        mont.ntt_pass(F, a, torch.zeros(32, 12, dtype=torch.int32, device=card), 0, 6, gather=True)
    Fr = ntt.F
    x = rand(Fr, 64, 23).to(card)
    table = ntt._tw_fwd_w.to(card)
    flat = torch.zeros(32 * 8 + 1, dtype=torch.int32, device=card)
    shifted = flat[1:].view(32, 8)  # 4-byte offset
    shifted.copy_(table)
    with pytest.raises(ValueError):
        mont.ntt_pass(Fr, x, shifted, 0, 6, gather=True)
    with pytest.raises(ValueError):
        mont.ntt_pass(Fr, x, ntt._tw_fwd_w, 0, 6, gather=True)  # table on the CPU
    lim = torch.zeros(64 * 16 + 4, dtype=torch.int32, device=card)
    ok = lim[4:].view(64, 16)  # 16-byte offset: aligned
    ok.copy_(x)
    got = mont.ntt_pass(Fr, ok, table, 0, 6, gather=True)
    assert torch.equal(got, mont.ntt_pass_plain(Fr, x, table, 0, 6, gather=True))
    with pytest.raises(ValueError):
        mont.ntt_pass(Fr, lim[1:1025].view(64, 16), table, 0, 6, gather=True)  # 4-byte offset
    big = NTT(Fr, 1 << 13, device=card)  # 13 stages in one pass: above the 2^12 tile
    with pytest.raises(RuntimeError):
        mont.ntt_pass(Fr, rand(Fr, 1 << 13, 24).to(card), big._tw_fwd_w, 0, 13, gather=True)


def curve_pairs(C, n):
    """n pairs of G1 points: identity on the left first, then P + (-P) and
    P + P among them (n > 2)."""
    pts, acc = [], None
    for _ in range(n + 2):
        acc = C.add(acc, C.generator)
        pts.append(acc)
    left = [None] + pts[1:n]
    right = pts[2 : n + 2] if n > 1 else [pts[0]]
    if n > 2:
        right[1] = C.neg(left[1])  # P + (-P)
        right[2] = left[2]  # P + P
    return left, right


def arbitrary(F, n, seed):
    """Two (x, y, z) triples of (n, L) canonical limb planes, off the curve,
    each coordinate 0, 1, p - 1 or p - 2 half of the time."""
    rng = np.random.default_rng(seed)
    special = F.encode([0, 1, F.p - 1, F.p - 2], mont=False, device="cpu")
    planes = []
    for k in range(6):
        x = rand(F, n, seed + k)
        pick = torch.from_numpy(rng.integers(0, 8, size=n))
        planes.append(torch.where((pick < 4)[:, None], special[pick.clamp(max=3)], x).contiguous())
    return tuple(planes[:3]), tuple(planes[3:])


def point_add_cases(F, C, n, card):
    """(P, Q) on the card: the curve pairs, then the arbitrary triples."""
    dev = SWDevice(F, C, device=card)
    left, right = curve_pairs(C, n)
    P, Q = dev.encode_points(left), dev.encode_points(right)
    yield tuple(P[k] for k in "xyz"), tuple(Q[k] for k in "xyz"), (dev, left, right)
    P, Q = arbitrary(F, n, n)
    yield tuple(t.to(card) for t in P), tuple(t.to(card) for t in Q), None


CURVES = {
    "bls12_381": (tfi.bls12_381_fq, ci.BLS12_381_G1),
    "bn254": (tfi.bn254_fq, ci.BN254_G1),
    "vesta": (tfi.pasta_fq, ci.VESTA),
    "pallas": (tfi.pasta_fp, ci.PALLAS),
}


@pytest.mark.parametrize("n", [1, 5, 300, 4097])
@pytest.mark.parametrize("curve", ["bls12_381", "vesta", "pallas"])
def test_k3_equals_twin_and_host(card, curve, n):
    Fq, C = CURVES[curve][0](), CURVES[curve][1]
    b3m = SWDevice(Fq, C, device=card)._b3m
    for Pt, Qt, host in point_add_cases(Fq, C, n, card):
        got = curve_add.sw_add(Fq, b3m, Pt, Qt)
        want = curve_add.rcb_add_plain(Fq, b3m, tuple(t.cpu() for t in Pt), tuple(t.cpu() for t in Qt))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        if host:
            dev, left, right = host
            assert dev.decode_points(dict(zip("xyz", got))) == [C.add(a, b) for a, b in zip(left, right)]


@pytest.mark.parametrize("kernel", ["k3", "k5c"])
@pytest.mark.parametrize(
    "curve,chain",
    [("bn254", True), ("bn254", False), ("bls12_381", True), ("bls12_381", False),
     ("vesta", False), ("pallas", False)],
)
def test_point_adds_both_widths_and_b3_paths(card, monkeypatch, curve, chain, kernel):
    """K3 and K5c at W = 8 (BN254, 3b = 9) and W = 12 (BLS12-381, 3b = 12),
    with the addition chain for 3b and with the general multiply by 3b R;
    over the Pasta curves (W = 8, 3b = 15) in the strict arithmetic."""
    F, C = CURVES[curve][0](), CURVES[curve][1]
    if not chain:
        monkeypatch.setattr(curve_add, "SMALL_B3", ())
        monkeypatch.setattr(F, "_kernel_b3", {}, raising=False)  # the field's cached choice
    b3m = SWDevice(F, C, device=card)._b3m
    assert (curve_add.kernel_b3(F, b3m)[1] != 0) == chain
    add, twin = {"k3": (curve_add.sw_add, curve_add.rcb_add_plain),
                 "k5c": (curve_add.sw_add_mma, curve_add.rcb_add_mma_plain)}[kernel]
    for Pt, Qt, _ in point_add_cases(F, C, 300, card):
        got = add(F, b3m, Pt, Qt)
        want = twin(F, b3m, tuple(t.cpu() for t in Pt), tuple(t.cpu() for t in Qt))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_wrapper_operand_checks(card):
    F = tfi.bls12_381_fr()
    a = rand(F, 9, 6).to(card)
    flat = a.view(-1)
    with pytest.raises(ValueError):
        mont.mont_mul(F, a, a.cpu())  # mixed devices
    with pytest.raises(ValueError):
        mont.mont_mul(F, flat[1:113].view(7, 16), a[:7])  # 4-byte offset
    shifted = flat[8:120].view(7, 16)  # 32-byte offset: aligned
    got = mont.mont_mul(F, shifted, a[:7]).cpu()
    assert torch.equal(got, mont.mont_mul_plain(F, shifted.cpu(), a[:7].cpu()))


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 4099])
@pytest.mark.parametrize("name", ["bls12_381_fr", "bls12_381_fq", "bw6_761_fq"])
def test_k4_equals_twin(card, name, n):
    F = getattr(tfi, name)()
    a, b = rand(F, n, 11), rand(F, n, 12)
    eng = field_mul.make(F)
    before = cuda_lib.LAUNCHES["k4_field_mul"]
    got = eng.mul(a.to(card), b.to(card)).cpu()
    assert torch.equal(got, eng.mul_reference(a, b))
    assert torch.equal(got, mont.mont_mul_plain(F, a, b))
    assert cuda_lib.LAUNCHES["k4_field_mul"] == before + (1 if n else 0)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 4099, 300000])
@pytest.mark.parametrize("name", ["bls12_381_fr", "bls12_381_fq", "bw6_761_fq"])
def test_k5a_equals_twin_and_k1(card, name, n):
    F = getattr(tfi, name)()
    a, b = rand(F, n, 13), rand(F, n, 14)
    before = cuda_lib.LAUNCHES["k5a_mont_mul_mma"]
    got = mont_mma.mont_mul_mma(F, a.to(card), b.to(card))
    assert torch.equal(got.cpu(), mont_mma.mont_mul_mma_plain(F, a, b))
    assert torch.equal(got, mont.mont_mul(F, a.to(card), b.to(card)))  # K1
    assert cuda_lib.LAUNCHES["k5a_mont_mul_mma"] == before + (1 if n else 0)


@pytest.mark.parametrize("name", ["bls12_381_fr", "bls12_381_fq", "bw6_761_fq"])
def test_k5a_edge_values_equal_twin_and_k1(card, name):
    """Operands 0, 1, p - 1 and p - 2 half of the time (all their pairs
    among them), else uniform: the redesigned multiply's carry chains at
    their extremes."""
    F = getattr(tfi, name)()
    n = 5000
    special = F.encode([0, 1, F.p - 1, F.p - 2], mont=False, device="cpu")
    rng = np.random.default_rng(19)
    ops = []
    for k in range(2):
        x = rand(F, n, 30 + k)
        pick = torch.from_numpy(rng.integers(0, 8, size=n))
        ops.append(torch.where((pick < 4)[:, None], special[pick.clamp(max=3)], x).contiguous())
    a, b = ops
    got = mont_mma.mont_mul_mma(F, a.to(card), b.to(card))
    assert torch.equal(got.cpu(), mont_mma.mont_mul_mma_plain(F, a, b))
    assert torch.equal(got, mont.mont_mul(F, a.to(card), b.to(card)))  # K1


@pytest.mark.parametrize("n", [2, 4, 1024, 4096, 1 << 13, 1 << 15])
@pytest.mark.parametrize("name,g", [("bls12_381_fr", 7), ("pasta_fp", 5)])
def test_k5b_ntt_pass_equals_twin_k2_and_stage_loop(card, monkeypatch, name, g, n):
    """ZKCP_MXU=1: each pass of each operation equal to ntt_pass_mma_plain
    on the same input; the transform launching k5b_ntt_pass once a pass
    (and no one-stage K5b), equal to its passes, to the stage loop through
    K5b and K5a, and to K2's passes."""
    F = getattr(tfi, name)()
    ntt = NTT(F, n, device=card)
    a = rand(F, n, 25).to(card)
    for op in NTT_OPS:
        args = (g,) if op.startswith("coset") else ()
        k2 = getattr(ntt, op)(a, *args)
        table, pre, post = ntt.pass_operands(op, g)
        x, last = a, len(ntt.plan) - 1
        for i, (s0, t) in enumerate(ntt.plan):
            kw = dict(pre=pre if i == 0 else None, post=post if i == last else None, gather=i == 0)
            got = mont_mma.ntt_pass_mma(F, x, table, s0, t, **kw)
            assert torch.equal(got, mont_mma.ntt_pass_mma_plain(F, x, table, s0, t, **kw)), (op, s0, t)
            x = got
        monkeypatch.setenv("ZKCP_MXU", "1")
        before = dict(cuda_lib.LAUNCHES)
        res = getattr(ntt, op)(a, *args)
        assert cuda_lib.LAUNCHES["k5b_ntt_pass"] == before.get("k5b_ntt_pass", 0) + len(ntt.plan)
        assert cuda_lib.LAUNCHES["k5b_butterfly_mma"] == before.get("k5b_butterfly_mma", 0)
        assert torch.equal(res, x) and torch.equal(res, k2)
        assert torch.equal(res, ntt.stage_route(op, a, g))
        monkeypatch.delenv("ZKCP_MXU")


@pytest.mark.parametrize("B,n", [(512, 512), (3, 4096), (2, 1 << 15), (5, 2)])
@pytest.mark.parametrize("kernel", ["k2_ntt_pass", "k5b_ntt_pass"])
def test_batched_ntt_pass_equals_twin_and_single_launches(card, monkeypatch, kernel, B, n):
    """A batch (B, n, L) of transforms, every pass ONE launch, equal to the
    batched twin and to B launches on one transform each (coset_forward's
    pre and inverse's post shared by the batch); forward_batched and
    inverse_batched launch once a pass of the plan."""
    run, plain = ((mont.ntt_pass, mont.ntt_pass_plain) if kernel == "k2_ntt_pass"
                  else (mont_mma.ntt_pass_mma, mont_mma.ntt_pass_mma_plain))
    F = tfi.bls12_381_fr()
    ntt = NTT(F, n, device=card)
    a = rand(F, B * n, 29).to(card).reshape(B, n, F.L)
    for op in ("forward", "coset_forward", "inverse"):
        table, pre, post = ntt.pass_operands(op, 7)
        x, last = a, len(ntt.plan) - 1
        for i, (s0, t) in enumerate(ntt.plan):
            kw = dict(pre=pre if i == 0 else None, post=post if i == last else None, gather=i == 0)
            before = cuda_lib.LAUNCHES[kernel]
            got = run(F, x, table, s0, t, **kw)
            assert cuda_lib.LAUNCHES[kernel] == before + 1
            assert torch.equal(got, plain(F, x, table, s0, t, **kw)), (op, s0, t)
            one = torch.stack([run(F, x[b].contiguous(), table, s0, t, **kw) for b in range(B)])
            assert torch.equal(got, one), (op, s0, t)
            x = got
    if kernel == "k5b_ntt_pass":
        monkeypatch.setenv("ZKCP_MXU", "1")
    before = cuda_lib.LAUNCHES[kernel]
    fwd = ntt.forward_batched(a)
    assert torch.equal(ntt.inverse_batched(fwd), a)
    assert cuda_lib.LAUNCHES[kernel] == before + 2 * len(ntt.plan)
    assert torch.equal(fwd[B - 1], ntt.forward(a[B - 1]))


def test_k5b_ntt_pass_operand_checks(card):
    """L != 16 and a pass of more stages than the tile holds raise on the
    card; a CPU table with a card array raises."""
    Fq = tfi.bls12_381_fq()
    with pytest.raises(ValueError):
        mont_mma.ntt_pass_mma(Fq, rand(Fq, 64, 26).to(card),
                              torch.zeros(32, 12, dtype=torch.int32, device=card), 0, 6, gather=True)
    Fr = tfi.bls12_381_fr()
    ntt = NTT(Fr, 64, device="cpu")
    x = rand(Fr, 64, 27).to(card)
    with pytest.raises(ValueError):
        mont_mma.ntt_pass_mma(Fr, x, ntt._tw_fwd_w, 0, 6, gather=True)  # table on the CPU
    big = NTT(Fr, 1 << 13, device=card)  # 13 stages in one pass: above the 2^12 tile
    with pytest.raises(RuntimeError):
        mont_mma.ntt_pass_mma(Fr, rand(Fr, 1 << 13, 28).to(card), big._tw_fwd_w, 0, 13, gather=True)


@pytest.mark.parametrize("n", [1, 33, 2048])
@pytest.mark.parametrize("name", ["bls12_381_fr", "bw6_761_fq"])
def test_k5b_equals_twin_and_k2(card, name, n):
    F = getattr(tfi, name)()
    u, v, w = rand(F, n, 15), rand(F, n, 16), rand(F, n, 17)
    hi, lo = mont_mma.butterfly_mma(F, u.to(card), v.to(card), w.to(card))
    phi, plo = mont_mma.butterfly_mma_plain(F, u, v, w)
    assert torch.equal(hi.cpu(), phi) and torch.equal(lo.cpu(), plo)
    khi, klo = mont.butterfly(F, u.to(card), v.to(card), w.to(card))  # K2
    assert torch.equal(hi, khi) and torch.equal(lo, klo)


@pytest.mark.parametrize("n", [1, 5, 300, 4097])
@pytest.mark.parametrize("curve", ["bls12_381", "vesta", "pallas"])
def test_k5c_equals_twin_and_k3(card, curve, n):
    Fq, C = CURVES[curve][0](), CURVES[curve][1]
    b3m = SWDevice(Fq, C, device=card)._b3m
    for Pt, Qt, host in point_add_cases(Fq, C, n, card):
        got = curve_add.sw_add_mma(Fq, b3m, Pt, Qt)
        want = curve_add.rcb_add_mma_plain(
            Fq, b3m, tuple(t.cpu() for t in Pt), tuple(t.cpu() for t in Qt)
        )
        k3 = curve_add.sw_add(Fq, b3m, Pt, Qt)
        for g, w, k in zip(got, want, k3):
            assert torch.equal(g.cpu(), w) and torch.equal(g, k)
        if host:
            dev, left, right = host
            assert dev.decode_points(dict(zip("xyz", got))) == [C.add(a, b) for a, b in zip(left, right)]


def test_mxu_switch_routes_to_k5(card, monkeypatch):
    """ZKCP_MXU=1: Fp.mul, the NTT and G1 adds launch K5a, K5b's passes and
    K5c, and none of K1-K3 nor the one-stage K5b."""
    from contangle_zkcp_tpu_torch.ops.ntt import NTT

    monkeypatch.setenv("ZKCP_MXU", "1")
    F = tfi.bls12_381_fr()
    x = rand(F, 1 << 12, 18).to(card)
    cuda_lib.reset_launches()
    F.mul(x, x)
    ntt = NTT(F, 1 << 12, device=card)
    assert torch.equal(ntt.inverse(ntt.forward(x)), x)
    Fq = tfi.bls12_381_fq()
    dev = SWDevice(Fq, ci.BLS12_381_G1, device=card)
    P = dev.encode_points([ci.BLS12_381_G1.generator] * 4)
    dev.add(P, P)
    counts = dict(cuda_lib.LAUNCHES)
    assert all(counts.get(k, 0) > 0 for k in ("k5a_mont_mul_mma", "k5b_ntt_pass", "k5c_sw_add_mma"))
    assert all(counts.get(k, 0) == 0 for k in ("k1_mont_mul", "k2_butterfly", "k2_ntt_pass", "k3_sw_add",
                                                "k5b_butterfly_mma"))


@pytest.mark.parametrize("engine", ["balanced", "tree"])
@pytest.mark.parametrize("group,signed,kind", [
    ("g1", True, "skewed"), ("g1", False, "skewed"), ("g1", True, "adversarial"), ("g2", True, "skewed"),
])
def test_grid_engines_equal_msm_host(card, engine, group, signed, kind):
    """BalancedMSM (a 64-lane overflow pool, so segments, fold levels and
    merges run) and TreeMSM on the card against the exact host sum:
    witness-like scalars, or duplicates, P and -P, identity inputs and a
    zero scalar."""
    import random

    from contangle_zkcp_tpu_torch.curves.fq2_device import Fq2Device
    from contangle_zkcp_tpu_torch.fields.bigint import ints_to_limbs
    from contangle_zkcp_tpu_torch.ops.msm_balanced import BalancedMSM
    from contangle_zkcp_tpu_torch.ops.msm_tree import TreeMSM

    C, R = ci.BLS12_381_G1, tfi.BLS12_381_R
    Fq = tfi.bls12_381_fq()
    if group == "g1":
        dev, gen = SWDevice(Fq, C, device=card), C.generator
    else:
        dev = SWDevice(Fq2Device(Fq), b=ci.BLS12_381_G2_B, device=card)
        gen = (ci.BLS12_381_G2_GX, ci.BLS12_381_G2_GY)
    rng = random.Random(31)
    n = 96 if group == "g1" else 24
    ks = [rng.randrange(1, R) for _ in range(n)]
    sc = [rng.randrange(R) if i % 8 == 0 else rng.choice([0, 1, 1, 3]) for i in range(n)]
    if kind == "adversarial":
        ks[:6] = [ks[0], ks[0], ks[0], R - ks[0], ks[4], ks[4]]
        sc[:6] = [sc[0], sc[0], sc[0], sc[0], 7, 7]
        ks[6] = 0  # the identity
        sc[8] = 0
    pts = [dev.host_mul(k, gen) if k else None for k in ks]
    want = dev.host_mul(sum(s * k for s, k in zip(sc, ks)) % R, gen)
    if engine == "balanced":
        eng = BalancedMSM(dev, 255, c=6, signed=signed, overflow_lanes=64)
        assert eng.schedule(ints_to_limbs(sc, 16))["nlev"] >= 1
    else:
        eng = TreeMSM(dev, 255, c=6, signed=signed)
    cuda_lib.reset_launches()
    assert eng.run(dev.encode_points(pts), ints_to_limbs(sc, 16)) == want
    add = "k3_sw_add" if group == "g1" else "k1_mont_mul"
    assert cuda_lib.LAUNCHES[add] > 0


def test_edwards_device_equals_host(card):
    import random

    from contangle_zkcp_tpu_torch.curves.edwards import EdwardsDevice

    J = ci.JUBJUB
    dev = EdwardsDevice(tfi.jubjub_fq(), J, device=card)
    rng = random.Random(41)
    ks = [rng.randrange(1, J.order) for _ in range(6)] + [0, 1]
    pts = [J.mul(k, J.generator) for k in ks]
    P = dev.encode_points(pts)
    Q = dev.encode_points(pts[1:] + pts[:1])
    cuda_lib.reset_launches()
    assert dev.decode_points(dev.add(P, Q)) == [J.add(a, b) for a, b in zip(pts, pts[1:] + pts[:1])]
    assert dev.decode_points(dev.double(P)) == [J.add(a, a) for a in pts]
    assert dev.decode_points(dev.scalar_mul_ints(P, ks)) == [J.mul(k, p) for k, p in zip(ks, pts)]
    assert cuda_lib.LAUNCHES["k1_mont_mul"] > 0
