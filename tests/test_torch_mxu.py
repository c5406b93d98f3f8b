"""The tensor-core configuration (ops/mont_mma.py, K5a-K5c) and K4's entry
point (ops/field_mul.py) on the CPU, exactly:

  * the twins' Toeplitz matrices equal the JAX package's
    `_toeplitz_cat(_const_byte_planes(...))`;
  * the K5a/K5b/K5c twins equal the K1/K2/K3 twins at n = 256;
  * the kernels' fragment tables and staging layouts, replayed in numpy
    with the PTX m16n8k32 fragment layout, give the constant products:
    K5c's (csrc/k5c_sw_add_mma.cu, an m-tile of column sums at a time)
    and csrc/k5_mont.cuh's halfword sums (K5a, K5b), with the latter's
    carry chains replayed word by word;
  * ZKCP_MXU=1 routes Fp.mul, the NTT (to the tensor-core passes) and G1
    adds to the K5 twins;
  * K4's twin equals the JAX `PallasFieldOps.mul_reference` at n = 64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu.ops import pallas_field as jpallas_field
from contangle_zkcp_tpu.ops import pallas_mont as jpallas_mont
from contangle_zkcp_tpu_torch.curves import instances as ci
from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.ops import curve_add, field_mul, mont, mont_mma
from tests.torch_port_util import one_torch_thread, rand_ints  # noqa: F401

FIELDS = {
    "fr": (jfi.bls12_381_fr, tfi.bls12_381_fr),
    "fq": (jfi.bls12_381_fq, tfi.bls12_381_fq),
}


def limbs(F, vals):
    return F.encode(vals, device="cpu")


@pytest.mark.parametrize("const", ["npinv", "p"])
@pytest.mark.parametrize("name", list(FIELDS))
def test_toeplitz_matrices_equal_reference(name, const):
    jF, tF = FIELDS[name][0](), FIELDS[name][1]()
    L = tF.L
    out16 = L if const == "npinv" else 2 * L
    want = jpallas_mont._toeplitz_cat(
        jpallas_mont._const_byte_planes(getattr(jF, f"{const}_limbs")), out16, L
    )
    planes = mont_mma.const_byte_planes(getattr(tF, f"{const}_limbs"))
    np.testing.assert_array_equal(planes, jpallas_mont._const_byte_planes(getattr(jF, f"{const}_limbs")))
    got = mont_mma.toeplitz_cat(planes, out16, L)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(FIELDS))
def test_k5a_twin_equals_k1_twin(name):
    F = FIELDS[name][1]()
    a = limbs(F, rand_ints(F.p, 253, 31))
    b = limbs(F, rand_ints(F.p, 253, 32)[::-1])
    got = mont_mma.mont_mul_mma_plain(F, a, b)
    assert torch.equal(got, mont.mont_mul_plain(F, a, b))
    rinv = pow(F.R, -1, F.p)
    assert F.decode(got, mont=False) == [
        x * y * rinv % F.p for x, y in zip(F.decode(a, mont=False), F.decode(b, mont=False))
    ]


def test_k5b_twin_equals_k2_twin():
    F = tfi.bls12_381_fr()
    u, v, w = (limbs(F, rand_ints(F.p, 253, s)) for s in (33, 34, 35))
    for got, want in zip(mont_mma.butterfly_mma_plain(F, u, v, w), mont.butterfly_plain(F, u, v, w)):
        assert torch.equal(got, want)


def test_k5c_twin_equals_k3_twin():
    Fq = tfi.bls12_381_fq()
    C = ci.BLS12_381_G1
    dev = SWDevice(Fq, C, device="cpu")
    pts, acc = [], None
    for _ in range(258):
        acc = C.add(acc, C.generator)
        pts.append(acc)
    left = [None] + pts[1:256]
    right = pts[2:258]
    right[1], right[2] = C.neg(left[1]), left[2]  # P + (-P), P + P
    P, Q = dev.encode_points(left), dev.encode_points(right)
    Pt, Qt = tuple(P[k] for k in "xyz"), tuple(Q[k] for k in "xyz")
    got = curve_add.rcb_add_mma_plain(Fq, dev._b3m, Pt, Qt)
    for g, w in zip(got, curve_add.rcb_add_plain(Fq, dev._b3m, Pt, Qt)):
        assert torch.equal(g, w)
    assert dev.decode_points(dict(zip("xyz", got)))[:8] == [C.add(a, b) for a, b in zip(left[:8], right[:8])]


# ----------------------------------------- the kernels' layout, replayed


def _mma(frag, b0, b1):
    """One m16n8k32 u8 product from per-lane registers (PTX ISA layout):
    A from the (32, 4) fragment words, B from b0/b1; returns (16, 8)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for k in range(4):
            for q in range(4):
                A[g + 8 * (q & 1), 4 * t + 16 * (q >> 1) + k] = (int(frag[lane, q]) >> (8 * k)) & 0xFF
            B[4 * t + k, g] = (int(b0[lane]) >> (8 * k)) & 0xFF
            B[16 + 4 * t + k, g] = (int(b1[lane]) >> (8 * k)) & 0xFF
    return A @ B


def _const_product(frags, tile0, MT, W, KS, x_words, add=None):
    """One constant product as csrc/k5c_sw_add_mma.cu stages it
    (group_tile, then the owner's fold), for one warp of 32 elements."""
    sB = np.zeros((32, 8 * KS), np.uint64)
    sB[:, :W] = x_words[:, :W]
    out = [[0] * (4 * MT) for _ in range(32)]
    carry = [0] * 32
    for mt in range(MT):
        sC = np.zeros((32, 16), np.int64)
        for j in range(4):
            acc = np.zeros((16, 8), np.int64)
            for ks in range(KS):
                if mont_mma.tile_used(mt, ks, W):
                    b0 = [sB[8 * j + (lane >> 2), 8 * ks + (lane & 3)] for lane in range(32)]
                    b1 = [sB[8 * j + (lane >> 2), 8 * ks + 4 + (lane & 3)] for lane in range(32)]
                    acc += _mma(frags[tile0 + mt * KS + ks], b0, b1)
            for lane in range(32):  # C fragment -> staged [element][row]
                g, t = lane >> 2, lane & 3
                for c, (row, col) in enumerate(((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1))):
                    sC[8 * j + col, row] = acc[row, col]
        for e in range(32):
            for q in range(4):
                s = carry[e] + sum(int(sC[e, 4 * q + k]) << (8 * k) for k in range(4))
                s += 0 if add is None else int(add[e][4 * mt + q])
                out[e][4 * mt + q], carry[e] = s & 0xFFFFFFFF, s >> 32
    return out, carry


@pytest.mark.parametrize("name", list(FIELDS))
def test_kernel_fragments_give_constant_products(name):
    F = FIELDS[name][1]()
    W, KS, mt_np, mt_p = mont_mma.mma_shape(F.L)
    frags = mont_mma.mma_fragments(F).view(np.uint32).reshape(-1, 32, 4)
    assert frags.shape[0] == (mt_np + mt_p) * KS
    for base, mts in ((0, mt_np), (mt_np * KS, mt_p)):  # a skipped tile is all zeros
        for mt in range(mts):
            for ks in range(KS):
                if not mont_mma.tile_used(mt, ks, W):
                    assert not frags[base + mt * KS + ks].any()
    R = 1 << (32 * W)
    a, b = rand_ints(F.p, 29, 36), rand_ints(F.p, 29, 37)
    T = [x * y for x, y in zip(a, b)]

    def words(vals, n):
        return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)] for v in vals], np.uint64)

    m, _ = _const_product(frags, 0, mt_np, W, KS, words([t % R for t in T], W))
    m_int = [sum(w << (32 * i) for i, w in enumerate(row)) for row in m]
    npinv = (-pow(F.p, -1, R)) % R
    assert m_int == [(t % R) * npinv % R for t in T]
    u, top = _const_product(frags, mt_np * KS, mt_p, W, KS, np.array(m, np.uint64), add=[words([t], 2 * W)[0] for t in T])
    u_int = [sum(w << (32 * i) for i, w in enumerate(row)) + (c << (64 * W)) for row, c in zip(u, top)]
    assert u_int == [t + mi * F.p for t, mi in zip(T, m_int)]
    assert all(x % R == 0 for x in u_int)


def _const_sums_hw(frags, tile0, MT, W, KS, x_words, add=None):
    """csrc/k5_mont.cuh const_sums and fold_row for one warp of 32
    elements: B fragments from the staged rows, the C fragment's rows g and
    g + 8 added into one halfword sum by the lane, stored to the element's
    row at slot 8 mt + g, then folded with fold_word's carries."""
    sB = np.zeros((32, 8 * KS), np.uint64)
    sB[:, :W] = x_words[:, :W]
    sC = np.zeros((32, 8 * MT), np.int64)
    for mt in range(MT):
        for j in range(4):
            acc = np.zeros((16, 8), np.int64)
            for ks in range(KS):
                if mont_mma.tile_used(mt, ks, W):
                    b0 = [sB[8 * j + (lane >> 2), 8 * ks + (lane & 3)] for lane in range(32)]
                    b1 = [sB[8 * j + (lane >> 2), 8 * ks + 4 + (lane & 3)] for lane in range(32)]
                    acc += _mma(frags[tile0 + mt * KS + ks], b0, b1)
            assert acc.max() < 1 << 23
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for col in (2 * t, 2 * t + 1):
                    sC[8 * j + col, 8 * mt + g] = acc[g, col] + (acc[g + 8, col] << 8)
    assert sC.max() < 1 << 32
    out, carry = [[0] * (4 * MT) for _ in range(32)], [0] * 32
    for e in range(32):
        for q in range(4 * MT):
            s = int(sC[e, 2 * q]) + (int(sC[e, 2 * q + 1]) << 16) + carry[e]
            s += 0 if add is None else int(add[e][q])
            out[e][q], carry[e] = s & 0xFFFFFFFF, s >> 32
            assert carry[e] < (1 << 17) + 3  # fold_word's bound
    return out, carry


@pytest.mark.parametrize("name", ["fr", "fq", "bw6"])
def test_hw_fragments_give_constant_products(name):
    """K5a's table (mma_fragments_hw: each m-tile's rows in hw_rows order)
    through k5_mont.cuh's staging and fold gives m = (T mod R) N' mod R and
    T + m p, for products of random and edge values (p - 1, p - 2)."""
    F = tfi.bw6_761_fq() if name == "bw6" else FIELDS[name][1]()
    W, KS, mt_np, mt_p = mont_mma.mma_shape(F.L)
    frags = mont_mma.mma_fragments_hw(F).view(np.uint32).reshape(-1, 32, 4)
    natural = mont_mma.mma_fragments(F).view(np.uint32).reshape(-1, 32, 4)
    assert frags.shape == natural.shape and sorted(mont_mma.hw_rows()) == list(range(16))
    R = 1 << (32 * W)
    a = rand_ints(F.p, 28, 41)[:28] + [F.p - 1, F.p - 1, F.p - 2, 1]
    b = rand_ints(F.p, 28, 42)[:28] + [F.p - 1, F.p - 2, F.p - 2, F.p - 1]
    T = [x * y for x, y in zip(a, b)]

    def words(vals, n):
        return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)] for v in vals], np.uint64)

    m, _ = _const_sums_hw(frags, 0, mt_np, W, KS, words([t % R for t in T], W))
    m_int = [sum(w << (32 * i) for i, w in enumerate(row)) for row in m]
    npinv = (-pow(F.p, -1, R)) % R
    assert m_int == [(t % R) * npinv % R for t in T]
    u, top = _const_sums_hw(frags, mt_np * KS, mt_p, W, KS, np.array(m, np.uint64),
                            add=[words([t], 2 * W)[0] for t in T])
    u_int = [sum(w << (32 * i) for i, w in enumerate(row)) + (c << (64 * W)) for row, c in zip(u, top)]
    assert u_int == [t + mi * F.p for t, mi in zip(T, m_int)]


def _mul_wide_chains(a, b, W):
    """csrc/k5_mont.cuh mul_wide, instruction by instruction, with the
    carry flag: row 0 by mul.lo and one mad.hi chain, each later row by a
    mad.lo chain closed by addc and a mad.hi chain one word up, whose last
    madc.hi may not carry out (asserted)."""
    M = 0xFFFFFFFF
    T = [0] * (2 * W)
    for j in range(W):
        T[j] = (a[j] * b[0]) & M
    cc = 0
    for j in range(W):  # mad.hi.cc / madc.hi.cc / madc.hi into T[1..W]
        s = T[j + 1] + ((a[j] * b[0]) >> 32) + cc
        T[j + 1], cc = s & M, s >> 32
    assert cc == 0
    for i in range(1, W):
        cc = 0
        for j in range(W):
            s = T[i + j] + ((a[j] * b[i]) & M) + cc
            T[i + j], cc = s & M, s >> 32
        T[i + W] = cc  # addc.u32 0, 0
        cc = 0
        for j in range(W):
            s = T[i + j + 1] + ((a[j] * b[i]) >> 32) + cc
            T[i + j + 1], cc = s & M, s >> 32
        assert cc == 0, (i, "the last madc.hi carried out")
    return T


@pytest.mark.parametrize("W", [8, 12, 24])
def test_mul_wide_carry_chains(W):
    """The schoolbook's two carry chains a row give a*b for random words,
    all-ones words and the fields' p - 1, and never carry out of the row."""
    M = (1 << 32) - 1
    rng = np.random.default_rng(W)
    ps = {8: tfi.bls12_381_fr().p, 12: tfi.bls12_381_fq().p, 24: tfi.bw6_761_fq().p}
    vals = [int.from_bytes(rng.bytes(4 * W), "little") for _ in range(6)]
    vals += [(1 << (32 * W)) - 1, ps[W] - 1, 0, 1]
    for x in vals:
        for y in vals[::-1]:
            a = [(x >> (32 * j)) & M for j in range(W)]
            b = [(y >> (32 * j)) & M for j in range(W)]
            T = _mul_wide_chains(a, b, W)
            assert sum(w << (32 * k) for k, w in enumerate(T)) == x * y


def test_mxu_switch_routes_to_k5_twins(monkeypatch):
    """Under ZKCP_MXU=1 the wrappers take the K5 twins (counted here with
    spies), the NTT its tensor-core passes' twin, and the results stay
    K1-K3's."""
    from contangle_zkcp_tpu_torch.ops.ntt import NTT

    calls = []
    for mod, name in ((mont_mma, "mont_mul_mma_plain"), (mont_mma, "butterfly_mma_plain"),
                      (mont_mma, "ntt_pass_mma_plain"), (curve_add, "rcb_add_mma_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    F = tfi.bls12_381_fr()
    x = limbs(F, rand_ints(F.p, 13, 38))
    want = mont.mont_mul_plain(F, x, x)
    ntt = NTT(F, 16, device="cpu")
    monkeypatch.setenv("ZKCP_MXU", "1")
    assert torch.equal(F.mul(x, x), want)
    assert torch.equal(ntt.inverse(ntt.forward(x)), x)
    dev = SWDevice(tfi.bls12_381_fq(), ci.BLS12_381_G1, device="cpu")
    G = ci.BLS12_381_G1.generator
    P = dev.encode_points([G])
    assert dev.decode_points(dev.add(P, P)) == [ci.BLS12_381_G1.add(G, G)]
    assert {"mont_mul_mma_plain", "butterfly_mma_plain", "ntt_pass_mma_plain",
            "rcb_add_mma_plain"} <= set(calls)
    before = calls.count("ntt_pass_mma_plain")
    ntt.forward(x)
    assert calls.count("ntt_pass_mma_plain") == before + len(ntt.plan)


@pytest.mark.parametrize("name", list(FIELDS))
def test_k4_twin_equals_jax_mul_reference(name):
    jF, tF = FIELDS[name][0](), FIELDS[name][1]()
    a = np.asarray(jF.encode(rand_ints(jF.p, 61, 39)))
    b = np.asarray(jF.encode(rand_ints(jF.p, 61, 40)))[::-1].copy()
    want = np.asarray(jpallas_field.make(jF).mul_reference(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = (torch.from_numpy(x.astype(np.int32)) for x in (a, b))
    eng = field_mul.make(tF)
    np.testing.assert_array_equal(eng.mul_reference(ta, tb).numpy(), want)
    np.testing.assert_array_equal(eng.mul(ta, tb).numpy(), want)
    assert torch.equal(eng.mul(ta, tb), mont.mont_mul_plain(tF, ta, tb))
