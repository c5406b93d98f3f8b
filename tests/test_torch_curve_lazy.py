"""The lazily reduced arithmetic of the point-add kernels K3 and K5c,
which the CPU cannot run, replayed in Python integers.

csrc/fp_lazy.cuh keeps every value in [0, 2p) between operations (sound
for 4p < R) and makes each output coordinate canonical once, before its
store; K3 (csrc/k3_sw_add.cu) multiplies in even/odd CIOS carry chains,
K5c (csrc/k5c_sw_add_mma.cu) reduces T = a b from the column sums of the
tensor-core products and recovers the carry out of T mod R from the
folded low words; both multiply by 3b = 9 or 12 with an addition chain.
`Lazy` mirrors those operations (the CIOS word by word, with its carry
flag), asserts each operand and result inside its stated bound and each
carry the kernels drop zero; `k3_schedule` and `k5c_schedule` replay the
kernels' sequences of operations.  Their outputs must equal the torch
twin `rcb_add_plain` (which K3 and K5c are held to on the card), for
BLS12-381 G1 (W = 12, 3b = 12) and BN254 G1 (W = 8, 3b = 9), on points
of the curve and on arbitrary triples (the formula is defined for every
triple) with the coordinates 0, 1, p - 1 and p - 2 among them.

For a field without the lazy headroom (4p >= R: the Pasta fields, and
secp256k1's with 2p >= R) the kernels take the strict arithmetic
instead: mont.cuh's multiply, modular add and subtract, every value
canonical, the carry out of the top word kept; K5c keeps the carry out of
its reduced product and subtracts p once.  `Strict` replays those word by
word (every operand below p, every carry the code drops zero), over the
same schedules, for Vesta, Pallas and secp256k1.
"""

import numpy as np
import pytest
import torch

from contangle_zkcp_tpu_torch.curves import instances as ci
from contangle_zkcp_tpu_torch.curves.weierstrass import SWDevice
from contangle_zkcp_tpu_torch.fields import instances as tfi
from contangle_zkcp_tpu_torch.ops import curve_add, mont
from contangle_zkcp_tpu_torch.zkcp import secp
from tests.torch_port_util import one_torch_thread  # noqa: F401

M32 = (1 << 32) - 1
CURVES = {
    "bls12_381": (tfi.bls12_381_fq, ci.BLS12_381_G1, 12),
    "bn254": (tfi.bn254_fq, ci.BN254_G1, 9),
}
# fields without the lazy headroom: the strict arithmetic, 3b general
STRICT_CURVES = {
    "vesta": (tfi.pasta_fq, ci.VESTA, 0),
    "pallas": (tfi.pasta_fp, ci.PALLAS, 0),
    "secp256k1": (lambda: tfi.get_field(tfi.SECP256K1_P, "secp256k1_fp"), secp.SECP256K1, 0),
}


class Carry:
    """The PTX carry flag and the instructions fp_lazy.cuh uses."""

    def __init__(self):
        self.cf = 0

    def _set(self, s):
        self.cf = s >> 32
        assert self.cf in (0, 1)
        return s & M32

    def add_cc(self, a, b):
        return self._set(a + b)

    def addc_cc(self, a, b):
        return self._set(a + b + self.cf)

    def addc(self, a, b, drops=False):
        s = a + b + self.cf
        assert drops or s >> 32 == 0, "a carry the kernel drops is not zero"
        return s & M32

    def sub_cc(self, a, b):
        s = a - b
        self.cf = int(s < 0)
        return s & M32

    def subc_cc(self, a, b):
        s = a - b - self.cf
        self.cf = int(s < 0)
        return s & M32

    def subc(self, a, b):
        return (a - b - self.cf) & M32

    def mad_lo_cc(self, a, b, c):
        return self._set(((a * b) & M32) + c)

    def madc_lo_cc(self, a, b, c):
        return self._set(((a * b) & M32) + c + self.cf)

    def madc_hi_cc(self, a, b, c):
        return self._set((a * b >> 32) + c + self.cf)

    def madc_hi(self, a, b, c):
        return self.addc(a * b >> 32, c)


def words(x, W):
    return [(x >> (32 * j)) & M32 for j in range(W)]


def value(ws):
    return sum(w << (32 * j) for j, w in enumerate(ws))


class Lazy:
    """fp_lazy.cuh over Python ints; every operation checks its bounds."""

    def __init__(self, F):
        self.p, self.W = F.p, F.L // 2
        self.R = 1 << (32 * self.W)
        assert 4 * self.p < self.R
        self.n0 = (-pow(self.p, -1, 1 << 32)) % (1 << 32)
        self.rinv = pow(self.R, -1, self.p)
        self.npinv = (-pow(self.p, -1, self.R)) % self.R
        self.pw, self.p2w = words(self.p, self.W), words(2 * self.p, self.W)

    def lazy(self, *xs):
        for x in xs:
            assert 0 <= x < 2 * self.p, "operand outside [0, 2p)"

    # -- the multiply of K3: even/odd CIOS, word by word (fp_lazy.cuh mul)
    def _reduce(self, c, E, O):
        W, p = self.W, self.pw
        m = (E[0] * self.n0) & M32
        O[0] = c.mad_lo_cc(p[1], m, O[0])
        O[1] = c.madc_hi_cc(p[1], m, O[1])
        for j in range(2, W - 2, 2):
            O[j] = c.madc_lo_cc(p[j + 1], m, O[j])
            O[j + 1] = c.madc_hi_cc(p[j + 1], m, O[j + 1])
        O[W - 2] = c.madc_lo_cc(p[W - 1], m, O[W - 2])
        O[W - 1] = c.madc_hi(p[W - 1], m, O[W - 1])
        c.add_cc(E[0], M32)
        E[1] = c.madc_hi_cc(p[0], m, E[1])
        for j in range(2, W, 2):
            E[j] = c.madc_lo_cc(p[j], m, E[j])
            E[j + 1] = c.madc_hi_cc(p[j], m, E[j + 1])
        O[W - 1] = c.addc(O[W - 1], 0)
        # E + 2^32 O is now divisible by 2^32, so E's low word is spent
        assert (E[0] + ((m * p[0]) & M32)) & M32 == 0

    def mul(self, x, y):
        self.lazy(x, y)
        W, c = self.W, Carry()
        a, b = words(x, W), words(y, W)
        E, O = [0] * W, [0] * W
        for j in range(0, W, 2):
            E[j], E[j + 1] = (a[j] * b[0]) & M32, a[j] * b[0] >> 32
            O[j], O[j + 1] = (a[j + 1] * b[0]) & M32, a[j + 1] * b[0] >> 32
        self._reduce(c, E, O)
        for i in range(1, W):
            E, O = O, E  # the accumulators trade places every row
            bi = b[i]
            E[0] = c.add_cc(E[0], O[1])
            for j in range(0, W - 2, 2):
                O[j] = c.madc_lo_cc(a[j + 1], bi, O[j + 2])
                O[j + 1] = c.madc_hi_cc(a[j + 1], bi, O[j + 3])
            O[W - 2] = c.madc_lo_cc(a[W - 1], bi, 0)
            O[W - 1] = c.madc_hi(a[W - 1], bi, 0)
            E[0] = c.mad_lo_cc(a[0], bi, E[0])
            E[1] = c.madc_hi_cc(a[0], bi, E[1])
            for j in range(2, W, 2):
                E[j] = c.madc_lo_cc(a[j], bi, E[j])
                E[j + 1] = c.madc_hi_cc(a[j], bi, E[j + 1])
            O[W - 1] = c.addc(O[W - 1], 0)
            self._reduce(c, E, O)
        r = [c.add_cc(O[0], E[1])]
        r += [c.addc_cc(O[k], E[k + 1]) for k in range(1, W - 1)]
        r.append(c.addc(O[W - 1], 0))
        r = value(r)
        assert r % self.p == x * y * self.rinv % self.p
        self.lazy(r)
        return r

    # -- the multiply of K5c: T mod R to the tensor cores, T div R kept
    def product(self, x, y):
        """k5c_sw_add_mma.cu stage_product: T = x y word by word, in the
        accumulators U (i + j even) and V (i + j odd, one word down)."""
        W, c = self.W, Carry()
        a, b = words(x, W), words(y, W)
        U, V = [0] * (2 * W + 1), [0] * (2 * W)
        for i in range(W):
            odd = i & 1
            s, t = i + odd, i - odd
            U[s] = c.mad_lo_cc(a[odd], b[i], U[s])
            U[s + 1] = c.madc_hi_cc(a[odd], b[i], U[s + 1])
            for j in range(odd + 2, W, 2):
                U[i + j] = c.madc_lo_cc(a[j], b[i], U[i + j])
                U[i + j + 1] = c.madc_hi_cc(a[j], b[i], U[i + j + 1])
            U[s + W] = c.addc(U[s + W], 0)
            assert U[s + W] < 3
            V[t] = c.mad_lo_cc(a[1 - odd], b[i], V[t])
            V[t + 1] = c.madc_hi_cc(a[1 - odd], b[i], V[t + 1])
            for j in range(3 - odd, W, 2):
                V[i + j - 1] = c.madc_lo_cc(a[j], b[i], V[i + j - 1])
                V[i + j] = c.madc_hi_cc(a[j], b[i], V[i + j])
            V[t + W] = c.addc(V[t + W], 0)
            assert V[t + W] < 3
        assert U[2 * W] == 0 and V[2 * W - 1] == 0
        T = [U[0], c.add_cc(U[1], V[0])]
        T += [c.addc_cc(U[j], V[j - 1]) for j in range(2, 2 * W - 1)]
        T.append(c.addc(U[2 * W - 1], V[2 * W - 2]))
        T = value(T)
        assert T == x * y
        return T

    def mul_mma(self, x, y):
        self.lazy(x, y)
        W, R = self.W, self.R
        T = self.product(x, y)
        lo, hi = T % R, T // R
        m = lo * self.npinv % R
        # column sums of m p by output byte, folded word by word
        mb = np.frombuffer(m.to_bytes(4 * W, "little"), np.uint8).astype(np.int64)
        pb = np.frombuffer(self.p.to_bytes(4 * W, "little"), np.uint8).astype(np.int64)
        cols = np.convolve(mb, pb)
        assert cols.max() < 1 << 22
        cols = np.concatenate([cols, np.zeros(8 * W - len(cols), np.int64)])
        carry, nz, out = 0, 0, []
        for word in range(2 * W):
            v = cols[4 * word : 4 * word + 4]
            s = carry + int(v[0]) + (int(v[1]) << 8) + (int(v[2]) << 16) + (int(v[3]) << 24)
            if word < W:
                nz |= s & M32
            else:
                s += (hi >> (32 * (word - W))) & M32
                if word == W:
                    s += int(nz != 0)
                out.append(s & M32)
            carry = s >> 32
        assert carry == 0
        r = value(out)
        assert r == (T + m * self.p) // R
        self.lazy(r)
        return r

    def add_nr(self, x, y):
        assert 0 <= x < self.p and 0 <= y < self.p, "add_nr takes canonical inputs"
        return x + y

    def add(self, x, y):
        self.lazy(x, y)
        s = x + y
        assert s < self.R
        r = s - 2 * self.p if s >= 2 * self.p else s
        self.lazy(r)
        return r

    def sub(self, x, y):
        self.lazy(x, y)
        r = x - y if x >= y else x - y + 2 * self.p
        self.lazy(r)
        return r

    def canon(self, x):
        self.lazy(x)
        return x - self.p if x >= self.p else x

    def mul_small(self, k, y):
        """fp_lazy.cuh mul_small: 12 y = ((y + y) + y) 4, 9 y = 8 y + y."""
        assert k in (9, 12)
        t = self.add(y, y)
        if k == 12:
            t = self.add(t, y)
            t = self.add(t, t)
            return self.add(t, t)
        t = self.add(t, t)
        t = self.add(t, t)
        return self.add(t, y)

    def mul_b3(self, small, b3m, y, mul):
        return self.mul_small(small, y) if small else mul(b3m, y)


class Strict(Lazy):
    """The strict arithmetic (fp_lazy.cuh S = true: mont.cuh mont_mul,
    mod_add, mod_sub; K5c's reduction with its top carry kept) over
    Python ints; every operand and result canonical."""

    def __init__(self, F):
        self.p, self.W = F.p, F.L // 2
        self.R = 1 << (32 * self.W)
        assert 4 * self.p >= self.R and self.p < self.R
        self.n0 = (-pow(self.p, -1, 1 << 32)) % (1 << 32)
        self.rinv = pow(self.R, -1, self.p)
        self.npinv = (-pow(self.p, -1, self.R)) % self.R
        self.pw = words(self.p, self.W)

    def lazy(self, *xs):
        for x in xs:
            assert 0 <= x < self.p, "operand outside [0, p)"

    def mul(self, x, y):
        """mont.cuh mont_mul: CIOS with 64-bit products, W + 2 words."""
        self.lazy(x, y)
        W, p = self.W, self.pw
        a, b = words(x, W), words(y, W)
        t = [0] * (W + 2)
        for i in range(W):
            c = 0
            for j in range(W):
                s = a[j] * b[i] + t[j] + c
                t[j], c = s & M32, s >> 32
            s = t[W] + c
            t[W], t[W + 1] = s & M32, s >> 32
            m = (t[0] * self.n0) & M32
            s = m * p[0] + t[0]
            assert s & M32 == 0
            c = s >> 32
            for j in range(1, W):
                s = m * p[j] + t[j] + c
                t[j - 1], c = s & M32, s >> 32
            s = t[W] + c
            t[W - 1] = s & M32
            top = t[W + 1] + (s >> 32)
            assert top >> 32 == 0, "a carry the kernel drops is not zero"
            t[W] = top
        v = value(t[: W + 1])
        assert v < 2 * self.p
        r = v - self.p if t[W] or value(t[:W]) >= self.p else v
        assert r == x * y * self.rinv % self.p
        self.lazy(r)
        return r

    def mul_mma(self, x, y):
        """K5c's group reduction with the carry out of (T + m p) / R kept
        (k5c_sw_add_mma.cu group_reduce, csub_top)."""
        self.lazy(x, y)
        W, R = self.W, self.R
        T = self.product(x, y)
        hi = T // R
        m = (T % R) * self.npinv % R
        mb = np.frombuffer(m.to_bytes(4 * W, "little"), np.uint8).astype(np.int64)
        pb = np.frombuffer(self.p.to_bytes(4 * W, "little"), np.uint8).astype(np.int64)
        cols = np.convolve(mb, pb)
        cols = np.concatenate([cols, np.zeros(8 * W - len(cols), np.int64)])
        carry, nz, out = 0, 0, []
        for word in range(2 * W):
            v = cols[4 * word : 4 * word + 4]
            s = carry + int(v[0]) + (int(v[1]) << 8) + (int(v[2]) << 16) + (int(v[3]) << 24)
            if word < W:
                nz |= s & M32
            else:
                s += (hi >> (32 * (word - W))) & M32
                if word == W:
                    s += int(nz != 0)
                out.append(s & M32)
            carry = s >> 32
        assert carry in (0, 1)
        u = value(out) + (carry << (32 * W))
        assert u == (T + m * self.p) // R and u < 2 * self.p
        r = u - self.p if carry or value(out) >= self.p else value(out)
        self.lazy(r)
        return r

    def add(self, x, y):
        """mont.cuh mod_add: the carry out of the top word kept."""
        self.lazy(x, y)
        s = x + y
        r = s - self.p if s >= self.p else s
        self.lazy(r)
        return r

    add_nr = add  # sums of inputs reduce too (fadd_in)

    def sub(self, x, y):
        self.lazy(x, y)
        r = x - y if x >= y else x - y + self.p
        self.lazy(r)
        return r

    def canon(self, x):
        self.lazy(x)
        return x


def arithmetic(F):
    """The replay of the arithmetic ops/curve_add.py picks for F."""
    return Strict(F) if 4 * F.p >= 1 << (16 * F.L) else Lazy(F)


def k3_schedule(A, small, b3m, P, Q):
    """k3_sw_add.cu's sequence, variable for variable."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0 = A.mul(X1, X2)
    t1 = A.mul(Y1, Y2)
    a, b = A.add_nr(X1, Y1), A.add_nr(X2, Y2)
    t3 = A.sub(A.mul(a, b), A.add(t0, t1))
    c, d = A.add_nr(Y1, Z1), A.add_nr(Y2, Z2)
    t4 = A.mul(c, d)
    t2 = A.mul(Z1, Z2)
    t4 = A.sub(t4, A.add(t1, t2))
    c, d = A.add_nr(X1, Z1), A.add_nr(X2, Z2)
    y3p = A.sub(A.mul(c, d), A.add(t0, t2))
    t2 = A.mul_b3(small, b3m, t2, A.mul)
    y3b = A.mul_b3(small, b3m, y3p, A.mul)
    Z3p = A.add(t1, t2)
    t1 = A.sub(t1, t2)
    t0 = A.add(A.add(t0, t0), t0)
    X3 = A.canon(A.sub(A.mul(t3, t1), A.mul(t4, y3b)))
    Y3 = A.canon(A.add(A.mul(t1, Z3p), A.mul(y3b, t0)))
    Z3 = A.canon(A.add(A.mul(Z3p, t4), A.mul(t0, t3)))
    return X3, Y3, Z3


def k5c_schedule(A, small, b3m, P, Q):
    """k5c_sw_add_mma.cu's sequence: four groups of three multiplies."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0, t1, t2 = A.mul_mma(X1, X2), A.mul_mma(Y1, Y2), A.mul_mma(Z1, Z2)
    m3 = A.mul_mma(A.add_nr(X1, Y1), A.add_nr(X2, Y2))
    m4 = A.mul_mma(A.add_nr(Y1, Z1), A.add_nr(Y2, Z2))
    m5 = A.mul_mma(A.add_nr(X1, Z1), A.add_nr(X2, Z2))
    t3 = A.sub(m3, A.add(t0, t1))
    t4 = A.sub(m4, A.add(t1, t2))
    y3b = A.sub(m5, A.add(t0, t2))
    t2 = A.mul_b3(small, b3m, t2, A.mul_mma)
    y3b = A.mul_b3(small, b3m, y3b, A.mul_mma)
    Z3p = A.add(t1, t2)
    t1 = A.sub(t1, t2)
    t0 = A.add(A.add(t0, t0), t0)
    p1, p3, p5 = A.mul_mma(t3, t1), A.mul_mma(t1, Z3p), A.mul_mma(Z3p, t4)
    p2, p4, p6 = A.mul_mma(t4, y3b), A.mul_mma(y3b, t0), A.mul_mma(t0, t3)
    return A.canon(A.sub(p1, p2)), A.canon(A.add(p3, p4)), A.canon(A.add(p5, p6))


SCHEDULES = {"k3": k3_schedule, "k5c": k5c_schedule}


def adversarial(p, n, seed):
    """n canonical values, each 0, 1, p - 1 or p - 2 half of the time."""
    rng = np.random.default_rng(seed)
    special = [0, 1, p - 1, p - 2]
    out = []
    for _ in range(n):
        if rng.integers(0, 2):
            out.append(special[int(rng.integers(0, 4))])
        else:
            out.append(int.from_bytes(rng.bytes(p.bit_length() // 8 + 8), "little") % p)
    return out


def batch(name, n_arbitrary, seed):
    """(F, b3m, P, Q) as (n, L) raw limb planes: points of the curve in
    random projective scalings (identity on either side, P + P, P + (-P)
    among them), then arbitrary canonical triples."""
    make, C, _ = {**CURVES, **STRICT_CURVES}[name]
    F = make()
    dev = SWDevice(F, C, device="cpu")
    pts, acc = [], None
    for _ in range(5):
        acc = C.add(acc, C.generator)
        pts.append(acc)
    left = [None, pts[0], pts[1], pts[2], pts[3], pts[4]]
    right = [pts[1], None, pts[1], C.neg(pts[2]), pts[0], pts[2]]
    rng = np.random.default_rng(seed)
    cols = []
    for side in (left, right):
        E = dev.encode_points(side)
        xyz = [F.decode(E[k], mont=False) for k in "xyz"]
        lam = [int.from_bytes(rng.bytes(64), "little") % (F.p - 1) + 1 for _ in side]
        xyz = [[v * l % F.p for v, l in zip(coord, lam)] for coord in xyz]
        for k in range(3):
            xyz[k] += adversarial(F.p, n_arbitrary, seed + 7 * len(cols) + k)
        cols.append(xyz)
    P = tuple(F.encode(c, mont=False, device="cpu") for c in cols[0])
    Q = tuple(F.encode(c, mont=False, device="cpu") for c in cols[1])
    return F, dev._b3m, P, Q


@pytest.mark.parametrize("name", list(CURVES))
def test_multiplies_stay_below_2p(name):
    """Both kernels' multiplies on lazy operands up to 2p - 1."""
    F = CURVES[name][0]()
    A = Lazy(F)
    p = F.p
    edge = [0, 1, p - 2, p - 1, p, p + 1, 2 * p - 2, 2 * p - 1]
    vals = edge + [v % (2 * p) for v in adversarial(2 * p, 24, 3)]
    for x in vals:
        for y in vals[::3]:
            assert A.mul(x, y) % p == A.mul_mma(x, y) % p


@pytest.mark.parametrize("name", list(CURVES))
@pytest.mark.parametrize("small", [9, 12])
def test_small_chain_equals_mont_product(name, small):
    """The chain for 3b is the Montgomery product with 3b R mod p."""
    F = CURVES[name][0]()
    A = Lazy(F)
    b3m = small * F.R % F.p
    ys = adversarial(F.p, 40, small)
    want = mont.mont_rows(
        F,
        mont.to_cols(F.encode([b3m] * len(ys), mont=False, device="cpu")),
        mont.to_cols(F.encode(ys, mont=False, device="cpu")),
    )
    want = F.decode(mont.from_cols(want), mont=False)
    assert [A.canon(A.mul_small(small, y)) for y in ys] == want
    # lazy inputs in [p, 2p) give the same residue
    assert [A.canon(A.mul_small(small, y + F.p)) for y in ys if y + F.p < 2 * F.p] == want


@pytest.mark.parametrize("kernel", list(SCHEDULES))
@pytest.mark.parametrize("name", list(CURVES) + list(STRICT_CURVES))
def test_schedule_equals_twin(name, kernel):
    """The kernels' schedules, with their small-constant chain and with the
    general multiply by 3b R, equal rcb_add_plain; in the lazy arithmetic
    for BLS12-381 and BN254, in the strict one for Vesta, Pallas and
    secp256k1."""
    F, b3m, P, Q = batch(name, 20, 11)
    small = {**CURVES, **STRICT_CURVES}[name][2]
    assert curve_add.kernel_b3(F, b3m)[1] == small
    want = [F.decode(t, mont=False) for t in curve_add.rcb_add_plain(F, b3m, P, Q)]
    Pi = list(zip(*(F.decode(t, mont=False) for t in P)))
    Qi = list(zip(*(F.decode(t, mont=False) for t in Q)))
    A = arithmetic(F)
    assert isinstance(A, Strict) == (name in STRICT_CURVES)
    for chain in sorted({small, 0}):
        got = [SCHEDULES[kernel](A, chain, b3m, pp, qq) for pp, qq in zip(Pi, Qi)]
        assert [list(c) for c in zip(*got)] == want


@pytest.mark.parametrize("name", list(STRICT_CURVES))
def test_strict_multiplies_stay_canonical(name):
    """Both kernels' strict multiplies on canonical operands, the edges
    0, 1, p - 2, p - 1 among them (secp256k1: 2p >= R, so the CIOS top
    word and K5c's top carry are taken)."""
    F = STRICT_CURVES[name][0]()
    A = Strict(F)
    p = F.p
    vals = [0, 1, 2, p - 2, p - 1] + adversarial(p, 24, 5)
    for x in vals:
        for y in vals[::3]:
            assert A.mul(x, y) == A.mul_mma(x, y)


def test_kernel_b3_refuses_a_field_without_headroom():
    """The kernels' arithmetic follows from p alone: lazy where 4p < R
    (BLS12-381 and BN254 Fq, with their 3b chains), strict for a field
    without that headroom (Vesta, Pallas, secp256k1), which the kernels
    once refused and now add on with the general multiply by 3b."""
    for name, (make, C, small) in {**CURVES, **STRICT_CURVES}.items():
        F = make()
        b3m = 3 * C.b % F.p * F.R % F.p
        _, got_small, strict = curve_add.kernel_b3(F, b3m)
        assert strict == (name in STRICT_CURVES) == (4 * F.p >= F.R), name
        assert got_small == small, name
