"""EccChip: halo2_gadgets-style fixed-base scalar multiplication.

Port of `contangle_zkcp_tpu/plonkish/ecc_chip.py` (host code, copied as
is), with its own copy of the generator's window tables,
`ecc_tables_pallas.json`, read from and written to this package's
directory only.

Mirror of the reference's `TestFixedBases` + EccChip usage
(circuits-halo2/src/constants.rs:12-136 — window tables
via `find_zs_and_us` over the Pallas generator; encryption.rs:83-161) —
the piece the reference *configures* but then sidesteps by witnessing
precomputed points.  This chip actually constrains k*G:

  * the scalar decomposes into W windows of 3 bits through a running sum
    z_{i+1} = (z_i - k_i) / 8, with z_W == 0 and each k_i range-checked
    into [0, 8) by a lookup (halo2's LookupRangeCheckConfig role);
  * window i selects P_i = (k_i + 2) * 8^i * G from an 8-entry table,
    constrained WITHOUT lookups exactly as halo2 does: the table x-coords
    interpolate a degree-7 Lagrange polynomial in k_i (fixed
    coefficients), and the y-coord is pinned by a witnessed square root
    u with u^2 = y + z_i, where z_i is a per-window constant chosen so
    y_d + z_i is a square for ALL eight table entries while p - y_d + z_i
    is a square for NONE (the find_zs_and_us search);
  * the last window's table absorbs the +2 offsets so the selected
    points sum to exactly k*G;
  * the W selected points fold with incomplete-addition rows
    ((x_q-x_p) lambda = y_q-y_p; x_r = lambda^2-x_p-x_q;
     y_r = lambda (x_p-x_r) - y_p).

Curve: Pallas (base field = PASTA_P); scalars are full-width field
elements of the Pallas scalar field embedded via their integer value
(max 255 windows... W = 85 covers 255 bits).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import instances as ci
from ..curves.host import sqrt_mod
from ..fields import instances as fi
from .circuit import Assignment, CircuitMeta, Expr

P = fi.PASTA_P  # Pallas base field (circuit field)
ORDER = fi.PASTA_Q  # Pallas scalar field
CURVE = ci.PALLAS
WINDOW = 3
NUM_WINDOWS = 85  # ceil(255 / 3)


def _lagrange_coeffs(xs, ys, p):
    """Coefficients of the degree-(n-1) polynomial through (xs, ys)."""
    n = len(xs)
    coeffs = [0] * n
    for i in range(n):
        # basis poly prod_{j!=i} (X - xs[j]) / (xs[i] - xs[j])
        basis = [1]
        denom = 1
        for j in range(n):
            if j == i:
                continue
            new = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                new[d] = (new[d] - c * xs[j]) % p
                new[d + 1] = (new[d + 1] + c) % p
            basis = new
            denom = denom * (xs[i] - xs[j]) % p
        scale = ys[i] * pow(denom, -1, p) % p
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + scale * c) % p
    return coeffs


def find_zs_and_us(points, p):
    """The reference's find_zs_and_us: z with y_d + z square for all d and
    (p - y_d) + z square for none; returns (z, [u_d = sqrt(y_d + z)]).

    The ~2^16-expected search tests candidates with the Jacobi symbol
    (subquadratic reciprocity, no exponentiation) and only computes
    actual square roots (full Tonelli for p = 1 mod 4) for the single
    surviving z."""
    z = 0
    while True:
        z += 1
        ok = True
        for _, y in points:
            if (
                _jacobi((y + z) % p, p) != 1
                or _jacobi((p - y + z) % p, p) == 1
            ):
                ok = False
                break
        if ok:
            us = [min(u, p - u) for u in (sqrt_mod((y + z) % p, p) for _, y in points)]
            return z, us


def _jacobi(a, n):
    """Jacobi symbol (a/n) for odd n via quadratic reciprocity."""
    a %= n
    result = 1
    while a:
        while a % 2 == 0:
            a //= 2
            if n % 8 in (3, 5):
                result = -result
        a, n = n, a
        if a % 4 == 3 and n % 4 == 3:
            result = -result
        a %= n
    return result if n == 1 else 0


@dataclass
class FixedBaseTables:
    base: tuple
    window_points: list  # [W][8] affine points
    x_coeffs: list  # [W][8] Lagrange coefficients of x in k
    zs: list  # [W]
    us: list  # [W][8]


def build_tables(base=None, cache: bool = True) -> FixedBaseTables:
    """Window tables for `base` (default: the Pallas generator).

    The z/u search (find_zs_and_us) costs minutes for 85 windows, so the
    generator's tables are cached next to this module as JSON."""
    import json
    import os

    C = CURVE
    base = base or C.generator
    cache_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "ecc_tables_pallas.json"
    )
    if cache and base == C.generator and os.path.exists(cache_path):
        with open(cache_path) as fh:
            d = json.load(fh)
        return FixedBaseTables(
            base=tuple(int(v) for v in d["base"]),
            window_points=[
                [tuple(int(v) for v in pt) for pt in row]
                for row in d["window_points"]
            ],
            x_coeffs=[[int(v) for v in row] for row in d["x_coeffs"]],
            zs=[int(v) for v in d["zs"]],
            us=[[int(v) for v in row] for row in d["us"]],
        )
    tables = _build_tables_uncached(base)
    if cache and base == C.generator:
        with open(cache_path, "w") as fh:
            json.dump(
                {
                    "base": [str(v) for v in tables.base],
                    "window_points": [
                        [[str(v) for v in pt] for pt in row]
                        for row in tables.window_points
                    ],
                    "x_coeffs": [
                        [str(v) for v in row] for row in tables.x_coeffs
                    ],
                    "zs": [str(v) for v in tables.zs],
                    "us": [[str(v) for v in row] for row in tables.us],
                },
                fh,
            )
    return tables


def _build_tables_uncached(base) -> FixedBaseTables:
    C = CURVE
    offset = sum(2 * 8**w for w in range(NUM_WINDOWS - 1))
    window_points = []
    for w in range(NUM_WINDOWS):
        row = []
        for d in range(8):
            if w < NUM_WINDOWS - 1:
                k = (d + 2) * 8**w
            else:
                k = (d * 8**w - offset) % ORDER
            row.append(C.mul(k % ORDER, base))
        window_points.append(row)
    x_coeffs = [
        _lagrange_coeffs(list(range(8)), [pt[0] for pt in row], P)
        for row in window_points
    ]
    zs, us = [], []
    for row in window_points:
        z, u = find_zs_and_us(row, P)
        zs.append(z)
        us.append(u)
    return FixedBaseTables(base, window_points, x_coeffs, zs, us)


class EccChip:
    """Fixed-base mul + incomplete add region over our PLONKish system."""

    def __init__(self, meta: CircuitMeta, tables: FixedBaseTables):
        self.tables = tables
        self.k_col = meta.advice_column()  # window digit k_i
        self.z_col = meta.advice_column()  # running sum z_i (same row)
        self.x_col = meta.advice_column()  # selected point x
        self.y_col = meta.advice_column()  # selected point y
        self.u_col = meta.advice_column()  # sqrt witness
        self.acc_x = meta.advice_column()
        self.acc_y = meta.advice_column()
        self.lam = meta.advice_column()
        self.q_win = meta.selector()  # window-selection gate
        self.q_add = meta.selector()  # incomplete-add gate
        self.win_idx = meta.fixed_column()  # per-row window constants...
        # per-window fixed columns: 8 Lagrange coefficients + z
        self.coeff_cols = [meta.fixed_column() for _ in range(8)]
        self.z_fixed = meta.fixed_column()
        self.range_table = meta.fixed_column()

        k = Expr.col(self.k_col)
        zc = Expr.col(self.z_col)
        zn = Expr.col(self.z_col.at(1))
        x = Expr.col(self.x_col)
        y = Expr.col(self.y_col)
        u = Expr.col(self.u_col)
        qw = Expr.col(self.q_win)
        # x = sum_j c_j k^j  (degree 8 with the selector)
        interp = Expr.const(0)
        kp = Expr.const(1)
        for j in range(8):
            interp = interp + Expr.col(self.coeff_cols[j]) * kp
            kp = kp * k
        meta.create_gate(
            "fixed_base_window",
            [
                qw * (x - interp),
                # u^2 = y + z  pins |y|; the sign is pinned by z's
                # construction (p - y + z is never square)
                qw * (u * u - (y + Expr.col(self.z_fixed))),
                # y^2 = x^3 + b (the point is on the curve, fixing y up
                # to sign which the u-gate then resolves)
                qw * (y * y - (x * x * x + Expr.const(CURVE.b))),
                # running sum: k_i = z_i - 8 z_{i+1}
                qw * (k - (zc - Expr.const(8) * zn)),
            ],
        )
        qa = Expr.col(self.q_add)
        ax, ay = Expr.col(self.acc_x), Expr.col(self.acc_y)
        axn, ayn = Expr.col(self.acc_x.at(1)), Expr.col(self.acc_y.at(1))
        lam = Expr.col(self.lam)
        meta.create_gate(
            "incomplete_add",
            [
                qa * (lam * (x - ax) - (y - ay)),
                qa * (axn - (lam * lam - ax - x)),
                qa * (ayn - (lam * (ax - axn) - ay)),
            ],
        )
        # terminal running-sum row must be zero (otherwise the decomposed
        # scalar would be shifted by 8^W * z_W)
        self.q_last = meta.selector()
        meta.create_gate("z_final", [Expr.col(self.q_last) * zc])
        meta.lookup(
            "window_range8", [(k * qw, Expr.col(self.range_table) * qw)]
        )

    def assign_mul(self, asg: Assignment, scalar: int, row0: int = 0):
        """Lay out k*G over NUM_WINDOWS+1 rows starting at row0; returns
        (row_result, expected point)."""
        C = CURVE
        t = self.tables
        scalar %= ORDER
        ks = [(scalar >> (3 * w)) & 7 for w in range(NUM_WINDOWS)]
        # running sums: z_i = sum_{j>=i} k_j 8^{j-i}; z_0 = scalar
        zs = [0] * (NUM_WINDOWS + 1)
        for i in range(NUM_WINDOWS - 1, -1, -1):
            zs[i] = zs[i + 1] * 8 + ks[i]
        assert zs[0] == scalar
        # range table rows 0..7 (shared; assign every call, idempotent)
        for d in range(8):
            asg.assign(self.range_table, d, d)
        acc = None
        for i in range(NUM_WINDOWS):
            row = row0 + i
            asg.enable(self.q_win, row)
            asg.assign(self.k_col, row, ks[i])
            asg.assign(self.z_col, row, zs[i])
            pt = t.window_points[i][ks[i]]
            asg.assign(self.x_col, row, pt[0])
            asg.assign(self.y_col, row, pt[1])
            asg.assign(self.u_col, row, t.us[i][ks[i]])
            for j in range(8):
                asg.assign(self.coeff_cols[j], row, t.x_coeffs[i][j])
            asg.assign(self.z_fixed, row, t.zs[i])
            if i == 0:
                # the accumulator ENTERING row 1 is row 0's selected point
                asg.assign(self.acc_x, row + 1, pt[0])
                asg.assign(self.acc_y, row + 1, pt[1])
                asg.copy(self.acc_x, row + 1, self.x_col, row)
                asg.copy(self.acc_y, row + 1, self.y_col, row)
                acc = pt
            else:
                # add row: acc(row) + selected(row) -> acc(row+1)
                prev = acc
                acc = C.add(acc, pt)
                lam = (pt[1] - prev[1]) * pow(pt[0] - prev[0], -1, P) % P
                asg.enable(self.q_add, row)
                asg.assign(self.lam, row, lam)
                asg.assign(self.acc_x, row + 1, acc[0])
                asg.assign(self.acc_y, row + 1, acc[1])
        asg.assign(self.z_col, row0 + NUM_WINDOWS, 0)
        asg.enable(self.q_last, row0 + NUM_WINDOWS)
        return row0 + NUM_WINDOWS, acc

    def layout_rows(self) -> int:
        return NUM_WINDOWS + 1
