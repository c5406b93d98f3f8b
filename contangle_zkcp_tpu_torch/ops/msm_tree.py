"""Batch-affine tree-reduction MSM on the card.

Port of `contangle_zkcp_tpu/ops/msm_tree.py`, the engine the policy's
name "tree" selects.  The buckets fill without a lockstep loop:

  * the input points go to affine coordinates with ONE batched inversion
    of z (zero-preserving: identity inputs become invalid slots);
  * every bucket's points reduce through a balanced pairwise tree in
    affine coordinates: bucket segments are padded to a power of two and
    laid out in descending size order, so every level pairs adjacent
    slots of a prefix of the previous level — after the single level-0
    gather there are no index arrays until the harvest, and a skewed
    bucket costs log depth, not a peel pass;
  * each level is one batched step over all buckets of all windows, with
    ONE batched inversion (fields/fp.py batch_inv, or Fq2Device's) for
    all its slopes;
  * finished buckets are harvested into the projective (K, nb) grid, which
    GridMSM (ops/msm_grid.py) reduces, alias fold included, before a host
    Horner combine.

Completeness is by case flags: each slot carries a validity flag, and a
pair adds, doubles (equal points), cancels (P + -P -> invalid) or passes
one side through (the other invalid), so duplicated points, zero scalars,
identity inputs and cancellations are all exact.

Left out, because they bound XLA compile shapes and have no counterpart on
the card: `TILE` (fixed-size tiles), `_menu_round` (level widths rounded to
a menu of shapes) and the tail-program menu, the packing of x, y and the
flag into 64-lane rows, and chunking by `MAX_GATHER_BYTES`.  Each level
here computes only its real pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import metrics
from .msm import _sync
from .msm_grid import GridMSM


def _next_pow2(x: np.ndarray) -> np.ndarray:
    """Elementwise next power of two (0 -> 0, exact powers unchanged)."""
    x = np.asarray(x, dtype=np.int64)
    out = np.zeros_like(x)
    nz = x > 0
    # values are < 2^31; float64 frexp is exact there
    m, e = np.frexp(x[nz].astype(np.float64))
    out[nz] = np.where(m == 0.5, x[nz], np.left_shift(1, e))
    return out


class TreeMSM(GridMSM):
    """Pippenger engine with batch-affine tree bucket accumulation.

    The host schedules are `MSM`'s, the window reduction and the Horner
    combine `GridMSM`'s.  `A0_BUDGET_BYTES` caps the level-0 slot array
    (about 2 K N slots of an affine x, y and a flag) and so the point
    chunk.
    """

    # An 80 GB card: a level's temporaries (differences, slopes, the
    # batch inversion's product tree, the new coordinates) come to about
    # ten times the slot array, so 4 GiB keeps a level near 40 GiB.
    # G1 c = 16 takes 2^19 points a chunk (6,176 bytes a point), G2
    # c = 12 2^17 (17,072 bytes); grids of several chunks add up.
    A0_BUDGET_BYTES = 1 << 32

    def __init__(self, dev, scalar_bits: int, c: int = 16, signed: bool = True):
        super().__init__(dev, scalar_bits, c=c, signed=signed)
        o = dev.ops
        fq2 = hasattr(o, "F")
        L = o.F.L if fq2 else o.L
        self._cw = 2 * L if fq2 else L  # int32 limbs per coordinate
        self._coord_shape = (2, L) if fq2 else (L,)

    # ------------------------------------------------------- device steps
    def _pack_affine(self, points):
        """Projective batch -> (x, y, valid) affine slots: one batched
        inversion of z; z == 0 (identity) rows become invalid."""
        o = self.dev.ops
        zinv = o.batch_inv(points["z"])  # zero-preserving
        xy = o.mul(torch.stack([points["x"], points["y"]]), zinv)
        return xy[0], xy[1], ~o.is_zero(points["z"])

    def _gather0(self, aff, idx0, v0, sgn0):
        """Level-0 slot array: gather the affine points into tree layout,
        negate y where the slot's digit is negative, mask slot validity."""
        o = self.dev.ops
        x, y, v = (t.index_select(0, idx0) for t in aff)
        if sgn0 is not None:
            y = o.select(sgn0, o.neg(y), y)
        return x, y, v & v0

    def _pair_core(self, a, b):
        """Complete affine pairwise add of slot batches a, b = (x, y, valid):
        add / double / cancellation / pass-through by case flags, ONE
        batched inversion for the whole batch."""
        (ax, ay, av), (bx, by, bv) = a, b
        o = self.dev.ops
        both = av & bv
        dx = o.sub(bx, ax)
        dy = o.sub(by, ay)
        zx = o.is_zero(dx)
        zy = o.is_zero(dy)
        dbl = both & zx & zy
        cancel = both & zx & ~zy
        sq = o.square(ax)
        num = o.select(dbl, o.add(o.add(sq, sq), sq), dy)  # 3x^2 | dy
        den = o.select(dbl, o.add(ay, ay), dx)  # 2y | dx
        active = both & ~cancel
        den = o.select(active, den, o.one_mont(av.shape, device=av.device))
        lam = o.mul(num, o.batch_inv(den))
        x3 = o.sub(o.sub(o.square(lam), ax), bx)
        y3 = o.sub(o.mul(lam, o.sub(ax, x3)), ay)
        ox = o.select(active, x3, o.select(av, ax, bx))
        oy = o.select(active, y3, o.select(av, ay, by))
        return ox, oy, active | (av ^ bv)

    # ------------------------------------------------------ host schedule
    def _tree_layout(self, start, cnt, order, sgn=None):
        """The flat descending-pow2 segment layout and its harvest maps.

        Returns (idx0, v0, sgn0, level_pairs [real-pair count per level],
        harvest {level: (slots, dests)}, P0 slots)."""
        K, nb = self.K, self.nb
        cnt = np.asarray(cnt, dtype=np.int64)
        start = np.asarray(start, dtype=np.int64)
        seg_cnt = cnt.reshape(-1)  # (S,) window-major
        seg_start = start.reshape(-1)
        seg_k = np.repeat(np.arange(K, dtype=np.int64), nb)
        M = _next_pow2(seg_cnt)
        orderseg = np.argsort(-M, kind="stable")
        Ms = M[orderseg]
        cnts = seg_cnt[orderseg]
        starts = seg_start[orderseg]
        ks = seg_k[orderseg]
        off = np.concatenate(([0], np.cumsum(Ms)[:-1]))
        P0 = int(Ms.sum())

        tot = int(cnts.sum())
        idx0 = np.zeros(P0, dtype=np.int32)
        v0 = np.zeros(P0, dtype=bool)
        sgn0 = np.zeros(P0, dtype=np.int8)
        if tot:
            local = np.arange(tot, dtype=np.int64) - np.repeat(np.concatenate(([0], np.cumsum(cnts)[:-1])), cnts)
            slots = np.repeat(off, cnts) + local
            sched = np.repeat(starts, cnts) + local
            kk = np.repeat(ks, cnts)
            idx0[slots] = np.asarray(order)[kk, sched]
            v0[slots] = True
            if sgn is not None:
                sgn0[slots] = np.asarray(sgn)[kk, sched]

        # levels: level l pairs the slots of segments with M >= 2^(l+1)
        level_pairs = []
        maxM = int(Ms[0]) if len(Ms) else 0
        depth = maxM.bit_length() - 1 if maxM > 1 else 0
        for lvl in range(depth):
            alive = Ms >= (1 << (lvl + 1))
            level_pairs.append(int((Ms[alive] >> lvl).sum()) // 2)

        # harvest: a non-empty segment finishes at level log2(M), slot
        # off >> level (sorted by slot within a level)
        harvest = {}
        nzi = np.nonzero(cnts > 0)[0]
        fin_lvl = np.zeros(len(Ms), dtype=np.int64)
        fin_lvl[nzi] = np.array([int(Ms[i]).bit_length() - 1 for i in nzi], dtype=np.int64)
        dest = ks * nb + (orderseg % nb)  # (K, nb) position of each segment
        for lvl in range(depth + 1):
            sel = nzi[fin_lvl[nzi] == lvl]
            if len(sel):
                slots = (off[sel] >> lvl).astype(np.int64)
                dd = dest[sel].astype(np.int64)
                so = np.argsort(slots, kind="stable")
                harvest[lvl] = (slots[so].astype(np.int32), dd[so].astype(np.int32))
        return idx0, v0, sgn0, level_pairs, harvest, P0

    # --------------------------------------------------------------- run
    def _chunk_rows(self) -> int:
        """Largest power-of-two chunk whose level-0 slot array (about 2 N
        slots a window, K windows) stays under A0_BUDGET_BYTES."""
        per_point = 2 * self.K * (2 * self._cw * 4 + 1)
        limit = max(1, self.A0_BUDGET_BYTES // per_point)
        return 1 << (limit.bit_length() - 1)

    def _bucket_grid_chunk(self, points, order, start, cnt, sgn=None):
        """One chunk's (K, nb) projective bucket grid."""
        o, K, nb = self.dev.ops, self.K, self.nb
        device = points["x"].device
        idx0, v0, sgn0, level_pairs, harvest, _ = self._tree_layout(start, cnt, order, sgn)
        metrics.gauge("msm.tree_levels", len(level_pairs))

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        A = self._gather0(self._pack_affine(points), put(idx0), put(v0),
                          put(sgn0 != 0) if sgn is not None else None)
        rows, dests = [], []
        for lvl in range(len(level_pairs) + 1):
            if lvl in harvest:
                slots, dd = harvest[lvl]
                rows.append(tuple(t.index_select(0, put(slots.astype(np.int64))) for t in A))
                dests.append(dd)
            if lvl < len(level_pairs):
                h = level_pairs[lvl]
                A = self._pair_core(*(tuple(t[: 2 * h].reshape((h, 2) + t.shape[1:]).select(1, i) for t in A)
                                      for i in (0, 1)))
        # every bucket a row: the harvested rows, then one invalid row that
        # the empty buckets point at
        perm = np.full(K * nb, sum(len(d) for d in dests), dtype=np.int64)
        if dests:
            dd = np.concatenate(dests)
            perm[dd] = np.arange(len(dd))
        sentinel = (o.zeros((1,), device=device), o.zeros((1,), device=device),
                    torch.zeros(1, dtype=torch.bool, device=device))
        x, y, v = (torch.cat([r[i] for r in rows] + [sentinel[i]]).index_select(0, put(perm))
                   for i in range(3))
        one = o.one_mont(v.shape, device=device)
        zero = o.zeros(v.shape, device=device)
        P = {"x": o.select(v, x, zero), "y": o.select(v, y, one), "z": o.select(v, one, zero)}
        return {k: p.reshape((K, nb) + self._coord_shape) for k, p in P.items()}

    def run(self, points, scalars):
        """points: device batch (leading N) or list of affine tuples;
        scalars: (N, L) canonical limbs (tensor or array) or host ints.
        Returns the MSM as a host affine point (None for the identity)."""
        dev = self.dev
        points, limbs = self._inputs(points, scalars)
        n = limbs.shape[0]
        if n == 0:
            return None
        chunk = self._chunk_rows()
        grid = None
        for lo in range(0, n, chunk):
            pc = {k: v[lo : lo + chunk] for k, v in points.items()}
            sc = limbs[lo : lo + chunk]
            with metrics.timer("msm.host_schedule"):
                if self.signed:
                    order, start, cnt, sgn = self.host_schedule_signed(sc)
                else:
                    order, start, cnt = self.host_schedule(sc)
                    sgn = None
            metrics.count("msm.points", sc.shape[0])
            with metrics.timer("msm.bucket_phase"):
                g = self._bucket_grid_chunk(pc, order, start, cnt, sgn)
                grid = g if grid is None else dev.add(grid, g)
                _sync(grid["x"])
        with metrics.timer("msm.reduce_windows"):
            wpts = dev.decode_points(self._staged_windows(grid))
        with metrics.timer("msm.host_combine"):
            return self._combine_host(wpts)
