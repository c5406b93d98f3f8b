"""Balanced-lane Pippenger MSM: skew-proof bucket accumulation on the card.

Port of `contangle_zkcp_tpu/ops/msm_balanced.py`, the engine the policy
(ops/msm_policy.py) names for every MSM of n >= 2^16.  Real Groth16
witness vectors are dominated by 0/1 bits and small bytes, so a handful of
buckets hold about half of all points; a loop whose trip count is the
largest bucket's occupancy would run that many trips.  This engine makes
the trip count independent of skew:

  * the (K, nb) bucket grid keeps ONE lane per bucket, processing at
    most T points of that bucket's sorted run;
  * buckets with more than T points get extra lanes from an overflow pool
    of E lanes, buddy-allocated in power-of-two aligned segments, each
    lane processing at most T points;
  * ONE lockstep loop of T trips covers grid and overflow lanes together:
    each trip gathers every lane's next point (negated where its signed
    digit is negative) and runs one batched, masked group add over all
    P = K*nb + E lanes (kernel K3 for G1, or K5c under ZKCP_MXU=1; G2
    through Fq2Device's multiplies, K1 or K5a);
  * overflow segments fold to their head lane with log2(largest segment)
    masked partner adds, and the heads merge into the grid with one
    gather + add;
  * the grid's window reduction (ops/msm_grid.py) has no alias lanes to
    fold (lanes map 1:1 to digit values; the overflow pool subsumes the
    top window's aliasing); the K window sums are decoded once and
    combined by Horner on the host.

The host schedule (`schedule`, `_digits_all`) is the reference's, dict key
for key.  Left out, because they answer TPU-toolchain limits the card does
not have: `_pad_floor` and `pad_pow2` (padding to reuse compiled
programs), the 128-lane packed gather rows, chunking by
`MAX_GATHER_BYTES`, the `MAX_FUSED_REDUCE_LEVELS` staging of the
reduction, and the axis-1 reshape around an axis-2 miscompile.  The
reference's combine on the device gives way to the host's (ops/msm_grid.py
says why).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.bigint import LIMB_BITS
from ..utils import metrics
from . import msm_sched_native
from .msm import _sync
from .msm_grid import GridMSM


class BalancedMSM(GridMSM):
    """Skew-balanced Pippenger engine (large MSMs; policy-selected).

    Shares the window geometry with `MSM` and the grid's window reduction
    and combine with `GridMSM`; its own are the scheduling and the bucket
    accumulation.
    """

    # overflow lane pool.  Demand is ~active_points / T; the scheduler
    # picks the smallest T whose demand fits, so E only bounds how small T
    # can get.  2^16 G1 lanes are 18.9 MB of projective points.
    OVERFLOW_LANES = 1 << 16

    def __init__(self, dev, scalar_bits: int, c: int = 16, signed: bool = True,
                 overflow_lanes: int | None = None):
        super().__init__(dev, scalar_bits, c, signed=signed)
        # overflow subsumes top-window aliasing: lanes map 1:1 to digit
        # values, empty high lanes of the top window just stay identity.
        self.window_m = [self.nb] * self.K
        self.E = overflow_lanes or self.OVERFLOW_LANES
        self.LMAX = self.E.bit_length() - 1

    # ---------------------------------------------------------- scheduling
    def _digits_all(self, arr: np.ndarray):
        """(N, L) canonical limbs -> per-window bucket lane + sign.

        Returns (lane, sign): lane[k] in [0, nb) or nb (= dead: digit 0)
        and sign[k] (bool, signed mode only; False otherwise).
        """
        K, c, nb = self.K, self.c, self.nb
        N = arr.shape[0]
        padded = np.concatenate([arr.astype(np.int64), np.zeros((N, 2), dtype=np.int64)], axis=1)
        lane = np.empty((K, N), dtype=np.int64)
        sign = np.zeros((K, N), dtype=bool)
        if self.signed:
            half = 1 << (c - 1)
            carry = np.zeros(N, dtype=np.int64)
            for k in range(K):
                bit = k * c
                li, off = bit // LIMB_BITS, bit % LIMB_BITS
                d = padded[:, li] >> off
                if off:
                    d |= padded[:, li + 1] << (LIMB_BITS - off)
                d = (d & ((1 << c) - 1)) + carry
                if k < K - 1:
                    hi = d >= half
                    d = np.where(hi, d - (1 << c), d)
                    carry = hi.astype(np.int64)
                sign[k] = d < 0
                mag = np.abs(d)
                lane[k] = np.where(mag > 0, mag - 1, nb)
        else:
            for k in range(K):
                bit = k * c
                li, off = bit // LIMB_BITS, bit % LIMB_BITS
                d = padded[:, li] >> off
                if off:
                    d |= padded[:, li + 1] << (LIMB_BITS - off)
                d = d & (nb - 1)
                # unsigned: digit d lands on lane d (weight = lane index);
                # digit 0 is dead (weight 0)
                lane[k] = np.where(d > 0, d, nb)
        return lane, sign

    def schedule(self, scalars_limbs):
        """Host schedule -> dict of numpy arrays.

        For P = K*nb + E lanes:
          base  (P,) int32 : lane's start offset into the flat sorted
                             order array (k*N + position)
          lcnt  (P,) int32 : points this lane processes
          order (K*N,) int32 : per-window stable sort of point indices
          sgn   (K*N,) int8  : negate flag aligned with order
          fold_idx (LMAX, E) int32, fold_mask (LMAX, E) bool
          merge_idx (K*nb,) int32, merge_mask (K*nb,) bool
          nlev int : fold levels in use
          trips int : lockstep trip count (= T)
        """
        arr = np.asarray(scalars_limbs)
        K, c, nb, E = self.K, self.c, self.nb, self.E
        N = arr.shape[0]

        nat = msm_sched_native.schedule(arr, K, c, self.signed)
        if nat is not None:
            order, sgn, counts = nat
            starts = np.zeros((K, nb), dtype=np.int64)
            starts[:, 1:] = np.cumsum(counts, axis=1)[:, :-1]
        else:
            lane, sign = self._digits_all(arr)
            order = np.empty((K, N), dtype=np.int32)
            sgn = np.zeros((K, N), dtype=np.int8)
            counts = np.zeros((K, nb), dtype=np.int64)
            starts = np.zeros((K, nb), dtype=np.int64)
            for k in range(K):
                o = np.argsort(lane[k], kind="stable").astype(np.int32)
                if self.signed:
                    sgn[k] = sign[k][o]
                order[k] = o
                cc = np.bincount(np.minimum(lane[k], nb), minlength=nb + 1)[:nb]
                counts[k] = cc
                starts[k] = np.concatenate(([0], np.cumsum(cc)[:-1]))

        active = counts.sum()
        # ---- pick T: smallest trip count whose overflow demand fits E.
        # demand(T) = sum over buckets of next_pow2(ceil(cnt/T) - 1)
        flat_cnt = counts.reshape(-1)
        nz = flat_cnt[flat_cnt > 0]

        def demand(T):
            extra = -(-nz // T) - 1  # lanes beyond the grid lane
            extra = extra[extra > 0]
            if not len(extra):
                return 0
            # round up to power of two for aligned buddy placement
            p2 = 1 << np.ceil(np.log2(extra)).astype(np.int64)
            return int(p2.sum())

        max_cnt = int(nz.max()) if len(nz) else 1
        lo, hi = max(1, int(-(-active // (K * nb + E)))), max_cnt
        while lo < hi:
            mid = (lo + hi) // 2
            if demand(mid) <= E:
                hi = mid
            else:
                lo = mid + 1
        T = max(1, lo)

        # ---- lane assignment
        P = K * nb + E
        base = np.zeros(P, dtype=np.int64)
        lcnt = np.zeros(P, dtype=np.int64)
        # grid lanes: first min(cnt, T) points of each bucket
        flat_start = (starts + (np.arange(K) * N)[:, None]).reshape(-1)
        base[: K * nb] = flat_start
        lcnt[: K * nb] = np.minimum(flat_cnt, T)

        # overflow segments: buckets with cnt > T, largest first
        seg_size = np.zeros(E, dtype=np.int64)  # pow2 segment size per lane
        merge_idx = np.zeros(K * nb, dtype=np.int32)
        merge_mask = np.zeros(K * nb, dtype=bool)
        ovf = np.nonzero(flat_cnt > T)[0]
        if len(ovf):
            extra = -(-flat_cnt[ovf] // T) - 1
            p2 = 1 << np.ceil(np.log2(extra)).astype(np.int64)
            ordr = np.argsort(-p2, kind="stable")
            pos = 0
            for j in ordr:
                b, L = int(ovf[j]), int(p2[j])
                assert pos % L == 0 and pos + L <= E, "overflow pool overflow"
                rem = int(flat_cnt[b]) - T  # points beyond the grid lane
                nlanes = int(extra[j])
                per = -(-rem // nlanes)
                off = int(flat_start[b]) + T
                for i in range(nlanes):
                    take = min(per, rem)
                    base[K * nb + pos + i] = off
                    lcnt[K * nb + pos + i] = take
                    off += take
                    rem -= take
                seg_size[pos : pos + L] = L
                merge_idx[b] = pos
                merge_mask[b] = True
                pos += L

        # ---- fold planes: level j partners lane i with i + 2^j when the
        # segment is larger than 2^j and bit j of the in-segment offset
        # is clear (aligned pow2 segments make the partner in-segment).
        i_arr = np.arange(E, dtype=np.int64)
        fold_idx = np.empty((self.LMAX, E), dtype=np.int32)
        fold_mask = np.zeros((self.LMAX, E), dtype=bool)
        nlev = int(np.max(seg_size)).bit_length() - 1 if len(ovf) else 0
        for j in range(self.LMAX):
            m = (seg_size > (1 << j)) & (((i_arr >> j) & 1) == 0)
            fold_idx[j] = np.where(m, i_arr + (1 << j), i_arr).astype(np.int32)
            fold_mask[j] = m

        trips = int(max(lcnt.max(), 1))
        metrics.gauge("msm.balanced_trips", trips)
        # lanes of the pool in use (the reference sums each lane's segment
        # size, i.e. the squares of the segment sizes)
        metrics.gauge("msm.balanced_overflow_lanes", float(np.count_nonzero(seg_size)))
        metrics.gauge("msm.balanced_fold_levels", nlev)
        return {
            "base": base.astype(np.int32),
            "lcnt": lcnt.astype(np.int32),
            "order": order.reshape(-1),
            "sgn": sgn.reshape(-1),
            "fold_idx": fold_idx,
            "fold_mask": fold_mask,
            "merge_idx": merge_idx,
            "merge_mask": merge_mask,
            "nlev": nlev,
            "trips": trips,
        }

    # -------------------------------------------------------------- device
    def _lane_loop(self, points, sch):
        """Lockstep accumulation over all P = K*nb + E lanes: trip s adds
        point order[base + s] (negated where sgn) into each lane with
        s < lcnt.  Returns the (P,) batch of lane partial sums."""
        dev, ops = self.dev, self.dev.ops
        device = points["x"].device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        base, lcnt, order = put(sch["base"]), put(sch["lcnt"]), put(sch["order"])
        sgn = put(sch["sgn"]) if self.signed else None
        total = order.shape[0]
        acc = dev.identity((base.shape[0],))
        for s in range(int(sch["lcnt"].max(initial=0))):
            pos = torch.clamp(base + s, max=total - 1)
            pidx = order.index_select(0, pos)
            pts = {k: points[k].index_select(0, pidx) for k in ("x", "y", "z")}
            if sgn is not None:
                neg = sgn.index_select(0, pos) != 0
                pts["y"] = ops.select(neg, ops.neg(pts["y"]), pts["y"])
            acc = dev.select(s < lcnt, dev.add(acc, pts), acc)
        return acc

    def _fold_merge(self, lanes, sch):
        """Fold the overflow segments onto their head lanes (nlev masked
        partner adds over the E pool) and add the heads into their buckets.
        Returns the (K, nb) bucket grid."""
        dev, K, nb = self.dev, self.K, self.nb
        device = lanes["x"].device
        grid = {k: v[: K * nb] for k, v in lanes.items()}
        ovf = {k: v[K * nb :] for k, v in lanes.items()}
        for j in range(sch["nlev"]):
            idx = torch.from_numpy(sch["fold_idx"][j]).to(device)
            msk = torch.from_numpy(sch["fold_mask"][j]).to(device)
            partner = {k: v.index_select(0, idx) for k, v in ovf.items()}
            ovf = dev.select(msk, dev.add(ovf, partner), ovf)
        if sch["merge_mask"].any():
            idx = torch.from_numpy(sch["merge_idx"]).to(device)
            msk = torch.from_numpy(sch["merge_mask"]).to(device)
            heads = {k: v.index_select(0, idx) for k, v in ovf.items()}
            grid = dev.select(msk, dev.add(grid, heads), grid)
        return {k: v.reshape((K, nb) + v.shape[1:]) for k, v in grid.items()}

    # ---------------------------------------------------------------- run
    def run(self, points, scalars):
        """points: device batch (leading N) or list of affine tuples;
        scalars: (N, L) canonical limbs (tensor or array) or host ints.
        Returns the MSM as a host affine point (None for the identity)."""
        points, limbs = self._inputs(points, scalars)
        n = limbs.shape[0]
        if n == 0:
            return None
        with metrics.timer("msm.host_schedule"):
            sch = self.schedule(limbs)
        metrics.count("msm.points", n)
        metrics.count("msm.balanced_runs")
        metrics.count("msm.balanced_trips_total", sch["trips"])
        with metrics.timer("msm.bucket_phase"):
            lanes = self._lane_loop(points, sch)
            _sync(lanes["x"])
        with metrics.timer("msm.reduce_windows"):
            wpts = self.dev.decode_points(self._staged_windows(self._fold_merge(lanes, sch)))
        with metrics.timer("msm.host_combine"):
            return self._combine_host(wpts)
