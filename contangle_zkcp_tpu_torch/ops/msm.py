"""Multi-scalar multiplication (Pippenger) on the card (torch + kernel K3).

Port of `contangle_zkcp_tpu/ops/msm.py`.  The result is the reference's
point exactly (a host affine point); the device program is this port's
own design:

  1. host schedule: per c-bit window, a stable sort of the point indices
     by bucket digit (`host_schedule` / `host_schedule_signed`, the JAX
     package's numpy schedules, or the native counting sort of
     `msm_sched_native`), giving each (window, bucket) a contiguous run;
  2. heavy buckets (far above the mean occupancy, e.g. digit 1 of the
     low window when most scalars are 0/1 witness bits) are peeled as in
     the reference and summed on their own;
  3. bucket sums: every run is summed at once by a segmented pairwise
     tree — at level s, each entry at a run rank divisible by 2s takes
     the entry s places after it — so a run of length m costs m - 1 adds
     in ceil(log2 m) levels, and each level is ONE batched group add (K3
     for G1).  No bucket is ever added up serially, whatever the skew;
  4. window weights: sum_b w_b S_b is regrouped by the bits of w_b: for
     each window k and bit j, T_kj = sum of the buckets whose weight has
     bit j set — the same segmented tree over (k, j) groups;
  5. host: sum_kj 2^(k c + j) T_kj by Horner on exact affine points, plus
     the heavy buckets' weighted sums.

The lockstep bucket loop, staged reduce dispatches, gather-size chunking
and power-of-two padding of the reference answer TPU-toolchain limits and
have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.weierstrass import SWDevice
from ..fields.bigint import LIMB_BITS, ints_to_limbs
from ..utils import metrics
from . import msm_sched_native


def digits_from_limbs(scalars, c: int, num_windows: int):
    """(N, L) canonical (non-Montgomery) limb tensor -> (K, N) c-bit digits
    (int64).  c must be <= 16 so a digit spans at most two limbs."""
    assert c <= LIMB_BITS
    s = scalars.to(torch.int64)
    padded = torch.cat([s, torch.zeros_like(s[:, :1])], dim=1)
    L = s.shape[1]
    outs = []
    for k in range(num_windows):
        bit = k * c
        li, off = bit // LIMB_BITS, bit % LIMB_BITS
        d = padded[:, min(li, L)] >> off
        if off:
            d = d | (padded[:, min(li + 1, L)] << (LIMB_BITS - off))
        outs.append(d & ((1 << c) - 1))
    return torch.stack(outs)


def _sync(t) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class MSM:
    """Pippenger engine bound to one SW group (G1 or G2 via SWDevice)."""

    HEAVY_CNT = 512  # floor for the peel threshold
    HEAVY_FACTOR = 2  # peel buckets beyond FACTOR * mean occupancy

    def __init__(self, dev: SWDevice, scalar_bits: int, c: int = 8, signed: bool = False):
        self.dev = dev
        self.c = c
        self.scalar_bits = scalar_bits
        self.signed = signed
        if signed:
            # digits recoded into [-2^(c-1), 2^(c-1)-1] with a +1 carry;
            # bucket lane |d|-1 carries weight lane+1
            self.K = -(-(scalar_bits + 1) // c)
            self.nb = 1 << (c - 1)
            leftover = scalar_bits - (self.K - 1) * c
            m_top = 1 << leftover if leftover > 0 else 1
            self.window_m = [self.nb] * (self.K - 1) + [min(m_top, self.nb)]
        else:
            self.K = -(-scalar_bits // c)
            self.nb = 1 << c
            # distinct digit values per window (the top window spans only
            # the leftover bits); the numpy schedule spreads each of its
            # buckets over alias lanes j*m + b, so a lane's weight is
            # lane mod m
            self.window_m = [1 << min(c, scalar_bits - k * c) for k in range(self.K)]

    # ---------------------------------------------------------- scheduling
    def host_schedule(self, scalars_limbs):
        """Numpy bucket schedule: (order, start, cnt) host arrays."""
        arr = np.asarray(scalars_limbs)
        K, c = self.K, self.c
        N = arr.shape[0]
        nb = 1 << c
        order = np.empty((K, N), dtype=np.int32)
        start = np.empty((K, nb), dtype=np.int32)
        cnt = np.empty((K, nb), dtype=np.int32)
        padded = np.concatenate([arr, np.zeros((N, 1), dtype=arr.dtype)], axis=1)
        for k in range(K):
            bit = k * c
            li, off = bit // LIMB_BITS, bit % LIMB_BITS
            d = padded[:, li] >> off
            if off:
                d = d | (padded[:, li + 1] << (LIMB_BITS - off))
            d = (d & (nb - 1)).astype(np.uint32)
            order[k] = np.argsort(d, kind="stable")
            counts = np.bincount(d, minlength=nb).astype(np.int32)
            starts = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int32)
            m = self.window_m[k]
            A = nb // m  # alias slots per real bucket
            if A == 1:
                cnt[k] = counts
                start[k] = starts
            else:
                # spread bucket b's run over lanes j*m + b, j < A
                for b in range(m):
                    tot = int(counts[b])
                    chunk = -(-tot // A) if tot else 0
                    pos = int(starts[b])
                    left = tot
                    for j in range(A):
                        take = min(chunk, left)
                        lane = j * m + b
                        start[k, lane] = pos
                        cnt[k, lane] = take
                        pos += take
                        left -= take
        cnt[:, 0] = 0  # digit 0 contributes nothing
        # alias lanes of bucket 0 contribute nothing either
        for k in range(K):
            m = self.window_m[k]
            if m < nb:
                cnt[k, m::m] = 0
        return order, start, cnt

    def host_schedule_signed(self, scalars_limbs):
        """Signed-digit schedule: (order, start, cnt, sgn) host arrays;
        sgn[k, j] is 1 iff the j-th scheduled point of window k enters its
        bucket negated."""
        arr = np.asarray(scalars_limbs)
        K, c, nb = self.K, self.c, self.nb
        N = arr.shape[0]
        half = 1 << (c - 1)
        padded = np.concatenate(
            [arr.astype(np.int64), np.zeros((N, 2), dtype=np.int64)], axis=1
        )
        carry = np.zeros(N, dtype=np.int64)
        lane = np.empty((K, N), dtype=np.int64)
        sign = np.empty((K, N), dtype=bool)
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
            lane[k] = np.where(mag > 0, mag - 1, nb)  # nb = dead sentinel
        order = np.empty((K, N), dtype=np.int32)
        start = np.zeros((K, nb), dtype=np.int32)
        cnt = np.zeros((K, nb), dtype=np.int32)
        sgn = np.empty((K, N), dtype=np.int8)
        for k in range(K):
            o = np.argsort(lane[k], kind="stable").astype(np.int32)
            order[k] = o
            sgn[k] = sign[k][o]
            counts = np.bincount(lane[k], minlength=nb + 1)[:nb].astype(np.int32)
            starts = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int32)
            m = self.window_m[k]
            A = nb // m
            if A <= 1:
                cnt[k], start[k] = counts, starts
            else:
                for b in range(m):
                    tot = int(counts[b])
                    chunk = -(-tot // A) if tot else 0
                    pos = int(starts[b])
                    left = tot
                    for j in range(A):
                        take = min(chunk, left)
                        al = j * m + b
                        start[k, al] = pos
                        cnt[k, al] = take
                        pos += take
                        left -= take
        return order, start, cnt, sgn

    def schedule(self, limbs):
        """(order, start, cnt, sgn or None): the native counting sort when
        it is built, else the numpy schedule (same bucket contents)."""
        res = msm_sched_native.schedule(limbs, self.K, self.c, self.signed)
        if res is None:
            if self.signed:
                return self.host_schedule_signed(limbs)
            return (*self.host_schedule(limbs), None)
        order, sgn, counts = res
        cnt = counts.astype(np.int32)
        start = np.zeros_like(cnt)
        start[:, 1:] = np.cumsum(cnt, axis=1)[:, :-1]
        return order, start, cnt, sgn if self.signed else None

    # --------------------------------------------------- segmented sums
    def segment_sums(self, points, idx, seg_len, neg=None):
        """Sums of consecutive runs of gathered points, in log depth.

        points: device batch; idx (M,) host gather indices, run after run;
        seg_len (S,) host run lengths (all > 0); neg (M,) host bools
        negating gathered points.  Returns the (S,) batch of run sums."""
        dev, ops = self.dev, self.dev.ops
        device = points["x"].device
        seg_len = np.asarray(seg_len, dtype=np.int64)
        starts = np.zeros_like(seg_len)
        starts[1:] = np.cumsum(seg_len)[:-1]
        idx_t = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(device)
        P = {k: points[k].index_select(0, idx_t) for k in ("x", "y", "z")}
        if neg is not None and neg.any():
            neg_t = torch.from_numpy(np.ascontiguousarray(neg, dtype=bool)).to(device)
            P["y"] = ops.select(neg_t, ops.neg(P["y"]), P["y"])
        rank = np.arange(len(idx), dtype=np.int64) - np.repeat(starts, seg_len)
        rank_t = torch.from_numpy(rank).to(device)
        len_t = torch.from_numpy(np.repeat(seg_len, seg_len)).to(device)
        s, longest = 1, int(seg_len.max())
        while s < longest:
            i = torch.nonzero(((rank_t % (2 * s)) == 0) & (rank_t + s < len_t)).squeeze(1)
            summed = dev.add(
                {k: P[k].index_select(0, i) for k in P},
                {k: P[k].index_select(0, i + s) for k in P},
            )
            for k in P:
                P[k].index_copy_(0, i, summed[k])
            s *= 2
        first = torch.from_numpy(starts).to(device)
        return {k: P[k].index_select(0, first) for k in P}

    # ------------------------------------------------------ heavy buckets
    def _heavy_thresh(self, n_points: int) -> int:
        """Peel threshold: scales with the mean bucket occupancy, so a
        uniform-scalar MSM never peels while witness-skewed buckets (~n/2
        points in one bucket) always do."""
        mean = -(-n_points // self.nb)
        return max(self.HEAVY_CNT, self.HEAVY_FACTOR * mean)

    def _extract_heavy(self, points, order, start, cnt, sgn=None):
        """Peel buckets with cnt above the threshold: sum their points on
        device, zero them in the schedule, return [(window, weight,
        host_point)] corrections.  Mutates cnt in place."""
        heavy = np.argwhere(cnt > self._heavy_thresh(order.shape[1]))
        if not len(heavy):
            return []
        idx, neg, lens = [], [], []
        for k, lane in heavy:
            s0, n0 = int(start[k, lane]), int(cnt[k, lane])
            idx.append(order[k, s0 : s0 + n0])
            if sgn is not None:
                neg.append(sgn[k, s0 : s0 + n0] != 0)
            lens.append(n0)
            cnt[k, lane] = 0
        sums = self.segment_sums(
            points,
            np.concatenate(idx),
            lens,
            np.concatenate(neg) if sgn is not None else None,
        )
        host_pts = self.dev.decode_points(sums)
        off = 1 if sgn is not None else 0
        return [
            (int(k), int(lane) % self.window_m[k] + off, pt)
            for (k, lane), pt in zip(heavy, host_pts)
            if pt is not None
        ]

    def _host_mul_small(self, w: int, P):
        add = self.dev.host_add
        acc = None
        for bit in reversed(range(w.bit_length())):
            acc = add(acc, acc)
            if (w >> bit) & 1:
                acc = add(acc, P)
        return acc

    # ---------------------------------------------------------- phases
    def _bucket_runs(self, order, start, cnt, sgn):
        """The schedule's non-empty (window, lane) runs, flattened: (gather
        indices, run lengths, negations or None, window of each run, lane
        of each run), host arrays."""
        flat = cnt.reshape(-1)
        nz = np.flatnonzero(flat)
        seg_len = flat[nz].astype(np.int64)
        seg_k = nz // self.nb
        seg_start = start.reshape(-1)[nz].astype(np.int64)
        run_of = np.repeat(np.arange(len(nz)), seg_len)
        pos = np.repeat(seg_start, seg_len) + (
            np.arange(int(seg_len.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(seg_len) - seg_len, seg_len)
        )
        rows = seg_k[run_of]
        idx = order[rows, pos]
        neg = sgn[rows, pos] != 0 if sgn is not None else None
        return idx, seg_len, neg, seg_k, nz % self.nb

    def _bucket_sums(self, points, order, start, cnt, sgn):
        """Every non-empty (window, lane) run summed on device.
        Returns (sums batch, window of each run, lane of each run)."""
        idx, seg_len, neg, seg_k, seg_lane = self._bucket_runs(order, start, cnt, sgn)
        sums = self.segment_sums(points, idx, seg_len, neg)
        return sums, seg_k, seg_lane

    def _weighted_groups(self, sums, seg_k, seg_lane):
        """T_kj = sum of the runs of window k whose weight has bit j set,
        for every non-empty (k, j); returns {k*c + j: host point}."""
        off = 1 if self.signed else 0
        wm = np.asarray(self.window_m, dtype=np.int64)
        weight = seg_lane % wm[seg_k] + off
        nbits = int(weight.max()).bit_length()
        bits = (weight[:, None] >> np.arange(nbits)) & 1  # (S, nbits)
        run, j = np.nonzero(bits)
        key = seg_k[run] * nbits + j
        o = np.argsort(key, kind="stable")
        run, key = run[o], key[o]
        groups, glen = np.unique(key, return_counts=True)
        T = self.segment_sums(sums, run, glen)
        pts = self.dev.decode_points(T)
        out = {}
        for g, pt in zip(groups, pts):
            e = int(g // nbits) * self.c + int(g % nbits)
            out[e] = self.dev.host_add(out.get(e), pt)
        return out

    # ---------------------------------------------------------------- run
    def _inputs(self, points, scalars):
        """(device point batch, (N, L) host limbs) from the accepted forms:
        a batch or affine tuples; limbs (tensor or array) or host ints."""
        if isinstance(points, (list, tuple)):
            points = self.dev.encode_points(list(points))
        if isinstance(scalars, (list, tuple)):
            scalars = ints_to_limbs(scalars, -(-self.scalar_bits // LIMB_BITS))
        if isinstance(scalars, torch.Tensor):
            scalars = scalars.cpu().numpy()
        limbs = np.asarray(scalars)
        assert points["x"].shape[0] == limbs.shape[0], (points["x"].shape, limbs.shape)
        return points, limbs

    def run(self, points, scalars):
        """points: device batch (leading N) or list of affine tuples;
        scalars: (N, L) canonical limbs (tensor or array) or host ints.
        Returns the MSM as a host affine point (None for the identity)."""
        dev = self.dev
        points, limbs = self._inputs(points, scalars)
        n = limbs.shape[0]
        with metrics.timer("msm.host_schedule"):
            order, start, cnt, sgn = self.schedule(limbs)
        with metrics.timer("msm.heavy_peel"):
            heavy = self._extract_heavy(points, order, start, cnt, sgn)
        metrics.count("msm.points", n)
        metrics.gauge("msm.heavy_buckets", len(heavy))
        res = None
        if cnt.any():
            with metrics.timer("msm.bucket_phase"):
                sums, seg_k, seg_lane = self._bucket_sums(points, order, start, cnt, sgn)
                _sync(sums["x"])
            with metrics.timer("msm.reduce_windows"):
                terms = self._weighted_groups(sums, seg_k, seg_lane)
            with metrics.timer("msm.host_combine"):
                for e in range(max(terms), -1, -1):
                    res = dev.host_add(res, res)
                    res = dev.host_add(res, terms.get(e))
        with metrics.timer("msm.host_combine"):
            for k, b, pt in heavy:
                res = dev.host_add(res, self._host_mul_small(b << (k * self.c), pt))
        return res


def msm_host(curve, points, scalars):
    """Exact host sum of k_i * P_i, one scalar multiply per point: the
    yardstick chip_smoke.py holds the card's MSM against."""
    acc = None
    for P, s in zip(points, scalars):
        acc = curve.add(acc, curve.mul(s, P))
    return acc
