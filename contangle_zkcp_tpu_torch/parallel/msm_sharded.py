"""Multi-GPU MSM: points sharded over the mesh, a bucket phase per rank,
the window partials all-reduced on the cards.

Port of `contangle_zkcp_tpu/parallel/msm_sharded.py`.  The point and
scalar arrays are sharded along the mesh's axis ("points"); every rank
runs the port's bucket program (ops/msm.py) on its shard alone — no
exchange in the O(N) phase — and the ranks' partials are combined by one
collective and log2(D) batched group adds, so that every rank holds the
global partials; the host combines them once.

The partials need a layout every rank agrees on, whatever its scalars:
the lockstep engine's T_kj (window k, weight bit j: the sum of the
window's buckets whose weight has bit j set) kept on the device as a
dense (K c,) batch, slot k c + j, the identity (0 : 1 : 0) where a rank
has no such bucket.  sum_kj 2^(k c + j) T_kj is the MSM.  The all-reduce
is one `all_gather` of the (D, 3, K c, L) partials followed by a pairwise
tree of log2(D) batched adds (kernel K3 for G1), the same on every rank.

No heavy bucket is peeled: the segmented sums (`MSM.segment_sums`) are
log-depth whatever a run's length, and a peeled bucket would leave a host
term to be combined across ranks.  All-zero and tiny shards give identity
partials.

`run` takes each shard's schedule from `MSM.schedule` (the native
counting sort when it is built); `run_scheduled` from the numpy
schedules of the JAX package (`host_schedule`, `host_schedule_signed`),
per shard, as the reference's host-scheduled variant does.  Both are
bit-equal to `msm_host`.  `local_partials` takes several scalar vectors
over the same points at once: their runs go through ONE segmented sum
and ONE weighted-group sum, and one all-reduce carries them all (the
counterpart of the reference's vmapped bucket phase,
parallel/fold_pipeline.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.msm import MSM

COORDS = ("x", "y", "z")


class ShardedMSM:
    def __init__(self, msm: MSM, mesh, axis: str = "points"):
        mesh.check_axis(axis)
        D = mesh.size
        if D & (D - 1):
            raise ValueError(f"the mesh size must be a power of two, not {D}")
        self.msm = msm
        self.mesh = mesh
        self.axis = axis
        self.ndev = D
        self.slots = msm.K * msm.c  # (window, weight bit) slots a vector

    # ------------------------------------------------------------ schedules
    def _host_schedule(self, limbs):
        if self.msm.signed:
            return self.msm.host_schedule_signed(limbs)
        return (*self.msm.host_schedule(limbs), None)

    # -------------------------------------------------------------- phases
    def local_partials(self, points, limbs_list, schedule=None):
        """This rank's partials of m scalar vectors over its point shard:
        the dense (m K c,) device batch, vector v's T_kj at slot
        (v K + k) c + j.  points: device batch of the shard; limbs_list: m
        (N_local, L) canonical limb arrays; schedule: limbs -> (order,
        start, cnt, sgn or None), `MSM.schedule` by default."""
        msm = self.msm
        schedule = schedule or msm.schedule
        K, c, m = msm.K, msm.c, len(limbs_list)
        runs = []
        for v, limbs in enumerate(limbs_list):
            order, start, cnt, sgn = schedule(np.ascontiguousarray(limbs))
            idx, seg_len, neg, seg_k, seg_lane = msm._bucket_runs(order, start, cnt, sgn)
            runs.append((idx, seg_len, neg, seg_k, seg_lane, np.full(len(seg_len), v)))
        cols = list(zip(*runs))
        idx, seg_len, seg_k, seg_lane, seg_v = (np.concatenate(cols[i]) for i in (0, 1, 3, 4, 5))
        neg = np.concatenate(cols[2]) if msm.signed else None  # the signed schedules' negations
        dense = msm.dev.identity((m * self.slots,))
        if len(seg_len) == 0:
            return dense
        sums = msm.segment_sums(points, idx, seg_len, neg)
        off = 1 if msm.signed else 0
        weight = seg_lane % np.asarray(msm.window_m, dtype=np.int64)[seg_k] + off
        run, j = np.nonzero((weight[:, None] >> np.arange(c)) & 1)  # weight < 2^c
        key = (seg_v[run] * K + seg_k[run]) * c + j
        o = np.argsort(key, kind="stable")
        groups, glen = np.unique(key[o], return_counts=True)
        T = msm.segment_sums(sums, run[o], glen)
        slot = torch.from_numpy(groups.astype(np.int64)).to(dense["x"].device)
        for k in COORDS:
            dense[k].index_copy_(0, slot, T[k])
        return dense

    def all_reduce(self, part):
        """Every rank's partials summed: one all_gather, then a pairwise
        tree of batched adds; every rank gets the same batch."""
        dev = self.msm.dev
        g = self.mesh.gather(torch.stack([part[k] for k in COORDS])[None])  # (D, 3, S, ...)
        while g.shape[0] > 1:
            h = g.shape[0] // 2
            s = dev.add({k: g[:h, i] for i, k in enumerate(COORDS)},
                        {k: g[h:, i] for i, k in enumerate(COORDS)})
            g = torch.stack([s[k] for k in COORDS], dim=1)
        return {k: g[0, i] for i, k in enumerate(COORDS)}

    def combine(self, total, m: int = 1):
        """m host affine points (None for the identity): each vector's
        slots decoded once and summed by Horner on exact points."""
        dev = self.msm.dev
        pts = dev.decode_points(total)
        out = []
        for v in range(m):
            res = None
            for e in range(self.slots - 1, -1, -1):
                res = dev.host_add(dev.host_add(res, res), pts[v * self.slots + e])
            out.append(res)
        return out

    # ---------------------------------------------------------------- run
    def _run(self, points, scalars, schedule):
        points, limbs = self.msm._inputs(points, scalars)
        blk = self.mesh.block(limbs.shape[0])
        local = {k: v[blk] for k, v in points.items()}
        part = self.local_partials(local, [limbs[blk]], schedule)
        return self.combine(self.all_reduce(part))[0]

    def run(self, points, scalars):
        """points: the global device batch or affine tuples; scalars: (N,
        L) canonical limbs or host ints, N divisible by the mesh size.  Each
        rank's shard scheduled by `MSM.schedule`.  Returns the MSM as a
        host affine point, the same on every rank."""
        return self._run(points, scalars, None)

    def run_scheduled(self, points, scalars):
        """`run` with each shard scheduled by the numpy schedules."""
        return self._run(points, scalars, self._host_schedule)
