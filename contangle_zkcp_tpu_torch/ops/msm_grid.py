"""The (K, nb) bucket grid's window reduction, shared by the grid engines.

`BalancedMSM` (ops/msm_balanced.py) and `TreeMSM` (ops/msm_tree.py) fill a
projective (K, nb) bucket grid on the card, bucket lane b of window k
weighing b + 1 (signed) or b (unsigned).  `GridMSM` reduces it as the
reference's MSM._staged_windows does: lane b = hi * Hf + lo, so

    sum_b w_b S_b = Hf * sum_hi hi * T_hi + sum_lo (lo + off) * U_lo,

T_hi = sum over lo, U_lo = sum over hi (halving tree levels, each one
batched add).  Each weighted sum sum_b (b + off) S_b is a suffix scan
R_b = sum_(b' >= b) S_b' in log2 levels, then a tree sum of R over
b >= 1 - off: 2 log2(width) batched adds, where the reference's running-sum
recurrence takes 2 (width - 1 + off).

The K window sums are then decoded once and combined by Horner on the
host, as the lockstep engine combines its terms.  The reference's combine
on the device (K (c + 1) chained one-point adds) is left out: on the card
each of those adds is a launch of its own (about 1,000 for a G2 add), and
the host's Horner on the decoded sums is the cheaper of the two in both
groups (PERF.md, the MSM engines).
"""

from __future__ import annotations

import torch

from .msm import MSM


class GridMSM(MSM):
    """Base of the engines that fill a (K, nb) bucket grid: the grid's
    window reduction and the combine.  The schedule and the bucket
    accumulation are the subclasses'."""

    def _fold_aliases(self, acc):
        """Fold alias lanes j*m + b onto lane b for windows whose digit
        range m_k is narrower than nb (the numpy schedules spread such a
        window's buckets over the free lanes); lanes >= m_k become the
        identity.  Nothing to do where every window spans nb lanes."""
        dev, K, nb = self.dev, self.K, self.nb
        device = acc["x"].device
        w = nb
        while w // 2 >= min(self.window_m) and w > 1:
            half = w // 2
            mask = torch.tensor([[m <= half] for m in self.window_m], device=device)
            lo = {k: v[:, :half] for k, v in acc.items()}
            hi = {k: v[:, half:w] for k, v in acc.items()}
            folded_lo = dev.select(mask, dev.add(lo, hi), lo)
            folded_hi = dev.select(mask, dev.identity((K, half)), hi)
            acc = {k: torch.cat([folded_lo[k], folded_hi[k], acc[k][:, w:]], dim=1) for k in acc}
            w = half
        return acc

    def _tree_sum(self, pts, axis: int):
        """Sum over `axis` (a power-of-two width) by halving levels."""
        while pts["x"].shape[axis] > 1:
            half = pts["x"].shape[axis] // 2
            pts = self.dev.add(
                {k: v.narrow(axis, 0, half) for k, v in pts.items()},
                {k: v.narrow(axis, half, half) for k, v in pts.items()},
            )
        return {k: v.squeeze(axis) for k, v in pts.items()}

    def _weighted(self, S, offset: int):
        """sum_b (b + offset) S_b over lane axis 1 of the (K, n) batch S,
        offset 0 or 1."""
        dev = self.dev
        n = S["x"].shape[1]
        R, d = S, 1
        while d < n:  # R_b <- R_b + R_(b+d): after log2 n levels a suffix sum
            summed = dev.add({k: v[:, : n - d] for k, v in R.items()},
                             {k: v[:, d:] for k, v in R.items()})
            R = {k: torch.cat([summed[k], R[k][:, n - d :]], dim=1) for k in R}
            d *= 2
        if offset == 0:  # lane 0 weighs 0
            ident = dev.identity((S["x"].shape[0], 1))
            R = {k: torch.cat([ident[k], R[k][:, 1:]], dim=1) for k in R}
        return self._tree_sum(R, 1)

    def _staged_windows(self, acc):
        """(K, nb) projective bucket grid -> (K,) window sums on the card."""
        dev, K, nb = self.dev, self.K, self.nb
        acc = self._fold_aliases(acc)
        nbits = nb.bit_length() - 1
        cl = nbits // 2
        G, Hf = 1 << (nbits - cl), 1 << cl
        grid = {k: v.reshape((K, G, Hf) + v.shape[2:]) for k, v in acc.items()}
        s_hi = self._weighted(self._tree_sum(grid, 2), 0)
        s_lo = self._weighted(self._tree_sum(grid, 1), 1 if self.signed else 0)
        for _ in range(cl):  # s_hi *= Hf
            s_hi = dev.add(s_hi, s_hi)
        return dev.add(s_hi, s_lo)

    def _combine_host(self, wpts):
        """Horner combine of the K window sums on the host: sum_k 2^(kc) W_k."""
        add = self.dev.host_add
        acc = None
        for w in reversed(wpts):
            for _ in range(self.c):
                acc = add(acc, acc)
            acc = add(acc, w)
        return acc
