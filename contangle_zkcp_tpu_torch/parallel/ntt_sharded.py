"""Multi-GPU NTT: an explicit Bailey four-step with all-to-all exchanges.

Port of `contangle_zkcp_tpu/parallel/ntt_sharded.py`.  The length-n
transform is an (n1 x n2) matrix — column NTTs, a twiddle scaling, row
NTTs, a transpose — with the three global transposes as
`torch.distributed.all_to_all_single` (NCCL on the cards, gloo on the
CPU).  The local transforms are batches through `NTT.forward_batched`
(ops/ntt.py): each pass of a batch of columns or rows is ONE launch of
k2_ntt_pass (k5b_ntt_pass under ZKCP_MXU=1); the twiddle scaling is one
`F.mul` (kernel K1, or K5a under ZKCP_MXU=1).

Layout walk (D ranks, rows sharded; the reference's, step for step):
    in   (n1, n2)   rows sharded        local (n1/D, n2)
    A2A  split ax1 / concat ax0 -> local (n1, n2/D)      [transpose 1]
    NTT  length-n1 along axis 0 (batched over the n2/D columns)
    mul  w_n^{k1 i2} twiddles (this rank's columns i2)
    A2A  split ax0 / concat ax1 -> local (n1/D, n2)      [transpose 2]
    NTT  length-n2 along axis 1 (batched over the n1/D rows)
    A2A  split ax1 / concat ax0, local transpose         [transpose 3]
    out  (n2, n1)   rows sharded: flattened, X in natural order.

The twiddle slab w_n^{k1 i2} (this rank's n2/D columns, all n1 rows) is
built on the device by doubling multiplies, as ops/ntt.py `powers` builds
its tables: no per-element host work.

`ShardedNTT` is the baseline the reference delegates to XLA's automatic
sharding: rows-sharded in and out, each rank gathering the rows, running
the one-card transform and keeping its block.
"""

from __future__ import annotations

import torch

from ..fields import instances as fi
from ..ops.ntt import NTT, powers


class ShardedNTT:
    """Rows-sharded (n/D, L) in and out, natural order."""

    def __init__(self, ntt: NTT, mesh, axis: str = "points"):
        mesh.check_axis(axis)
        self.ntt = ntt
        self.mesh = mesh
        self.axis = axis

    def shard(self, a):
        """This rank's rows of the global (n, L) array, on its device."""
        return self.mesh.shard(a)

    def forward(self, a):
        return self.mesh.shard(self.ntt.forward(self.mesh.gather(a)))

    def inverse(self, a):
        return self.mesh.shard(self.ntt.inverse(self.mesh.gather(a)))


def twiddle_slab(F, n: int, n1: int, cols: range, device) -> torch.Tensor:
    """(len(cols), n1, L) Montgomery limbs: w_n^(k1 i2) at [i2 - cols.start,
    k1], w the n-th root; cols of power-of-two length.  Row i2_0 is g^k1, g
    = w^i2_0 (`powers`); then rows [2^j, 2^(j+1)) are rows [0, 2^j) times
    w^(k1 2^j), squared from w^k1 once a doubling."""
    w = fi.root_of_unity(F.p, n)
    slab = powers(F, pow(w, cols.start, F.p), n1, device)[None]
    step = powers(F, w, n1, device)  # w^k1, then w^(k1 2^j)
    while slab.shape[0] < len(cols):
        r = slab.shape[0]
        more = F.mul(slab.reshape(-1, F.L), step[None].expand(r, n1, F.L).reshape(-1, F.L))
        slab = torch.cat([slab, more.reshape(r, n1, F.L)])
        step = F.mul(step, step)
    return slab[: len(cols)].contiguous()


class FourStepNTT:
    """Explicit distributed four-step NTT over the mesh's axis."""

    def __init__(self, F, n: int, mesh, axis: str = "points", n1: int | None = None):
        mesh.check_axis(axis)
        if n < 4 or n & (n - 1):
            raise ValueError(f"n = {n} is not a power of two >= 4")
        D = mesh.size
        if n1 is None:
            n1 = max(1 << ((n.bit_length() - 1) // 2), D)
        n2 = n // n1
        if n1 * n2 != n or min(n1, n2) < 2 or n1 % D or n2 % D:
            raise ValueError(f"n1 = {n1}, n2 = {n2} do not split over {D} ranks")
        self.F, self.n, self.mesh, self.axis, self.D = F, n, mesh, axis, D
        self.n1, self.n2 = n1, n2
        self.col = NTT(F, n1, device=mesh.device)
        self.row = NTT(F, n2, device=mesh.device)
        w2 = n2 // D
        self._tw = twiddle_slab(F, n, n1, range(mesh.rank * w2, (mesh.rank + 1) * w2),
                                mesh.device)  # (n2/D, n1, L)

    def forward_local(self, a):
        """a: this rank's (n1/D, n2, L) rows of the (n1, n2) matrix ->
        its (n2/D, n1, L) rows of the (n2, n1) result."""
        F, mesh = self.F, self.mesh
        a = mesh.all_to_all(a, split_axis=1, concat_axis=0)  # (n1, n2/D)
        a = self.col.forward_batched(a.transpose(0, 1))  # (n2/D, n1): columns
        a = F.mul(a.reshape(-1, F.L), self._tw.reshape(-1, F.L)).reshape(a.shape)
        a = mesh.all_to_all(a.transpose(0, 1), split_axis=0, concat_axis=1)  # (n1/D, n2)
        a = self.row.forward_batched(a)
        a = mesh.all_to_all(a, split_axis=1, concat_axis=0)  # (n1, n2/D)
        return a.transpose(0, 1).contiguous()  # (n2/D, n1)

    def forward(self, a):
        """a: the global (n, L) array (on every rank) -> the (n, L) DFT in
        natural order, computed sharded and gathered on every rank."""
        mat = a.reshape(self.n1, self.n2, self.F.L)
        out = self.forward_local(self.mesh.shard(mat))
        return self.mesh.gather(out).reshape(self.n, self.F.L)
