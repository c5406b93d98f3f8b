"""Mesh-pipelined Nova folding of a stream of PoE-shaped instances.

Port of `contangle_zkcp_tpu/parallel/fold_pipeline.py`.  A TREE fold of k
lifted instances (groth16/folding.py `FoldingScheme`) where each level's
device work — the m cross-term commitments comm_T = MSM(bases_E, T) —
runs as ONE sharded multi-vector MSM over the mesh:

  * bases_E, padded with the identity to a multiple of the mesh size,
    are sharded along the mesh's axis once and stay on the ranks' cards
    for the whole stream (pad slots get zero scalars: no contribution);
  * per rank, the m vectors' bucket runs go through one segmented sum and
    one weighted-group sum (parallel/msm_sharded.py `local_partials`:
    each tree level one batch of K3 adds a round, the counterpart of the
    reference's vmap over m);
  * one all-reduce combines the window partials of all m vectors at once.

The combine step is the scheme's `fold_with_comm`, whose Fiat-Shamir
transcript is the sequential `FoldingScheme.fold`'s, so the mesh and the
sequential tree give the same accumulator.
"""

from __future__ import annotations

import numpy as np

from ..fields.bigint import LIMB_BITS, ints_to_limbs
from ..groth16.folding import g1_device
from ..ops.msm import MSM
from .msm_sharded import ShardedMSM


class MeshFoldPipeline:
    def __init__(self, scheme, mesh, axis: str = "points", c: int = 8):
        self.scheme = scheme
        self.mesh = mesh
        self.axis = axis
        self.dev = g1_device(mesh.device)
        self.msm = MSM(self.dev, scalar_bits=255, c=c)
        self.sharded = ShardedMSM(self.msm, mesh, axis)
        self.ndev = self.sharded.ndev
        self.L = -(-255 // LIMB_BITS)
        nb = len(scheme.bases_e)
        self.n_pts = -(-nb // self.ndev) * self.ndev
        self._blk = mesh.block(self.n_pts)
        padded = list(scheme.bases_e) + [None] * (self.n_pts - nb)
        self._pts = self.dev.encode_points(padded[self._blk])  # this rank's shard, once

    def commit_many(self, vecs):
        """[m vectors of field ints] -> [m host affine commitments], each
        vector padded with zeros to the sharded base count."""
        p = self.scheme.p
        limbs = []
        for v in vecs:
            arr = np.zeros((self.n_pts, self.L), dtype=np.uint32)
            arr[: len(v)] = ints_to_limbs([x % p for x in v], self.L)
            limbs.append(arr[self._blk])
        sh = self.sharded
        return sh.combine(sh.all_reduce(sh.local_partials(self._pts, limbs)), len(vecs))

    def fold_stream(self, lifted):
        """Tree-fold k lifted (instance, witness) pairs into one
        accumulator; each level's cross-term commitments run as one
        sharded multi-vector MSM."""
        sch = self.scheme
        level = list(lifted)
        while len(level) > 1:
            pairs = [(level[i], level[i + 1]) for i in range(0, len(level) - 1, 2)]
            carry = level[len(pairs) * 2:]
            Ts = [sch.cross_term(i1, w1, i2, w2) for (i1, w1), (i2, w2) in pairs]
            comms = self.commit_many(Ts)
            level = [
                sch.fold_with_comm(i1, w1, i2, w2, T, comm)
                for ((i1, w1), (i2, w2)), T, comm in zip(pairs, Ts, comms)
            ] + carry
        return level[0]
