"""Poseidon Merkle tree (host orchestration, device-batched hashing).

Port of `contangle_zkcp_tpu/ops/merkle.py`, a mirror of
ark-crypto-primitives' `MerkleTree<MTConfig>` as used by the SampleEntries
circuit (nulltea/contangle-zkcp:circuits-ark/src/sample_entries.rs:
26-53,127-134): leaf digest = Poseidon CRH of [leaf] (hash1), inner =
TwoToOne CRH (hash2), IdentityDigestConverter, power-of-two leaf count.

Building the tree over an n-block ciphertext is n-1 + n Poseidon
permutations — the verifier-side hot loop (SURVEY.md §3.3) — so each tree
level is hashed as one batched device call.
"""

from __future__ import annotations

from .poseidon import PoseidonDevice, PoseidonHost


class MerkleTree:
    def __init__(self, levels):
        # levels[0] = leaf digests ... levels[-1] = [root]
        self.levels = levels

    @property
    def root(self) -> int:
        return self.levels[-1][0]

    def path(self, idx: int):
        """Sibling digests bottom-up (ark Path has auth path + leaf
        siblings; with Identity converter the leaf level sibling is a leaf
        digest)."""
        siblings = []
        for level in self.levels[:-1]:
            siblings.append(level[idx ^ 1])
            idx //= 2
        return siblings

    @staticmethod
    def verify_host(perm: PoseidonHost, root: int, idx: int, leaf_value: int, siblings) -> bool:
        cur = perm.hash1(leaf_value)
        for sib in siblings:
            if idx & 1:
                cur = perm.hash2(sib, cur)
            else:
                cur = perm.hash2(cur, sib)
            idx //= 2
        return cur == root


def build_tree_host(perm: PoseidonHost, leaves) -> MerkleTree:
    n = len(leaves)
    assert n & (n - 1) == 0 and n >= 2
    level = [perm.hash1(x) for x in leaves]
    levels = [level]
    while len(level) > 1:
        level = [perm.hash2(level[i], level[i + 1]) for i in range(0, len(level), 2)]
        levels.append(level)
    return MerkleTree(levels)


def build_tree_device(F, dev: PoseidonDevice, leaves, device="cuda") -> MerkleTree:
    """Same tree, each level hashed as one batched call on `device`."""
    n = len(leaves)
    assert n & (n - 1) == 0 and n >= 2
    level = dev.hash1(F.encode(list(leaves), device=device))  # (n, L) Montgomery
    levels = [F.decode(level)]
    while level.shape[0] > 1:
        level = dev.hash2(level[0::2], level[1::2])
        levels.append(F.decode(level))
    return MerkleTree(levels)
