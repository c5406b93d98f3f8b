"""SampleEntries circuit (Proof of Property via ciphertext sampling).

Constraint-level mirror of the reference's `SampleEntries`
(nulltea/contangle-zkcp:circuits-ark/src/sample_entries.rs:92-233): proves that a
sampled ciphertext block (a) is a member of the Poseidon Merkle tree built
over the c2 blocks and (b) decrypts under sk to the claimed public value.

  inputs:    sample_value (first), merkle_root (second) — the verifier
             supplies [sample_value, root] (lib/src/zk/sample_entries.rs:
             109-128);
  witnesses: c1 point, the sampled leaf c2 value, the Merkle path
             (sibling digests + index bits), sk bits (256, LE);
  logic:     leaf digest = Poseidon([leaf]); fold up the path with
             TwoToOne CRH choosing operand order by the index bits;
             digest == root;  c2 - Poseidon(sk*c1) == sample_value.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.merkle import build_tree_host
from ..r1cs.builder import ConstraintSystem
from ..r1cs.gadgets import Gadgets
from . import elgamal

SK_BITS = 256


@dataclass
class SampleEntriesCircuit:
    params: elgamal.ElGamalParams  # n = leaf count (power of two)

    def synthesize(self, ciphertext, sk: int, sample_idx: int) -> ConstraintSystem:
        curve = self.params.curve
        perm = self.params.poseidon
        n = self.params.n
        c1, c2 = ciphertext
        assert len(c2) == n and n & (n - 1) == 0

        tree = build_tree_host(perm, c2)
        siblings = tree.path(sample_idx)
        sample_value = elgamal.decrypt_at(self.params, sk, ciphertext, sample_idx)

        cs = ConstraintSystem(p=curve.p)
        g = Gadgets(cs)

        # public inputs: sample_value then merkle_root
        sample_var = g.input(sample_value)
        root_var = g.input(tree.root)

        # witnesses: ciphertext c1 + sampled leaf
        c1_var = g.ed_witness(curve, c1)
        leaf_var = g.witness(c2[sample_idx])

        # ---- membership: fold the path (index bits witnessed as booleans)
        digest = g.poseidon_hash1(perm, leaf_var)
        idx = sample_idx
        for sib in siblings:
            bit = g.alloc_bit(idx & 1)
            sib_var = g.witness(sib)
            left = g.select(bit, sib_var, digest)
            right = g.select(bit, digest, sib_var)
            digest = g.poseidon_hash2(perm, left, right)
            idx //= 2
        g.enforce_equal(digest, root_var)

        # ---- in-circuit decryption: c2 - Poseidon(sk*c1) == sample_value
        bits = g.bits_le(sk, SK_BITS)
        s_var = g.ed_scalar_mul_le(curve, c1_var, bits)
        dh = g.poseidon_hash2(perm, s_var[0], s_var[1])
        g.enforce_equal(leaf_var - dh, sample_var)

        return cs

    def dummy_instance(self):
        """Structural instance for setup (the reference compiles with the
        generator point, zero sk and zero blocks, sample_idx=1 —
        lib/src/zk/sample_entries.rs:130-141)."""
        curve = self.params.curve
        ciphertext = (curve.generator, [0] * self.params.n)
        return ciphertext, 0, 1
