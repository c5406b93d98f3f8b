"""MSM engine selection policy: (group, n) -> window config and engine.

Port of `contangle_zkcp_tpu/ops/msm_policy.py`: every choice (SMALL_N,
the window width c, signed digits, the engine's name) is the reference's,
so the port runs the MSM the reference runs at each size:

* signed-digit windows (ops/msm.py host_schedule_signed) halve the
  bucket grid and cut windows from ceil(bits/c) to ceil((bits+1)/c) —
  preferred at scale; unsigned c=8 for small MSMs.
* proving-scale MSMs (n >= 2^16) run on the skew-balanced lane engine
  (ops/msm_balanced.py) in both groups, G1 at c = 16 and G2 at c = 12.
* the bucket accumulator grid is K * nb projective points held on the
  card while the buckets fill; BUCKET_GRID_BYTES_CAP bounds it and
  msm_config asserts the bound for every choice.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MSMConfig:
    c: int
    signed: bool
    # bucket-accumulation engine: "lockstep" = ops/msm.py (the port's
    # segmented pairwise bucket sums); "balanced" = ops/msm_balanced.py
    # skew-balanced lane schedule (overflow segments instead of a
    # heavy-bucket peel; the default at proving scale); "tree" =
    # ops/msm_tree.py batch-affine pairwise tree (by name only).
    engine: str = "lockstep"


# Hard cap on the bucket accumulator grid (K * nb projective points), for
# an 80 GB card.  The balanced engine's peak device memory, input points
# included, was measured on an H100 at up to 64 times its grid: 1.54 GiB
# for G2 c=12's 26 MB grid (the 110,592-lane array, the gathered points
# and the Fq2 add's temporaries), 0.84 GiB for G1 c=16's 151 MB.  At that
# ratio a grid at the cap peaks near 17 GB, a fifth of the card, which
# leaves the rest to the prover's other arrays (a PoE prove peaks at
# 13-22 GiB).  The policy's grids are both under it.
BUCKET_GRID_BYTES_CAP = 1 << 28

# bytes per projective point as the port holds it: 3 coordinates of L
# int32 limbs (L = 24 for BLS12-381 Fq, the widest supported base field),
# twice that for G2's Fq2 coordinates; no row padding
_ROW_BYTES = {"g1": 3 * 24 * 4, "g2": 3 * 2 * 24 * 4}

SMALL_N = 1 << 16  # below this: plain c=8 on the lockstep engine


def grid_bytes(group: str, c: int, signed: bool, scalar_bits: int = 255) -> int:
    """Size of the bucket accumulator grid for a window config."""
    if signed:
        K = -(-(scalar_bits + 1) // c)
        nb = 1 << (c - 1)
    else:
        K = -(-scalar_bits // c)
        nb = 1 << c
    return K * nb * _ROW_BYTES[group]


def msm_config(group: str, n: int, scalar_bits: int = 255) -> MSMConfig:
    """Window config for an n-point MSM over `group` ("g1"|"g2")."""
    assert group in ("g1", "g2"), group
    if n < SMALL_N:
        cfg = MSMConfig(c=8, signed=False)
    elif group == "g1":
        cfg = MSMConfig(c=16, signed=True, engine="balanced")
    else:
        cfg = MSMConfig(c=12, signed=True, engine="balanced")
    assert (
        grid_bytes(group, cfg.c, cfg.signed, scalar_bits)
        <= BUCKET_GRID_BYTES_CAP
    ), f"bucket grid for {group} c={cfg.c} exceeds cap"
    return cfg
