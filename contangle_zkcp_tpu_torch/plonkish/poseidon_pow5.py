"""Poseidon for the halo2 pipeline: x^5 s-box, width 3, rate 2,
8 full + 56 partial rounds over the Pallas base field (the P128Pow5T3
instance shape used by the reference's ElGamalChip,
circuits-halo2/src/encryption.rs:83-161).

Constants are generated with halo2_gadgets' exact Grain-LFSR procedure
(primitives/poseidon/{grain,mds}.rs, itself derived from the Poseidon
reference generate_parameters_grain.sage): 80-bit LFSR seeded with
(field=prime tag 0b01, sbox=x^alpha tag 0b0000, n, t, R_F, R_P, thirty
1-bits), 160 warm-up bits, von-Neumann-filtered output bits interpreted
MSB-first; round constants by REJECTION sampling; MDS as a Cauchy matrix
M[i][j] = 1/(x_i + y_j) over 2T jointly-distinct NON-rejection samples
(value = 255 LFSR bits reduced mod p — halo2's
`next_field_element_without_rejection`), with a `secure_mds` skip
counter (0 for the published P128Pow5T3 instance).

Port of `contangle_zkcp_tpu/plonkish/poseidon_pow5.py` (host code, copied
as is), with its own copy of `pow5_pinned_pasta.json`.

Validation status: the generated P128Pow5T3 tables for the Pallas base
field are pinned in `pow5_pinned_pasta.json` and a test regenerates and
compares them (drift detection).  halo2_gadgets'
hard-coded fp.rs byte tables are not available in this image (no crates
on disk, no egress), so byte-equality with the upstream crate rests on
this being a faithful transcription of its documented algorithm; every
divergence we know of between the sage reference and halo2 (MDS
non-rejection sampling, joint 2T uniqueness, MSB-first bit packing) is
reproduced here.  Reference consumer:
circuits-halo2/src/encryption.rs:83-161.
"""

from __future__ import annotations

from functools import lru_cache

from ..fields import instances as fi

T = 3
RATE = 2
ALPHA = 5
R_F = 8
R_P = 56


class Grain:
    def __init__(self, p: int, t: int = T, r_f: int = R_F, r_p: int = R_P):
        self.p = p
        self.n = p.bit_length()
        bits = []

        def push(value, width):
            for i in range(width - 1, -1, -1):
                bits.append((value >> i) & 1)

        push(1, 2)       # field: prime
        push(0, 4)       # sbox: x^alpha
        push(self.n, 12)
        push(t, 12)
        push(r_f, 10)
        push(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_bit(self) -> int:
        # von Neumann-style filtering: emit the 2nd bit of a pair only when
        # the 1st is set
        while True:
            b1 = self._next_raw()
            b2 = self._next_raw()
            if b1:
                return b2

    def next_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.next_bit()
        return v

    def next_field_element(self) -> int:
        """Rejection sampling, MSB-first (halo2 `next_field_element`)."""
        while True:
            v = self.next_bits(self.n)
            if v < self.p:
                return v

    def next_field_element_without_rejection(self) -> int:
        """MSB-first n-bit value reduced mod p (halo2
        `next_field_element_without_rejection`, used only for MDS)."""
        return self.next_bits(self.n) % self.p


@lru_cache(maxsize=None)
def pow5_constants(p: int, secure_mds: int = 0):
    """(round_constants [(R_F+R_P) x T], mds [T x T]) — halo2_gadgets'
    `generate_constants` + `generate_mds` procedure, exactly."""
    g = Grain(p)
    rc = [[g.next_field_element() for _ in range(T)] for _ in range(R_F + R_P)]
    # MDS (halo2 mds.rs): sample 2T elements WITHOUT rejection until all
    # 2T are jointly distinct; skip `secure_mds` accepted candidates
    # (0 for the published P128Pow5T3 tables); Cauchy matrix, asserting
    # (not resampling) x_i + y_j != 0.
    select = secure_mds
    while True:
        vals = [g.next_field_element_without_rejection() for _ in range(2 * T)]
        if len(set(vals)) != 2 * T:
            continue
        if select != 0:
            select -= 1
            continue
        xs, ys = vals[:T], vals[T:]
        break
    assert all((x + y) % p != 0 for x in xs for y in ys)
    mds = [[pow((xs[i] + ys[j]) % p, -1, p) for j in range(T)] for i in range(T)]
    return rc, mds


class PoseidonPow5Host:
    """Exact host permutation + the halo2 `ConstantLength<2>` hash."""

    def __init__(self, p: int = None):
        self.p = p or fi.PASTA_P
        self.rc, self.mds = pow5_constants(self.p)

    def permute(self, state):
        p = self.p
        s = list(state)
        half = R_F // 2
        for r in range(R_F + R_P):
            s = [(x + self.rc[r][i]) % p for i, x in enumerate(s)]
            full = r < half or r >= half + R_P
            if full:
                s = [pow(x, ALPHA, p) for x in s]
            else:
                s[0] = pow(s[0], ALPHA, p)
            s = [
                sum(self.mds[i][j] * s[j] for j in range(T)) % p for i in range(T)
            ]
        return s

    def hash2(self, a: int, b: int) -> int:
        """halo2 Hash<ConstantLength<2>>: initial capacity element encodes
        the domain (ConstantLength: capacity = 2^64 * ... simplified to the
        length tag), absorb [a, b], squeeze 1."""
        cap = (2 << 64) % self.p  # length-2 domain tag, halo2-style
        state = [a % self.p, b % self.p, cap]
        return self.permute(state)[0]
