"""Multilinear sumcheck (prover + verifier) over a prime field (torch port).

Port of `contangle_zkcp_tpu/groth16/sumcheck.py`, the engine under the
folding decider (groth16/decider.py): proves claims of the form
sum_{t in {0,1}^s} g(t) = claimed, where g is a low-degree combination of
multilinear polynomials given by their evaluation tables on the cube.
The verifier does s rounds of degree-d univariate checks instead of
re-evaluating the cube.

  * the prover keeps each multilinear factor as a dense evaluation table
    and folds it each round (tbl[t] <- tbl[0,t] + r*(tbl[1,t] - tbl[0,t])),
    O(total) work across all rounds;
  * `g` is supplied as (tables, combine), where combine maps one row of
    per-table values to g's value: the decider's outer sumcheck (degree 3:
    eq * (az*bz - u*cz - e)) and its inner one (degree 2: mat * z);
  * each round sends g's evaluations at X = 0..deg on the half-cube; the
    verifier checks p(0) + p(1) = previous claim and evaluates p(r) by
    Lagrange interpolation at the challenge;
  * Fiat-Shamir rides the caller's transcript (absorb/squeeze), so the
    decider binds sumcheck messages and commitment openings in one
    transcript.

Exact host integers throughout, as in the reference: the cube folds are
O(n) Python integer operations, fine at accumulator scale; the prover's
group work (the IPA MSMs) is elsewhere.
"""

from __future__ import annotations


def _lagrange_at(p: int, evals, r: int) -> int:
    """Evaluate the degree-(len-1) polynomial given by evals at points
    0..len-1, at r (standard Lagrange, exact mod p)."""
    d = len(evals) - 1
    acc = 0
    for j, yj in enumerate(evals):
        num = 1
        den = 1
        for k in range(d + 1):
            if k == j:
                continue
            num = num * ((r - k) % p) % p
            den = den * ((j - k) % p) % p
        acc = (acc + yj * num % p * pow(den, -1, p)) % p
    return acc


class SumcheckProver:
    """One sumcheck run over s variables.

    tables: list of dense evaluation tables (lists of length 2^s),
    consumed destructively (copies are made).
    combine(vals) -> int: g's value from one row of table values.
    degree: max degree of g in each variable (d+1 evals sent/round).
    """

    def __init__(self, p: int, tables, combine, degree: int):
        self.p = p
        self.tables = [list(t) for t in tables]
        n = len(self.tables[0])
        assert all(len(t) == n for t in self.tables) and n & (n - 1) == 0
        self.s = n.bit_length() - 1
        self.combine = combine
        self.degree = degree

    def round_poly(self):
        """Evaluations of this round's univariate at X = 0..degree.

        Variable order: the FIRST remaining variable is bound each
        round; tables are split as t = [X, rest] with X the low half
        index (table[x * half + rest])."""
        p = self.p
        half = len(self.tables[0]) // 2
        evals = []
        for x in range(self.degree + 1):
            tot = 0
            for rest in range(half):
                vals = []
                for t in self.tables:
                    lo = t[rest]
                    hi = t[half + rest]
                    vals.append((lo + x * ((hi - lo) % p)) % p)
                tot = (tot + self.combine(vals)) % p
            evals.append(tot)
        return evals

    def bind(self, r: int):
        """Fix the current variable to r; tables halve."""
        p = self.p
        half = len(self.tables[0]) // 2
        for i, t in enumerate(self.tables):
            self.tables[i] = [
                (t[rest] + r * ((t[half + rest] - t[rest]) % p)) % p
                for rest in range(half)
            ]

    def final_values(self):
        """Per-table values after all s variables are bound."""
        assert len(self.tables[0]) == 1
        return [t[0] for t in self.tables]


def prove(p, tables, combine, degree, claimed, transcript):
    """Run the full sumcheck; returns (round_polys, challenges, finals).

    transcript must expose absorb_scalars(list[int]) and
    squeeze_scalar() -> int (decider supplies a Blake2b-based one)."""
    pr = SumcheckProver(p, tables, combine, degree)
    polys = []
    rs = []
    for _ in range(pr.s):
        ev = pr.round_poly()
        assert (ev[0] + ev[1]) % p == claimed % p, "sumcheck invariant"
        transcript.absorb_scalars(ev)
        r = transcript.squeeze_scalar()
        pr.bind(r)
        claimed = _lagrange_at(p, ev, r)
        polys.append(ev)
        rs.append(r)
    return polys, rs, pr.final_values(), claimed


def verify(p, claimed, degree, s, round_polys, transcript):
    """Replay the rounds; returns (challenges, final_claim) or raises."""
    rs = []
    for ev in round_polys:
        if len(ev) != degree + 1:
            raise ValueError("bad round poly width")
        if (ev[0] + ev[1]) % p != claimed % p:
            raise ValueError("sumcheck round check failed")
        transcript.absorb_scalars(ev)
        r = transcript.squeeze_scalar()
        claimed = _lagrange_at(p, ev, r)
        rs.append(r)
    if len(rs) != s:
        raise ValueError("bad round count")
    return rs, claimed


def eq_table(p: int, taus) -> list:
    """Dense eq(tau, .) table over the cube: tensor-product build,
    low variable = FIRST tau (matches SumcheckProver's bind order)."""
    out = [1]
    for tau in reversed(taus):
        nxt = [0] * (2 * len(out))
        for i, v in enumerate(out):
            nxt[i] = v * ((1 - tau) % p) % p
            nxt[len(out) + i] = v * tau % p
        out = nxt
    return out


def eq_point(p: int, a, b) -> int:
    """eq(a, b) = prod (a_i b_i + (1-a_i)(1-b_i))."""
    acc = 1
    for x, y in zip(a, b):
        acc = acc * ((x * y + (1 - x) * (1 - y)) % p) % p
    return acc
