"""CircomWrapper: embed a parsed circom circuit into our constraint system.

Port of `contangle_zkcp_tpu/circomx/wrapper.py` onto the port's
`r1cs.builder`.

Mirror of the reference's ark-circom-based wrapper
(nulltea/contangle-zkcp:circuits-ark/src/circom_wrapper.rs:35-115) and the
builder API of the missing fork (CircomBuilder push_variable/push_input,
a path dependency outside the reference's repository):

  * wires map to our variables: wire 0 -> ONE, public wires -> instance,
    the rest -> witness;
  * named signal assignment through the wire map ("push_variable" for
    witness-known signals, "push_input" for protocol arguments);
  * the circom constraints (A*B = C normal form) are enforced as-is
    ("verify_linear_combinations");
  * NOTE (preserved reference behavior): the committed CircomWrapper does
    NOT link the circom plaintext signals to the encryption circuit — the
    linking code is commented out at circom_wrapper.rs:106-112, so the
    composed statement only enforces the circom constraints next to the
    encryption constraints.

Witness generation: circuits whose wires are fully determined by the
pushed signals (e.g. DummyProperty) need no wasm execution.  For circuits
with intermediate wires (zkPhoto), a constraint-propagation solver with a
bit-decomposition hint runs; anything it cannot determine raises.  With
the circuit's compiled `.wasm` witness generator attached (`CircomConfig.
wasm`), the embedded interpreter (`wasm.py`) runs it instead.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..r1cs.builder import LC, ConstraintSystem
from ..r1cs.gadgets import Gadgets
from ..utils.errors import ProofError
from .r1cs_format import R1csFile


@dataclass
class CircomConfig:
    r1cs: R1csFile
    signal_map: dict  # name -> wire id or (start, len)
    sanity_check: bool = False
    wasm: bytes | None = None  # compiled witness generator, if available


class CircomBuilder:
    def __init__(self, cfg: CircomConfig):
        self.cfg = cfg
        self.assignments = {0: 1}  # wire -> value
        self.inputs = {}  # name -> [values], for the wasm calculator

    def push_variable(self, name: str, values):
        """Assign a (vector) signal from known witness data."""
        self._assign(name, values)

    def push_input(self, name: str, value):
        """Assign a protocol argument signal."""
        self._assign(name, value)

    def _assign(self, name, values):
        self.inputs[name] = (
            list(values) if isinstance(values, (list, tuple)) else [values]
        )
        loc = self.cfg.signal_map[name]
        prime = self.cfg.r1cs.prime
        if isinstance(loc, tuple):
            start, length = loc
            vals = list(values)
            if len(vals) > length:
                raise ProofError(f"too many values for signal {name}")
            for i in range(length):
                self.assignments[start + i] = (
                    vals[i] % prime if i < len(vals) else 0
                )
        else:
            self.assignments[loc] = int(values) % prime

    def solve_witness(self):
        """Fill remaining wires.  With a compiled `.wasm` witness
        generator attached (cfg.wasm), run it through the embedded
        interpreter — the path the reference takes via wasmer inside its
        ark-circom fork.  Otherwise fall back to single-unknown
        constraint propagation (handles nonlinear intermediates —
        products, squares) plus a bit-decomposition hint solver for the
        Num2Bits pattern."""
        if self.cfg.wasm is not None:
            return self._solve_witness_wasm()
        r1 = self.cfg.r1cs
        prime = r1.prime
        wires = dict(self.assignments)
        pending = list(r1.constraints)
        booleans = self._boolean_wires(r1.constraints, prime)
        while pending:
            progress = False
            rest = []
            for (a, b, c) in pending:
                solved = self._try_solve(a, b, c, wires, prime)
                if solved:
                    progress = True
                else:
                    rest.append((a, b, c))
            pending = rest
            if not progress and pending:
                if not self._try_bit_decomp(pending, wires, prime, booleans):
                    break
        missing = [w for w in range(r1.n_wires) if w not in wires]
        if missing:
            raise ProofError(
                f"cannot determine wires {missing[:5]}... (constraint "
                "propagation + bit-decomposition hints exhausted; the "
                "circuit needs its wasm witness generator)"
            )
        if self.cfg.sanity_check:
            for a, b, c in r1.constraints:
                av = sum(co * wires[w] for w, co in a.items()) % prime
                bv = sum(co * wires[w] for w, co in b.items()) % prime
                cv = sum(co * wires[w] for w, co in c.items()) % prime
                if av * bv % prime != cv:
                    raise ProofError("circom constraint unsatisfied")
        return [wires[w] for w in range(r1.n_wires)]

    def _solve_witness_wasm(self):
        from .witness_calc import WitnessCalculator

        r1 = self.cfg.r1cs
        calc = WitnessCalculator(
            self.cfg.wasm, sanity_check=self.cfg.sanity_check
        )
        if calc.prime != r1.prime:
            raise ProofError(
                "wasm witness generator prime differs from the r1cs prime"
            )
        wit = calc.calculate_witness(self.inputs)
        if len(wit) < r1.n_wires:
            raise ProofError(
                f"wasm witness has {len(wit)} wires, r1cs wants {r1.n_wires}"
            )
        # wires assigned directly (push_variable) must agree with the
        # generator's output — the fork's witness-sharing semantics
        for w, v in self.assignments.items():
            if wit[w] % r1.prime != v % r1.prime:
                raise ProofError(f"wasm witness disagrees at wire {w}")
        return [v % r1.prime for v in wit[: r1.n_wires]]

    @staticmethod
    def _boolean_wires(constraints, prime):
        """Wires w with a booleanity constraint w*(w-1) = 0 (either
        polarity circom emits: (w)(w-1)=0 or (1-w)(w)=0 etc.)."""
        out = set()
        for a, b, c in constraints:
            if any(co % prime for co in c.values()):
                continue
            aw = {w for w in a if w != 0}
            bw = {w for w in b if w != 0}
            if len(aw) == 1 and aw == bw:
                out.add(next(iter(aw)))
        return out

    @staticmethod
    def _try_bit_decomp(pending, wires, prime, booleans):
        """Num2Bits hint: a stalled constraint A*B = C where A and B are
        fully known and C's unknowns are boolean wires with distinct
        (same-sign) power-of-two coefficients — read the bits straight
        off the known value, as the circuit's wasm generator would.
        Covers circom's linear normal form (A = B = empty, equation in C)
        and the (L)(const) variants alike."""

        def value_of(terms):
            tot = 0
            for w, co in terms.items():
                if w == 0 or w in wires:
                    tot = (tot + co * wires.get(w, 1)) % prime
                else:
                    return None
            return tot

        for a, b, c in pending:
            av = value_of(a)
            bv = value_of(b)
            if av is None or bv is None:
                continue
            target = av * bv % prime
            known = 0
            unk = []
            for w, co in c.items():
                if w == 0 or w in wires:
                    known = (known + co * wires.get(w, 1)) % prime
                else:
                    unk.append((w, co))
            if not unk or any(w not in booleans for w, _ in unk):
                continue
            residual = (target - known) % prime
            powers = {}
            ok = True
            negs = 0
            for w, co in unk:
                v = co % prime
                neg = v.bit_length() > prime.bit_length() - 2
                if neg:
                    v = prime - v
                    negs += 1
                if v == 0 or v & (v - 1):
                    ok = False
                    break
                powers[w] = v.bit_length() - 1
            if not ok or len(set(powers.values())) != len(powers):
                continue
            if negs and negs != len(unk):
                continue  # mixed-sign decomposition unsupported
            if negs:
                residual = (-residual) % prime
            if residual.bit_length() > max(powers.values()) + 1:
                continue
            if sum(((residual >> e) & 1) << e for e in powers.values()) != residual:
                continue  # residual has bits outside the given positions
            for w, e in powers.items():
                wires[w] = (residual >> e) & 1
            return True
        return False

    @staticmethod
    def _try_solve(a, b, c, wires, prime):
        """Solve constraints with exactly one unknown appearing linearly."""

        def ev(terms):
            tot, unknown = 0, None
            for w, co in terms.items():
                if w in wires:
                    tot = (tot + co * wires[w]) % prime
                elif unknown is None:
                    unknown = (w, co)
                else:
                    return None, "many"
            return tot, unknown

        av, au = ev(a)
        bv, bu = ev(b)
        cv, cu = ev(c)
        if "many" in (au, bu, cu):
            return False
        unknowns = [u for u in (au, bu, cu) if u is not None]
        if not unknowns:
            return True  # fully determined; nothing to solve
        if len(unknowns) > 1:
            return False
        w, co = unknowns[0]
        if cu is not None:
            # a*b = cv + co*w  ->  w = (a*b - cv)/co
            val = (av * bv - cv) % prime * pow(co, -1, prime) % prime
        elif au is not None:
            if bv == 0:
                return False
            # (av + co*w)*bv = cv
            val = (cv * pow(bv, -1, prime) - av) % prime * pow(co, -1, prime) % prime
        else:
            if av == 0:
                return False
            val = (cv * pow(av, -1, prime) - bv) % prime * pow(co, -1, prime) % prime
        wires[w] = val
        return True


class CircomCircuit:
    """Embeds the circom constraints into a ConstraintSystem."""

    def __init__(self, cfg: CircomConfig, witness):
        self.cfg = cfg
        self.witness = witness  # full wire assignment

    def allocate(self, cs: ConstraintSystem):
        """Allocate wires as variables; returns wire -> LC map."""
        r1 = self.cfg.r1cs
        var = {0: cs.constant(1)}
        n_pub = r1.n_public
        for w in range(1, r1.n_wires):
            if w <= n_pub:
                var[w] = cs.lc(cs.new_input(self.witness[w]))
            else:
                var[w] = cs.lc(cs.new_witness(self.witness[w]))
        return var

    def enforce(self, cs: ConstraintSystem, var):
        """verify_linear_combinations: emit A*B = C for every constraint."""
        g = Gadgets(cs)
        for a, b, c in self.cfg.r1cs.constraints:
            a_lc = _combine(cs, var, a)
            b_lc = _combine(cs, var, b)
            c_lc = _combine(cs, var, c)
            cs.enforce(a_lc, b_lc, c_lc)

    def public_inputs(self):
        return [self.witness[w] for w in range(1, self.cfg.r1cs.n_public + 1)]


def _combine(cs: ConstraintSystem, var, terms) -> LC:
    out = cs.constant(0)
    for w, co in terms.items():
        out = out + var[w] * co
    return out
