"""PLONKish circuit framework (halo2-equivalent core).

Port of `contangle_zkcp_tpu/plonkish/circuit.py` (host code, copied as
is).  The halo2_proofs 0.2 circuit model the reference's
`circuits-halo2` crate uses (circuits-halo2/src/
encryption.rs:41-162): advice/fixed/instance columns, selectors, custom
gates as polynomial identities over column references with rotations, and
equality (copy) constraints.  The region/floor-planner indirection is
replaced by direct row assignment — the reference circuit uses a single
SimpleFloorPlanner region anyway.

The assignment produces dense column tables; gate checking (mock.py) and
the IPA-backed prover evaluate those tables vectorized — column-major
arrays are exactly the layout the batched field pipeline wants.
"""

from __future__ import annotations

from dataclasses import dataclass, field


# ------------------------------------------------------------- expressions
@dataclass(frozen=True)
class ColumnRef:
    kind: str  # "advice" | "fixed" | "instance"
    index: int
    rotation: int = 0

    def at(self, rotation: int) -> "ColumnRef":
        return ColumnRef(self.kind, self.index, rotation)


class Expr:
    """Polynomial expression AST over column references."""

    def __init__(self, node):
        self.node = node  # ("col", ColumnRef) | ("const", int) |
        #                   ("add"|"mul", Expr, Expr) | ("neg", Expr)

    @staticmethod
    def col(c: ColumnRef) -> "Expr":
        return Expr(("col", c))

    @staticmethod
    def const(v: int) -> "Expr":
        return Expr(("const", v))

    def __add__(self, o):
        return Expr(("add", self, _e(o)))

    __radd__ = __add__

    def __mul__(self, o):
        return Expr(("mul", self, _e(o)))

    __rmul__ = __mul__

    def __sub__(self, o):
        return self + Expr(("neg", _e(o)))

    def __neg__(self):
        return Expr(("neg", self))

    def eval(self, row: int, tables, p: int, rot_scale: int = 1) -> int:
        """Evaluate at one row; `rot_scale` maps a 1-row rotation to a
        stride on an extended evaluation domain (prover quotient path)."""
        k = self.node[0]
        if k == "col":
            c = self.node[1]
            col = tables[c.kind][c.index]
            return col[(row + c.rotation * rot_scale) % len(col)]
        if k == "const":
            return self.node[1] % p
        if k == "add":
            return (
                self.node[1].eval(row, tables, p, rot_scale)
                + self.node[2].eval(row, tables, p, rot_scale)
            ) % p
        if k == "mul":
            return (
                self.node[1].eval(row, tables, p, rot_scale)
                * self.node[2].eval(row, tables, p, rot_scale)
            ) % p
        if k == "neg":
            return (-self.node[1].eval(row, tables, p, rot_scale)) % p
        raise ValueError(k)

    def eval_vec(self, tables, p: int, n: int, rot_scale: int = 1):
        """Evaluate on all rows of tables (lists of length n)."""
        return [self.eval(i, tables, p, rot_scale) for i in range(n)]

    def max_degree(self) -> int:
        k = self.node[0]
        if k == "col":
            return 1
        if k == "const":
            return 0
        if k == "add":
            return max(self.node[1].max_degree(), self.node[2].max_degree())
        if k == "mul":
            return self.node[1].max_degree() + self.node[2].max_degree()
        if k == "neg":
            return self.node[1].max_degree()
        raise ValueError(k)


def _e(o):
    if isinstance(o, Expr):
        return o
    return Expr.const(int(o))


# ------------------------------------------------------------------- meta
@dataclass
class Gate:
    name: str
    polys: list  # list[Expr]; each must evaluate to 0 on every row


@dataclass
class Lookup:
    """halo2-style lookup argument: on every row, the tuple of input
    expressions must appear (as a tuple) in some row of the table
    expressions (halo2_proofs 0.2 `meta.lookup`; used by the reference's
    `LookupRangeCheckConfig`, circuits-halo2/src/encryption.rs:94-99)."""

    name: str
    pairs: list  # list[(input Expr, table Expr)]


@dataclass
class CircuitMeta:
    p: int
    n_advice: int = 0
    n_fixed: int = 0
    n_instance: int = 0
    gates: list = field(default_factory=list)
    lookups: list = field(default_factory=list)

    def advice_column(self) -> ColumnRef:
        self.n_advice += 1
        return ColumnRef("advice", self.n_advice - 1)

    def fixed_column(self) -> ColumnRef:
        self.n_fixed += 1
        return ColumnRef("fixed", self.n_fixed - 1)

    def instance_column(self) -> ColumnRef:
        self.n_instance += 1
        return ColumnRef("instance", self.n_instance - 1)

    def selector(self) -> ColumnRef:
        # selectors are fixed 0/1 columns
        return self.fixed_column()

    def create_gate(self, name: str, polys):
        self.gates.append(Gate(name, list(polys)))

    def lookup(self, name: str, pairs):
        self.lookups.append(Lookup(name, list(pairs)))


# -------------------------------------------------------------- assignment
class Assignment:
    """Dense column tables + copy constraints for k rows (n = 2^k)."""

    def __init__(self, meta: CircuitMeta, n_rows: int):
        self.meta = meta
        self.n = n_rows
        self.advice = [[0] * n_rows for _ in range(meta.n_advice)]
        self.fixed = [[0] * n_rows for _ in range(meta.n_fixed)]
        self.copies = []  # ((kind, col, row), (kind, col, row))
        self.instance_cells = []  # ((col_kind_cell), instance_col, instance_row)

    def assign(self, col: ColumnRef, row: int, value: int):
        table = getattr(self, col.kind)
        table[col.index][row] = value % self.meta.p

    def get(self, col: ColumnRef, row: int) -> int:
        return getattr(self, col.kind)[col.index][row]

    def enable(self, selector: ColumnRef, row: int):
        self.fixed[selector.index][row] = 1

    def copy(self, a: ColumnRef, arow: int, b: ColumnRef, brow: int):
        """Equality (permutation-argument) constraint between two cells."""
        self.copies.append(((a.kind, a.index, arow), (b.kind, b.index, brow)))

    def constrain_instance(self, col: ColumnRef, row: int, icol: ColumnRef, irow: int):
        """Expose an advice cell as a public-input cell."""
        self.instance_cells.append(((col.kind, col.index, row), icol.index, irow))
