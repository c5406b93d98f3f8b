"""MockProver — the halo2 `MockProver` equivalent.

Port of `contangle_zkcp_tpu/plonkish/mock.py` (host code, copied as is).

The reference's halo2 circuit is exercised *only* through MockProver
(circuits-halo2/src/encryption.rs:306-338, SURVEY.md §3.5):
every gate polynomial is evaluated on every row, copy constraints and
instance bindings are checked exactly.  Same role here: a cheap exact
checker run before (or instead of) the real IPA prover.
"""

from __future__ import annotations

from .circuit import Assignment, CircuitMeta


class VerifyFailure(Exception):
    pass


class MockProver:
    def __init__(self, meta: CircuitMeta, assignment: Assignment, instances):
        self.meta = meta
        self.assignment = assignment
        self.instances = [list(col) for col in instances]

    @staticmethod
    def run(meta: CircuitMeta, circuit, n_rows: int, instances):
        """circuit: object with synthesize(meta, assignment) filling tables."""
        asg = Assignment(meta, n_rows)
        circuit.synthesize(meta, asg)
        return MockProver(meta, asg, instances)

    def verify(self, raise_on_failure: bool = False):
        p = self.meta.p
        asg = self.assignment
        inst = [
            col + [0] * (asg.n - len(col)) for col in self.instances
        ]
        tables = {"advice": asg.advice, "fixed": asg.fixed, "instance": inst}
        failures = []
        for gate in self.meta.gates:
            for gi, poly in enumerate(gate.polys):
                for row in range(asg.n):
                    if poly.eval(row, tables, p) != 0:
                        failures.append(
                            f"gate '{gate.name}'[{gi}] unsatisfied at row {row}"
                        )
                        break
        for (ak, ai, ar), (bk, bi, br) in asg.copies:
            if tables[ak][ai][ar] != tables[bk][bi][br]:
                failures.append(f"copy constraint {ak}[{ai}][{ar}] != {bk}[{bi}][{br}]")
        for (ck, ci, cr), icol, irow in asg.instance_cells:
            if tables[ck][ci][cr] != inst[icol][irow]:
                failures.append(
                    f"instance binding {ck}[{ci}][{cr}] != instance[{icol}][{irow}]"
                )
        # lookup arguments: every row's input tuple must appear in the table
        for lk in self.meta.lookups:
            table_rows = set()
            for row in range(asg.n):
                table_rows.add(
                    tuple(tab.eval(row, tables, p) for _, tab in lk.pairs)
                )
            for row in range(asg.n):
                tup = tuple(inp.eval(row, tables, p) for inp, _ in lk.pairs)
                if tup not in table_rows:
                    failures.append(
                        f"lookup '{lk.name}' unsatisfied at row {row}: {tup}"
                    )
                    break
        if failures and raise_on_failure:
            raise VerifyFailure("; ".join(failures[:5]))
        return failures
