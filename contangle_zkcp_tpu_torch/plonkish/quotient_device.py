"""Device-batched PLONK quotient assembly (torch).

Port of `contangle_zkcp_tpu/plonkish/quotient_device.py`.  The whole
extended-coset quotient is evaluated as batched limb operations over the
Pasta Montgomery field engine (fields/fp.py) on `(size, L)` column
tables, size = ext * n:

  * every gate polynomial AST (plonkish/circuit.py Expr) becomes a chain
    of `F.add` / `F.mul` / `F.neg` over the column tables; rotations are
    `torch.roll`s on the leading axis (the extended domain is cyclic), so
    the whole identity is elementwise — no gathers;
  * the permutation transition, L0 boundary terms and the 4 lookup
    terms mirror prover.py's host loop term for term;
  * alpha/beta/gamma/theta enter as Montgomery scalars broadcast over the
    batch; the domain vectors (xi, L0, 1/Z_H) are computed once per
    system on the host.

The reference compiles the sweep into one XLA program; here it runs
eagerly, and every multiply over the extended domain is one launch of
kernel K1 (Pasta Fp, W = 8) on the card.  The values are the host path's
exactly (`PlonkSystem._quotient_host`), so the two are interchangeable.
"""

from __future__ import annotations

import torch

from ..fields import instances as fi

P = fi.PASTA_P
GEN = 5


class QuotientDevice:
    """Quotient assembler for one PlonkSystem structure, on `device`."""

    def __init__(self, meta, perm_cols, deltas, n: int, ext: int, device="cuda"):
        self.F = fi.pasta_fp()
        self.meta = meta
        self.perm_cols = perm_cols
        self.deltas = deltas
        self.n = n
        self.ext = ext
        self.device = torch.device(device)
        size = n * ext
        self.size = size
        F = self.F
        w_ext = fi.root_of_unity(P, size)
        xi = [GEN * pow(w_ext, i, P) % P for i in range(size)]
        gnp = pow(GEN, n, P)
        zh = [
            (gnp * pow(w_ext, (i * n) % size, P) - 1) % P for i in range(size)
        ]
        ninv = pow(n, -1, P)
        l0 = [
            zh[i] * ninv % P * pow((xi[i] - 1) % P, -1, P) % P
            for i in range(size)
        ]
        self.xi_d = F.encode(xi, device=self.device)
        self.zh_inv_d = F.encode([pow(v, -1, P) for v in zh], device=self.device)
        self.l0_d = F.encode(l0, device=self.device)

    # ------------------------------------------------------------ helpers
    def _scalar(self, v: int):
        """(L,) Montgomery scalar; F's operations broadcast it over rows."""
        return self.F.encode(v % P, device=self.device)

    def _expr(self, e, tables, rot_scale: int):
        """Expr AST -> batched device value over the extended domain."""
        F = self.F
        k = e.node[0]
        if k == "col":
            c = e.node[1]
            col = tables[c.kind][c.index]
            r = (c.rotation * rot_scale) % self.size
            return torch.roll(col, -r, dims=0) if r else col
        if k == "const":
            return self._scalar(e.node[1]).expand(self.size, F.L)
        if k == "add":
            return F.add(
                self._expr(e.node[1], tables, rot_scale),
                self._expr(e.node[2], tables, rot_scale),
            )
        if k == "mul":
            return F.mul(
                self._expr(e.node[1], tables, rot_scale),
                self._expr(e.node[2], tables, rot_scale),
            )
        if k == "neg":
            return F.neg(self._expr(e.node[1], tables, rot_scale))
        raise ValueError(k)

    # ----------------------------------------------------------- assemble
    def _assemble_impl(
        self,
        tables,  # {"advice"|"fixed"|"instance": [ (size, L) ... ]}
        sigma_ext,  # [ (size, L) ] per perm column
        z_ext,  # (size, L)
        lookup_ext,  # [ {"ap": .., "sp": .., "z": ..} ] per lookup
        theta,
        beta,
        gamma,
        alpha,  # (L,) Montgomery scalars
    ):
        F = self.F
        ext = self.ext
        size = self.size
        xi, l0, zh_inv = self.xi_d, self.l0_d, self.zh_inv_d
        one = F.one_mont((size,), device=self.device)
        q = F.zeros((size,), device=self.device)
        a_pow = self._scalar(1)  # running alpha^j scalar

        def acc(q, a_pow, vals):
            return F.add(q, F.mul(a_pow, vals))

        # ---- gates
        for gate in self.meta.gates:
            for poly in gate.polys:
                q = acc(q, a_pow, self._expr(poly, tables, ext))
                a_pow = F.mul(a_pow, alpha)

        # ---- permutation transition: Z(wX) prod(den) - Z(X) prod(num)
        bxi = F.mul(beta, xi)
        num = one
        den = one
        for j, (kind, i) in enumerate(self.perm_cols):
            v = tables[kind][i]
            dj = self._scalar(self.deltas[j])
            num = F.mul(num, F.add(v, F.add(F.mul(dj, bxi), gamma)))
            den = F.mul(den, F.add(v, F.add(F.mul(beta, sigma_ext[j]), gamma)))
        zw = torch.roll(z_ext, -ext, dims=0)
        term = F.sub(F.mul(zw, den), F.mul(z_ext, num))
        q = acc(q, a_pow, term)
        a_pow = F.mul(a_pow, alpha)
        # ---- L0 (Z - 1)
        q = acc(q, a_pow, F.mul(l0, F.sub(z_ext, one)))
        a_pow = F.mul(a_pow, alpha)

        # ---- lookups
        alpha2 = F.mul(alpha, alpha)
        alpha3 = F.mul(alpha2, alpha)
        alpha4 = F.mul(alpha3, alpha)
        for lk, d in zip(self.meta.lookups, lookup_ext):
            a_ext = F.zeros((size,), device=self.device)
            s_ext = F.zeros((size,), device=self.device)
            t_pow = self._scalar(1)
            for inp, tab in lk.pairs:
                iv = self._expr(inp, tables, ext)
                tv = self._expr(tab, tables, ext)
                a_ext = F.add(a_ext, F.mul(t_pow, iv))
                s_ext = F.add(s_ext, F.mul(t_pow, tv))
                t_pow = F.mul(t_pow, theta)
            ap, sp, zl = d["ap"], d["sp"], d["z"]
            zlw = torch.roll(zl, -ext, dims=0)
            # 1) L0 (Z - 1)
            q = acc(q, a_pow, F.mul(l0, F.sub(zl, one)))
            # 2) Z(wX)(A'+beta)(S'+gamma) - Z(X)(A+beta)(S+gamma)
            t2 = F.sub(
                F.mul(zlw, F.mul(F.add(ap, beta), F.add(sp, gamma))),
                F.mul(zl, F.mul(F.add(a_ext, beta), F.add(s_ext, gamma))),
            )
            q = acc(q, F.mul(a_pow, alpha), t2)
            # 3) (A' - S') (A'(X) - A'(w^-1 X))
            ap_prev = torch.roll(ap, ext, dims=0)
            t3 = F.mul(F.sub(ap, sp), F.sub(ap, ap_prev))
            q = acc(q, F.mul(a_pow, alpha2), t3)
            # 4) L0 (A' - S')
            q = acc(q, F.mul(a_pow, alpha3), F.mul(l0, F.sub(ap, sp)))
            a_pow = F.mul(a_pow, alpha4)

        return F.mul(q, zh_inv)

    def assemble(
        self, tables, sigma_ext, z_ext, lookup_ext, theta, beta, gamma, alpha
    ):
        """Encoded extended tables + host challenge ints -> t_evals ints."""
        out = self._assemble_impl(
            tables,
            sigma_ext,
            z_ext,
            lookup_ext,
            self._scalar(theta),
            self._scalar(beta),
            self._scalar(gamma),
            self._scalar(alpha),
        )
        return self.F.decode(out)
