"""PLONKish prover/verifier with IPA commitments over the Pasta curves.

Port of `contangle_zkcp_tpu/plonkish/prover.py`: the halo2 pipeline's
real proving backend — a PLONK vanishing argument over a radix-2 domain,
halo2-style permutation argument for the copy constraints (single grand
product), halo2-style lookup arguments (permuted input/table columns +
grand product), quotient split into degree-n chunks, halo2's Blake2b
Fiat-Shamir transcript (plonkish/transcript.py), and an IPA multiopen at
{x, wx} plus w^-1 x when lookups are present.  Keys and proofs are host
ints, equal to the reference's field for field for the same blinding
`rng` (plonkish/convert.py carries them across).

Zero knowledge: every committed witness polynomial — advice,
permutation/lookup grand products, permuted lookup columns — is blinded
with a uniformly random multiple of the vanishing polynomial,
c'(X) = c(X) + rho(X) * (X^n - 1), deg(rho) < B.  Evaluations on the
domain are unchanged, so every identity and the quotient pipeline work
verbatim, while commitments and the revealed off-domain evaluations are
randomized (B = 4 covers the commitment plus three evaluation points).
The IPA basis is sized 2n to hold the extra B coefficients.

Work placement, on `device` (default "cuda"): every domain transform
(iNTT of columns, coset evaluation on the extended domain, quotient
interpolation) is the port's NTT over Pasta Fp, a transform in two
launches of kernel K2 (k2_ntt_pass); with `use_device=True` the commitment MSMs and the IPA
generator fold run on the device (plonkish/ipa.py, kernel K3 over Vesta)
and the quotient is assembled there (plonkish/quotient_device.py, kernel
K1 over Pasta Fp); otherwise both are exact host arithmetic.  The
grand products, evaluations and the multiopen combination are host
arithmetic, as in the reference.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import torch

from ..fields import instances as fi
from ..ops.ntt import NTT
from ..utils import metrics
from .circuit import Assignment, CircuitMeta
from .ipa import CURVE, IPA, IpaProof
from .transcript import Blake2bTranscript

P = fi.PASTA_P
GEN = 5  # multiplicative generator of F_p (coset shift + coset deltas)
BLIND = 4  # blinding coefficients per committed witness polynomial


# ----------------------------------------------------------- poly helpers
_NTTS = {}


def _ntt(n: int, device) -> NTT:
    key = (n, str(torch.device(device)))
    if key not in _NTTS:
        _NTTS[key] = NTT(fi.pasta_fp(), n, device=device)
    return _NTTS[key]


def _coeffs_from_evals(evals, device):
    n = len(evals)
    F = fi.pasta_fp()
    return F.decode(_ntt(n, device).inverse(F.encode(list(evals), device=device)))


def _evals_on_coset(coeffs, size: int, device):
    return fi.pasta_fp().decode(_evals_on_coset_enc(coeffs, size, device))


def _evals_on_coset_enc(coeffs, size: int, device):
    """Same, but stays on the device (Montgomery limb tensor) — feeds
    the device quotient assembler without a decode/encode round-trip."""
    F = fi.pasta_fp()
    padded = list(coeffs) + [0] * (size - len(coeffs))
    return _ntt(size, device).coset_forward(F.encode(padded, device=device), GEN)


def _coeffs_from_coset(evals, device):
    F = fi.pasta_fp()
    return F.decode(
        _ntt(len(evals), device).coset_inverse(F.encode(list(evals), device=device), GEN)
    )


def _eval_at(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


# ------------------------------------------------------------------ keys
@dataclass
class PlonkVK:
    n: int
    ext: int
    fixed_comms: list
    sigma_comms: list
    perm_cols: list  # [(kind, index)]
    deltas: list


@dataclass
class PlonkPK:
    vk: PlonkVK
    fixed_polys: list
    sigma_polys: list
    sigma_evals: list  # on the base domain, row-major per column


@dataclass
class PlonkProof:
    advice_comms: list
    lookup_perm_comms: list  # [(A' comm, S' comm)] per lookup
    z_comm: tuple
    lookup_z_comms: list
    t_comms: list
    evals: dict  # name -> value(s)
    open_x: IpaProof
    open_wx: IpaProof
    open_wix: IpaProof | None  # at w^-1 x, present iff lookups


class PlonkSystem:
    def __init__(
        self,
        meta: CircuitMeta,
        n: int,
        structural: Assignment,
        use_device: bool = False,
        device="cuda",
    ):
        """`structural`: any synthesized assignment — its fixed columns,
        copies and instance bindings define the circuit structure;
        `device`: where the NTTs (and with `use_device` the MSMs, the IPA
        fold and the quotient) run."""
        assert n & (n - 1) == 0
        self.meta = meta
        self.n = n
        gate_deg = max(
            (poly.max_degree() for g in meta.gates for poly in g.polys), default=1
        )
        # permutation spans advice + instance columns
        self.perm_cols = [("advice", i) for i in range(meta.n_advice)] + [
            ("instance", i) for i in range(meta.n_instance)
        ]
        # lookup constraints have degree 3 (product terms); blinding adds
        # < 1 domain of degree slack, absorbed by the pow2 rounding margin
        need = max(gate_deg + 1, len(self.perm_cols) + 2, 4)
        ext = 2
        while ext < need:
            ext *= 2
        self.ext = ext
        # IPA basis 2n: committed polynomials carry BLIND extra coeffs
        self.device = torch.device(device)
        with metrics.timer("plonk.setup.ipa"):
            self.ipa = IPA(2 * n, use_device_msm=use_device, device=device)
        self.domain_w = fi.root_of_unity(P, n)
        self.use_device = use_device
        self._qdev = None  # lazy QuotientDevice (built once per structure)
        self._build_keys(structural)

    # ------------------------------------------------------------- setup
    def _build_keys(self, asg: Assignment):
        n = self.n
        m = len(self.perm_cols)
        deltas = [pow(GEN, j, P) for j in range(m)]
        with metrics.timer("plonk.setup.sigma"):  # host: copy cycles -> sigma evaluations
            # sigma as cell permutation from copy cycles
            cell_map = {
                (k, i, r): (k, i, r) for k, i in self.perm_cols for r in range(n)
            }
            pairs = list(asg.copies) + [
                (cell, ("instance", icol, irow))
                for cell, icol, irow in asg.instance_cells
            ]
            # union into cycles via successor-swapping (standard plonk trick)
            for a, b in pairs:
                ca, cb = cell_map[a], cell_map[b]
                cell_map[a], cell_map[b] = cb, ca
            w = self.domain_w
            ws = [pow(w, r, P) for r in range(n)]
            sigma_evals = []
            for k, i in self.perm_cols:
                col = []
                for r in range(n):
                    tk, ti, tr = cell_map[(k, i, r)]
                    j = self.perm_cols.index((tk, ti))
                    col.append(deltas[j] * ws[tr] % P)
                sigma_evals.append(col)
        with metrics.timer("plonk.setup.intt"):
            sigma_polys = [_coeffs_from_evals(c, self.device) for c in sigma_evals]
            fixed_polys = [_coeffs_from_evals(list(c), self.device) for c in asg.fixed]
        with metrics.timer("plonk.setup.commits"):
            fixed_comms = [self.ipa.commit(c) for c in fixed_polys]
            sigma_comms = [self.ipa.commit(c) for c in sigma_polys]
        vk = PlonkVK(
            n=n,
            ext=self.ext,
            fixed_comms=fixed_comms,
            sigma_comms=sigma_comms,
            perm_cols=self.perm_cols,
            deltas=deltas,
        )
        self.pk = PlonkPK(
            vk=vk,
            fixed_polys=fixed_polys,
            sigma_polys=sigma_polys,
            sigma_evals=sigma_evals,
        )

    # ---------------------------------------------------------- blinding
    def _blind(self, coeffs, rng=None):
        """c(X) + rho(X) * (X^n - 1), deg(rho) < BLIND: domain evals
        unchanged, commitment + off-domain evals randomized."""
        n = self.n
        out = list(coeffs) + [0] * (n + BLIND - len(coeffs))
        for i in range(BLIND):
            r = (rng.randrange(P) if rng else secrets.randbelow(P))
            out[i] = (out[i] - r) % P
            out[n + i] = (out[n + i] + r) % P
        return out

    # ------------------------------------------------- lookup permutation
    @staticmethod
    def _permute_lookup(a_vals, s_vals):
        """halo2's permuted (A', S'): A' sorted; S' has each first-of-run
        value of A' aligned, remaining table values filling the rest."""
        from collections import Counter

        n = len(a_vals)
        a_sorted = sorted(a_vals)
        leftovers = Counter(s_vals)
        s_prime = [None] * n
        for i, v in enumerate(a_sorted):
            if i == 0 or v != a_sorted[i - 1]:
                if leftovers[v] <= 0:
                    raise ValueError("lookup input not in table")
                leftovers[v] -= 1
                s_prime[i] = v
        fill = iter(sorted(leftovers.elements()))
        for i in range(n):
            if s_prime[i] is None:
                s_prime[i] = next(fill)
        return a_sorted, s_prime

    # ------------------------------------------------------------- prove
    def prove(self, asg: Assignment, instances, rng=None) -> PlonkProof:
        n, ext, meta = self.n, self.ext, self.meta
        pk = self.pk
        size = ext * n
        inst_cols = [
            list(col) + [0] * (n - len(col)) for col in instances
        ]
        with metrics.timer("plonk.advice_polys"):
            advice_polys = [
                self._blind(_coeffs_from_evals(list(c), self.device), rng) for c in asg.advice
            ]
            inst_polys = [_coeffs_from_evals(c, self.device) for c in inst_cols]
        with metrics.timer("plonk.advice_commits"):
            advice_comms = [self.ipa.commit(c) for c in advice_polys]
        tr = Blake2bTranscript()
        for c in advice_comms:
            tr.common_point(c)

        # ---- lookups: compress with theta, permute, commit
        base_tables = {
            "advice": [list(c) for c in asg.advice],
            "fixed": [list(c) for c in asg.fixed],
            "instance": inst_cols,
        }
        theta = tr.squeeze_challenge()
        with metrics.timer("plonk.lookups"):
            lookup_data = []
            for lk in meta.lookups:
                a_vec = [0] * n
                s_vec = [0] * n
                t_pow = 1
                for inp, tab in lk.pairs:
                    iv = inp.eval_vec(base_tables, P, n)
                    tv = tab.eval_vec(base_tables, P, n)
                    for r in range(n):
                        a_vec[r] = (a_vec[r] + t_pow * iv[r]) % P
                        s_vec[r] = (s_vec[r] + t_pow * tv[r]) % P
                    t_pow = t_pow * theta % P
                ap_vals, sp_vals = self._permute_lookup(a_vec, s_vec)
                ap_poly = self._blind(_coeffs_from_evals(ap_vals, self.device), rng)
                sp_poly = self._blind(_coeffs_from_evals(sp_vals, self.device), rng)
                lookup_data.append(
                    {
                        "a": a_vec,
                        "s": s_vec,
                        "ap": ap_vals,
                        "sp": sp_vals,
                        "ap_poly": ap_poly,
                        "sp_poly": sp_poly,
                        "ap_comm": self.ipa.commit(ap_poly),
                        "sp_comm": self.ipa.commit(sp_poly),
                    }
                )
        lookup_perm_comms = [(d["ap_comm"], d["sp_comm"]) for d in lookup_data]
        for a_c, s_c in lookup_perm_comms:
            tr.common_point(a_c)
            tr.common_point(s_c)
        beta = tr.squeeze_challenge()
        gamma = tr.squeeze_challenge()

        # ---- permutation grand product on the base domain
        with metrics.timer("plonk.grand_products"):
            w = self.domain_w
            ws = [pow(w, r, P) for r in range(n)]
            cols_v = []
            for k, i in self.perm_cols:
                if k == "advice":
                    cols_v.append(list(asg.advice[i]))
                else:
                    cols_v.append(inst_cols[i])
            m = len(self.perm_cols)
            z = [1]
            for r in range(n - 1):
                num = den = 1
                for j in range(m):
                    v = cols_v[j][r]
                    num = num * ((v + beta * pk.vk.deltas[j] * ws[r] + gamma) % P) % P
                    den = den * ((v + beta * pk.sigma_evals[j][r] + gamma) % P) % P
                z.append(z[-1] * num % P * pow(den, -1, P) % P)
            z_poly = self._blind(_coeffs_from_evals(z, self.device), rng)
            z_comm = self.ipa.commit(z_poly)

            # ---- lookup grand products
            for d in lookup_data:
                zl = [1]
                for r in range(n - 1):
                    num = (d["a"][r] + beta) * (d["s"][r] + gamma) % P
                    den = (d["ap"][r] + beta) * (d["sp"][r] + gamma) % P
                    zl.append(zl[-1] * num % P * pow(den, -1, P) % P)
                d["z_poly"] = self._blind(_coeffs_from_evals(zl, self.device), rng)
                d["z_comm"] = self.ipa.commit(d["z_poly"])
            lookup_z_comms = [d["z_comm"] for d in lookup_data]
        tr.common_point(z_comm)
        for c in lookup_z_comms:
            tr.common_point(c)
        alpha = tr.squeeze_challenge()

        # ---- quotient on the extended coset
        with metrics.timer("plonk.quotient"):
            if self.use_device:
                t_evals = self._quotient_device(
                    advice_polys, inst_polys, z_poly, lookup_data,
                    theta, beta, gamma, alpha,
                )
            else:
                t_evals = self._quotient_host(
                    advice_polys, inst_polys, z_poly, lookup_data,
                    theta, beta, gamma, alpha,
                )
            t_coeffs = _coeffs_from_coset(t_evals, self.device)
            # split into ext chunks of degree < n
            t_chunks = [t_coeffs[c * n : (c + 1) * n] for c in range(ext)]
            with metrics.timer("plonk.t_commits"):
                t_comms = [self.ipa.commit(c) for c in t_chunks]
        for c in t_comms:
            tr.common_point(c)
        x = tr.squeeze_challenge()
        wx = x * w % P
        wix = x * pow(w, -1, P) % P

        with metrics.timer("plonk.evals"):
            evals = {
                "advice_x": [_eval_at(c, x) for c in advice_polys],
                "advice_wx": [_eval_at(c, wx) for c in advice_polys],
                "fixed_x": [_eval_at(c, x) for c in pk.fixed_polys],
                "sigma_x": [_eval_at(c, x) for c in pk.sigma_polys],
                "z_x": _eval_at(z_poly, x),
                "z_wx": _eval_at(z_poly, wx),
                "t_x": [_eval_at(c, x) for c in t_chunks],
                "lk_ap_x": [_eval_at(d["ap_poly"], x) for d in lookup_data],
                "lk_ap_wix": [_eval_at(d["ap_poly"], wix) for d in lookup_data],
                "lk_sp_x": [_eval_at(d["sp_poly"], x) for d in lookup_data],
                "lk_z_x": [_eval_at(d["z_poly"], x) for d in lookup_data],
                "lk_z_wx": [_eval_at(d["z_poly"], wx) for d in lookup_data],
            }
        self._absorb_evals(tr, evals)
        nu = tr.squeeze_challenge()

        # ---- multiopen: combined poly at x, at wx, at w^-1 x
        def combine(polys):
            width = 2 * n
            out = [0] * width
            s = 1
            for c in polys:
                cc = list(c) + [0] * (width - len(c))
                for i in range(width):
                    out[i] = (out[i] + s * cc[i]) % P
                s = s * nu % P
            return out

        at_x_polys = (
            advice_polys
            + pk.fixed_polys
            + pk.sigma_polys
            + [z_poly]
            + t_chunks
            + [d["ap_poly"] for d in lookup_data]
            + [d["sp_poly"] for d in lookup_data]
            + [d["z_poly"] for d in lookup_data]
        )
        at_wx_polys = advice_polys + [z_poly] + [d["z_poly"] for d in lookup_data]
        with metrics.timer("plonk.combine"):
            cx = combine(at_x_polys)
            cwx = combine(at_wx_polys)
            cwix = combine([d["ap_poly"] for d in lookup_data]) if lookup_data else None
        with metrics.timer("plonk.opens"):
            open_x = self.ipa.open(cx, x, transcript=tr)
            open_wx = self.ipa.open(cwx, wx, transcript=tr)
            open_wix = None
            if lookup_data:
                open_wix = self.ipa.open(cwix, wix, transcript=tr)
        return PlonkProof(
            advice_comms=advice_comms,
            lookup_perm_comms=lookup_perm_comms,
            z_comm=z_comm,
            lookup_z_comms=lookup_z_comms,
            t_comms=t_comms,
            evals=evals,
            open_x=open_x,
            open_wx=open_wx,
            open_wix=open_wix,
        )

    # -------------------------------------------------- quotient assembly
    def _quotient_device(
        self, advice_polys, inst_polys, z_poly, lookup_data,
        theta, beta, gamma, alpha,
    ):
        """Whole-domain quotient as batched device operations
        (plonkish/quotient_device.py); values identical to the host
        path."""
        from .quotient_device import QuotientDevice

        if self._qdev is None:
            self._qdev = QuotientDevice(
                self.meta, self.perm_cols, self.pk.vk.deltas, self.n, self.ext,
                device=self.device,
            )
        size = self.ext * self.n
        pk = self.pk
        tables = {
            "advice": [_evals_on_coset_enc(c, size, self.device) for c in advice_polys],
            "fixed": [_evals_on_coset_enc(c, size, self.device) for c in pk.fixed_polys],
            "instance": [_evals_on_coset_enc(c, size, self.device) for c in inst_polys],
        }
        sigma_ext = [_evals_on_coset_enc(c, size, self.device) for c in pk.sigma_polys]
        z_ext = _evals_on_coset_enc(z_poly, size, self.device)
        lookup_ext = [
            {
                "ap": _evals_on_coset_enc(d["ap_poly"], size, self.device),
                "sp": _evals_on_coset_enc(d["sp_poly"], size, self.device),
                "z": _evals_on_coset_enc(d["z_poly"], size, self.device),
            }
            for d in lookup_data
        ]
        return self._qdev.assemble(
            tables, sigma_ext, z_ext, lookup_ext, theta, beta, gamma, alpha
        )

    def _quotient_host(
        self, advice_polys, inst_polys, z_poly, lookup_data,
        theta, beta, gamma, alpha,
    ):
        n, ext, meta = self.n, self.ext, self.meta
        pk = self.pk
        size = ext * n
        m = len(self.perm_cols)
        tables_ext = {
            "advice": [_evals_on_coset(c, size, self.device) for c in advice_polys],
            "fixed": [_evals_on_coset(c, size, self.device) for c in pk.fixed_polys],
            "instance": [_evals_on_coset(c, size, self.device) for c in inst_polys],
        }
        sigma_ext = [_evals_on_coset(c, size, self.device) for c in pk.sigma_polys]
        z_ext = _evals_on_coset(z_poly, size, self.device)
        gnp = pow(GEN, n, P)
        w_ext = fi.root_of_unity(P, size)
        zh = [(gnp * pow(w_ext, (i * n) % size, P) - 1) % P for i in range(size)]
        zh_inv = [pow(v, -1, P) for v in zh]
        ninv = pow(n, -1, P)
        l0 = []
        for i in range(size):
            xi = GEN * pow(w_ext, i, P) % P
            l0.append(zh[i] * ninv % P * pow((xi - 1) % P, -1, P) % P)

        quotient = [0] * size
        a_pow = 1
        for gate in meta.gates:
            for poly in gate.polys:
                vals = poly.eval_vec(tables_ext, P, size, rot_scale=ext)
                for i in range(size):
                    quotient[i] = (quotient[i] + a_pow * vals[i]) % P
                a_pow = a_pow * alpha % P
        # permutation transition: Z(wX)*prod(den) - Z(X)*prod(num)
        for i in range(size):
            xi = GEN * pow(w_ext, i, P) % P
            num = den = 1
            for j in range(m):
                v = tables_ext[self.perm_cols[j][0]][self.perm_cols[j][1]][i]
                num = num * ((v + beta * pk.vk.deltas[j] % P * xi + gamma) % P) % P
                den = den * ((v + beta * sigma_ext[j][i] + gamma) % P) % P
            zi = z_ext[i]
            zw = z_ext[(i + ext) % size]
            term = (zw * den - zi * num) % P
            quotient[i] = (quotient[i] + a_pow * term) % P
        a_pow = a_pow * alpha % P
        for i in range(size):
            quotient[i] = (quotient[i] + a_pow * (l0[i] * ((z_ext[i] - 1) % P))) % P
        a_pow = a_pow * alpha % P
        # lookup constraints
        for d in lookup_data:
            a_ext = [0] * size
            s_ext = [0] * size
            t_pow = 1
            for inp, tab in meta.lookups[lookup_data.index(d)].pairs:
                iv = inp.eval_vec(tables_ext, P, size, rot_scale=ext)
                tv = tab.eval_vec(tables_ext, P, size, rot_scale=ext)
                for i in range(size):
                    a_ext[i] = (a_ext[i] + t_pow * iv[i]) % P
                    s_ext[i] = (s_ext[i] + t_pow * tv[i]) % P
                t_pow = t_pow * theta % P
            ap_ext = _evals_on_coset(d["ap_poly"], size, self.device)
            sp_ext = _evals_on_coset(d["sp_poly"], size, self.device)
            zl_ext = _evals_on_coset(d["z_poly"], size, self.device)
            for i in range(size):
                zi = zl_ext[i]
                zw = zl_ext[(i + ext) % size]
                # 1) L0 (Z - 1)
                quotient[i] = (quotient[i] + a_pow * (l0[i] * ((zi - 1) % P))) % P
                # 2) Z(wX)(A'+beta)(S'+gamma) - Z(X)(A+beta)(S+gamma)
                t2 = (
                    zw * ((ap_ext[i] + beta) % P) % P * ((sp_ext[i] + gamma) % P)
                    - zi * ((a_ext[i] + beta) % P) % P * ((s_ext[i] + gamma) % P)
                ) % P
                quotient[i] = (quotient[i] + a_pow * alpha % P * t2) % P
                # 3) (A' - S') (A'(X) - A'(w^-1 X))
                ap_prev = ap_ext[(i - ext) % size]
                t3 = (ap_ext[i] - sp_ext[i]) * ((ap_ext[i] - ap_prev) % P) % P
                quotient[i] = (
                    quotient[i] + a_pow * alpha % P * alpha % P * t3
                ) % P
                # 4) L0 (A' - S')
                t4 = l0[i] * ((ap_ext[i] - sp_ext[i]) % P) % P
                quotient[i] = (
                    quotient[i] + a_pow * pow(alpha, 3, P) % P * t4
                ) % P
            a_pow = a_pow * pow(alpha, 4, P) % P
        t_evals = [quotient[i] * zh_inv[i] % P for i in range(size)]
        return t_evals

    @staticmethod
    def _absorb_evals(tr, ev) -> None:
        """Absorb every claimed evaluation as a transcript scalar, in a
        fixed order shared by prover and verifier."""
        names = [
            "advice_x",
            "advice_wx",
            "fixed_x",
            "sigma_x",
            "t_x",
            "lk_ap_x",
            "lk_ap_wix",
            "lk_sp_x",
            "lk_z_x",
            "lk_z_wx",
        ]
        for nme in names:
            for v in ev[nme]:
                tr.common_scalar(v)
        tr.common_scalar(ev["z_x"])
        tr.common_scalar(ev["z_wx"])

    # ------------------------------------------------------------ verify
    def verify(self, proof: PlonkProof, instances) -> bool:
        n, ext, meta = self.n, self.ext, self.meta
        vk = self.pk.vk
        m = len(self.perm_cols)
        inst_cols = [list(col) + [0] * (n - len(col)) for col in instances]
        inst_polys = [_coeffs_from_evals(c, self.device) for c in inst_cols]

        tr = Blake2bTranscript()
        for c in proof.advice_comms:
            tr.common_point(c)
        theta = tr.squeeze_challenge()
        for a_c, s_c in proof.lookup_perm_comms:
            tr.common_point(a_c)
            tr.common_point(s_c)
        beta = tr.squeeze_challenge()
        gamma = tr.squeeze_challenge()
        tr.common_point(proof.z_comm)
        for c in proof.lookup_z_comms:
            tr.common_point(c)
        alpha = tr.squeeze_challenge()
        for c in proof.t_comms:
            tr.common_point(c)
        x = tr.squeeze_challenge()
        w = self.domain_w
        wx = x * w % P
        wix = x * pow(w, -1, P) % P
        ev = proof.evals
        if len(proof.lookup_perm_comms) != len(meta.lookups) or len(
            proof.lookup_z_comms
        ) != len(meta.lookups):
            return False
        self._absorb_evals(tr, ev)
        nu = tr.squeeze_challenge()

        # ---- recompute the identity at x
        inst_x = [_eval_at(c, x) for c in inst_polys]

        def col_val(kind, idx, rot):
            if kind == "advice":
                if rot == 0:
                    return ev["advice_x"][idx]
                if rot == 1:
                    return ev["advice_wx"][idx]
                raise ValueError("unsupported advice rotation")
            if kind == "fixed":
                assert rot == 0, "fixed rotations beyond 0 unsupported"
                return ev["fixed_x"][idx]
            if kind == "instance":
                assert rot == 0
                return inst_x[idx]
            raise ValueError(kind)

        def eval_expr(e):
            k = e.node[0]
            if k == "col":
                c = e.node[1]
                return col_val(c.kind, c.index, c.rotation)
            if k == "const":
                return e.node[1] % P
            if k == "add":
                return (eval_expr(e.node[1]) + eval_expr(e.node[2])) % P
            if k == "mul":
                return (eval_expr(e.node[1]) * eval_expr(e.node[2])) % P
            if k == "neg":
                return (-eval_expr(e.node[1])) % P
            raise ValueError(k)

        total = 0
        a_pow = 1
        for gate in meta.gates:
            for poly in gate.polys:
                total = (total + a_pow * eval_expr(poly)) % P
                a_pow = a_pow * alpha % P
        num = den = 1
        for j in range(m):
            kind, idx = self.perm_cols[j]
            v = ev["advice_x"][idx] if kind == "advice" else inst_x[idx]
            num = num * ((v + beta * vk.deltas[j] % P * x + gamma) % P) % P
            den = den * ((v + beta * ev["sigma_x"][j] + gamma) % P) % P
        total = (total + a_pow * ((ev["z_wx"] * den - ev["z_x"] * num) % P)) % P
        a_pow = a_pow * alpha % P
        zh_x = (pow(x, n, P) - 1) % P
        l0_x = zh_x * pow(n, -1, P) % P * pow((x - 1) % P, -1, P) % P
        total = (total + a_pow * (l0_x * ((ev["z_x"] - 1) % P) % P)) % P
        a_pow = a_pow * alpha % P
        for li, lk in enumerate(meta.lookups):
            a_x = s_x = 0
            t_pow = 1
            for inp, tab in lk.pairs:
                a_x = (a_x + t_pow * eval_expr(inp)) % P
                s_x = (s_x + t_pow * eval_expr(tab)) % P
                t_pow = t_pow * theta % P
            zi = ev["lk_z_x"][li]
            zw = ev["lk_z_wx"][li]
            ap = ev["lk_ap_x"][li]
            app = ev["lk_ap_wix"][li]
            sp = ev["lk_sp_x"][li]
            total = (total + a_pow * (l0_x * ((zi - 1) % P) % P)) % P
            t2 = (
                zw * ((ap + beta) % P) % P * ((sp + gamma) % P)
                - zi * ((a_x + beta) % P) % P * ((s_x + gamma) % P)
            ) % P
            total = (total + a_pow * alpha % P * t2) % P
            t3 = (ap - sp) * ((ap - app) % P) % P
            total = (total + a_pow * alpha % P * alpha % P * t3) % P
            t4 = l0_x * ((ap - sp) % P) % P
            total = (total + a_pow * pow(alpha, 3, P) % P * t4) % P
            a_pow = a_pow * pow(alpha, 4, P) % P
        t_x = 0
        xn = pow(x, n, P)
        s = 1
        for tv in ev["t_x"]:
            t_x = (t_x + s * tv) % P
            s = s * xn % P
        if total != t_x * zh_x % P:
            return False

        # ---- multiopen checks
        def combine_comms(comms):
            acc = None
            s = 1
            for c in comms:
                acc = CURVE.add(acc, CURVE.mul(s, c))
                s = s * nu % P
            return acc

        def combine_vals(vals):
            acc = 0
            s = 1
            for v in vals:
                acc = (acc + s * v) % P
                s = s * nu % P
            return acc

        lk_ap_comms = [a for a, _ in proof.lookup_perm_comms]
        lk_sp_comms = [s for _, s in proof.lookup_perm_comms]
        at_x_comms = (
            proof.advice_comms
            + vk.fixed_comms
            + vk.sigma_comms
            + [proof.z_comm]
            + proof.t_comms
            + lk_ap_comms
            + lk_sp_comms
            + proof.lookup_z_comms
        )
        at_x_vals = (
            ev["advice_x"]
            + ev["fixed_x"]
            + ev["sigma_x"]
            + [ev["z_x"]]
            + ev["t_x"]
            + ev["lk_ap_x"]
            + ev["lk_sp_x"]
            + ev["lk_z_x"]
        )
        if not self.ipa.verify(
            combine_comms(at_x_comms), x, combine_vals(at_x_vals), proof.open_x,
            transcript=tr,
        ):
            return False
        at_wx_comms = proof.advice_comms + [proof.z_comm] + proof.lookup_z_comms
        at_wx_vals = ev["advice_wx"] + [ev["z_wx"]] + ev["lk_z_wx"]
        if not self.ipa.verify(
            combine_comms(at_wx_comms), wx, combine_vals(at_wx_vals), proof.open_wx,
            transcript=tr,
        ):
            return False
        if meta.lookups:
            if proof.open_wix is None:
                return False
            return self.ipa.verify(
                combine_comms(lk_ap_comms),
                wix,
                combine_vals(ev["lk_ap_wix"]),
                proof.open_wix,
                transcript=tr,
            )
        return True
