"""Succinct decider for folded relaxed-R1CS accumulators (torch port).

Port of `contangle_zkcp_tpu/groth16/decider.py`: after `FoldingScheme`
compresses k instances into ONE relaxed accumulator (U, W), this module
proves that the accumulator is satisfied WITHOUT handing the verifier
the witness.  A Groth16 circuit over the accumulator check would need
~1.5k constraints per 253-bit scalar multiply of the Pedersen openings;
Nova pairs folding with a Spartan-class argument instead, and so does
this: the prover's heavy steps are MSMs (the device engine of
groth16/ipa_vec.py, on the scheme's device) and linear host passes; the
verifier does log-round sumcheck checks plus one O(nnz) sparse-matrix
evaluation.

Protocol (Spartan NIZK without SPARK, over the fold's own commitments):
  z = [u, x, w] (the fold's Z layout), NC/NZ = pow2-padded sizes.
  1. tau <- FS.  Outer sumcheck over the row cube:
       0 = sum_t eq(tau,t) * (az(t)*bz(t) - u*cz(t) - e(t))   (deg 3)
     ending at point rx with claims va, vb, vc, ve.
  2. ve is proven against comm_E by a vector-IPA opening with the
     public vector eq(rx, .) (groth16/ipa_vec.py).
  3. rA,rB,rC <- FS.  Inner sumcheck over the column cube:
       rA*va + rB*vb + rC*vc = sum_y M(rx,y) * z(y)            (deg 2)
     with M = rA*A + rB*B + rC*C, ending at ry with claims vm, vz.
  4. The verifier evaluates M~(rx,ry) itself from the sparse COO
     matrices (O(nnz) field work) and checks vm == M~(rx,ry).
  5. vz splits over z's layout: the public prefix [u, x] the verifier
     evaluates directly; the w tail is proven against comm_W by a
     second vector-IPA opening with the shifted eq slice.

All challenges ride ONE Blake2b transcript seeded with the accumulator,
so the sumchecks and both openings are bound together; for the same
accumulator the proof equals the reference's field for field.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..fields import instances as fi
from . import sumcheck as sc
from .folding import FoldingScheme, RelaxedInstance, RelaxedWitness, _derive_bases
from .ipa_vec import VecIpaProof, VectorIPA

P = fi.BLS12_381_R


class DeciderTranscript:
    """Blake2b Fiat-Shamir state shared by sumchecks and IPA openings."""

    def __init__(self, tag: bytes = b"contangle-decider"):
        self._st = hashlib.blake2b(digest_size=64, person=b"ZkcpFoldDecider!")
        self._st.update(tag)

    def absorb_scalars(self, vals):
        for v in vals:
            self._st.update(b"\x02" + (int(v) % P).to_bytes(32, "big"))

    def absorb_point(self, pt):
        if pt is None:
            self._st.update(b"\x01" + b"\x00" * 96)
        else:
            self._st.update(
                b"\x01" + pt[0].to_bytes(48, "big") + pt[1].to_bytes(48, "big")
            )

    def squeeze_scalar(self) -> int:
        self._st.update(b"\x00")
        return int.from_bytes(self._st.copy().digest(), "big") % P


@dataclass
class DeciderProof:
    outer_polys: list  # [[4 evals] per row variable]
    va: int
    vb: int
    vc: int
    ve: int
    open_e: VecIpaProof
    inner_polys: list  # [[3 evals] per col variable]
    vz: int
    open_w: VecIpaProof


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class Decider:
    """Prover/verifier pair for one FoldingScheme structure, on the
    scheme's device."""

    def __init__(self, fs: FoldingScheme, use_device_msm: bool = True):
        self.fs = fs
        self.NC = _pow2(fs.nc)
        self.NZ = _pow2(fs.nv)
        self.sc_rows = self.NC.bit_length() - 1
        self.sc_cols = self.NZ.bit_length() - 1
        nw = fs.nv - fs.ni
        # pow2-extend the fold's bases with the SAME derivation (the
        # fold bases are the prefix; the committed vector is zero on
        # the extension, so commitments are unchanged)
        bw = _derive_bases(b"contangle-fold-w", _pow2(nw), fs.device)
        be = _derive_bases(b"contangle-fold-e", _pow2(fs.nc), fs.device)
        assert bw[: len(fs.bases_w)] == list(fs.bases_w)
        assert be[: len(fs.bases_e)] == list(fs.bases_e)
        self.ipa_w = VectorIPA(bw, use_device_msm=use_device_msm, device=fs.device)
        self.ipa_e = VectorIPA(be, use_device_msm=use_device_msm, device=fs.device)

    # ------------------------------------------------------------ helpers
    def _seed(self, tr: DeciderTranscript, inst: RelaxedInstance):
        tr.absorb_point(inst.comm_w)
        tr.absorb_point(inst.comm_e)
        tr.absorb_scalars([inst.u] + list(inst.x))

    def _pad(self, vec, n):
        return [v % P for v in vec] + [0] * (n - len(vec))

    def _matvecs(self, inst, wit):
        fs = self.fs
        z = [inst.u] + list(inst.x) + list(wit.w)
        az = fs._mat_vec(fs.A, z)
        bz = fs._mat_vec(fs.B, z)
        cz = fs._mat_vec(fs.C, z)
        return z, az, bz, cz

    def _m_eval(self, rx, ry, rabc):
        """Verifier-side M~(rx, ry) from the sparse COO matrices."""
        eq_rx = sc.eq_table(P, rx)
        eq_ry = sc.eq_table(P, ry)
        acc = 0
        for coeff, coo in zip(rabc, (self.fs.A, self.fs.B, self.fs.C)):
            m = 0
            for row, col, v in coo:
                m = (m + eq_rx[row] * eq_ry[col] % P * v) % P
            acc = (acc + coeff * m) % P
        return acc

    # -------------------------------------------------------------- prove
    def prove(self, inst: RelaxedInstance, wit: RelaxedWitness) -> DeciderProof:
        fs = self.fs
        NC, NZ = self.NC, self.NZ
        tr = DeciderTranscript()
        self._seed(tr, inst)
        taus = [tr.squeeze_scalar() for _ in range(self.sc_rows)]

        z, az, bz, cz = self._matvecs(inst, wit)
        eq_t = sc.eq_table(P, taus)
        tables = [
            eq_t,
            self._pad(az, NC),
            self._pad(bz, NC),
            self._pad(cz, NC),
            self._pad(wit.e, NC),
        ]
        u_val = inst.u % P

        def outer(vals):
            eq, a, b, c, e = vals
            return eq * ((a * b - u_val * c - e) % P) % P

        outer_polys, rx, finals, _ = sc.prove(P, tables, outer, 3, 0, tr)
        _eq_rx, va, vb, vc, ve = finals
        tr.absorb_scalars([va, vb, vc, ve])

        # ---- opening of e~(rx) against comm_E
        open_e = self.ipa_e.open(self._pad(wit.e, NC), sc.eq_table(P, rx), tr)

        # ---- inner sumcheck for the three matrix-vector claims
        rabc = [tr.squeeze_scalar() for _ in range(3)]
        eq_rx = sc.eq_table(P, rx)
        m_tbl = [0] * NZ
        for coeff, coo in zip(rabc, (fs.A, fs.B, fs.C)):
            for row, col, v in coo:
                m_tbl[col] = (m_tbl[col] + coeff * eq_rx[row] % P * v) % P
        claimed = (rabc[0] * va + rabc[1] * vb + rabc[2] * vc) % P
        tables2 = [m_tbl, self._pad(z, NZ)]

        def inner(vals):
            return vals[0] * vals[1] % P

        inner_polys, ry, finals2, _ = sc.prove(P, tables2, inner, 2, claimed, tr)
        _vm, vz = finals2
        tr.absorb_scalars([vz])

        # ---- opening of the w part of z~(ry) against comm_W
        eq_ry = sc.eq_table(P, ry)
        b_w = eq_ry[fs.ni : fs.ni + self.ipa_w.n]
        b_w = b_w + [0] * (self.ipa_w.n - len(b_w))
        open_w = self.ipa_w.open(self._pad(wit.w, self.ipa_w.n), b_w, tr)

        return DeciderProof(
            outer_polys=outer_polys,
            va=va,
            vb=vb,
            vc=vc,
            ve=ve,
            open_e=open_e,
            inner_polys=inner_polys,
            vz=vz,
            open_w=open_w,
        )

    # ------------------------------------------------------------- verify
    def verify(self, inst: RelaxedInstance, proof: DeciderProof) -> bool:
        fs = self.fs
        NC = self.NC
        tr = DeciderTranscript()
        self._seed(tr, inst)
        taus = [tr.squeeze_scalar() for _ in range(self.sc_rows)]
        try:
            rx, final1 = sc.verify(
                P, 0, 3, self.sc_rows, proof.outer_polys, tr
            )
        except ValueError:
            return False
        va, vb, vc, ve = proof.va, proof.vb, proof.vc, proof.ve
        # final outer claim must equal eq(tau,rx)*(va*vb - u*vc - ve)
        eq_tr = sc.eq_point(P, taus, rx)
        if final1 != eq_tr * ((va * vb - inst.u * vc - ve) % P) % P:
            return False
        tr.absorb_scalars([va, vb, vc, ve])

        comm_e = inst.comm_e  # None encodes the zero vector (identity)
        if not self.ipa_e.verify(
            comm_e, sc.eq_table(P, rx), ve, proof.open_e, tr
        ):
            return False

        rabc = [tr.squeeze_scalar() for _ in range(3)]
        claimed = (rabc[0] * va + rabc[1] * vb + rabc[2] * vc) % P
        try:
            ry, final2 = sc.verify(
                P, claimed, 2, self.sc_cols, proof.inner_polys, tr
            )
        except ValueError:
            return False
        vm = self._m_eval(rx, ry, rabc)  # O(nnz) — pre-SPARK verifier
        vz = proof.vz
        if final2 != vm * vz % P:
            return False
        tr.absorb_scalars([vz])

        # z~(ry) = public prefix + committed w tail
        eq_ry = sc.eq_table(P, ry)
        pub = [inst.u % P] + [v % P for v in inst.x]
        v_pub = sum(p_i * e_i for p_i, e_i in zip(pub, eq_ry)) % P
        v_w = (vz - v_pub) % P
        b_w = eq_ry[fs.ni : fs.ni + self.ipa_w.n]
        b_w = b_w + [0] * (self.ipa_w.n - len(b_w))
        return self.ipa_w.verify(inst.comm_w, b_w, v_w, proof.open_w, tr)
