"""Groth16 zkSNARK: setup / prove / verify (torch port).

Port of `contangle_zkcp_tpu/groth16/groth16.py`, itself a rebuild of
ark-groth16 0.3: same QAP reduction (libsnark-style input-consistency rows
appended to A), same CRS shape, same 3-pairing verification equation, and
for the same proving key and `random.Random` the same proof bytes.

Work placement:
  * witness/matrix evaluation: host (native C++ engine, r1cs/native.py);
  * the seven domain-size NTTs for the H quotient: the card (`ops.ntt`,
    kernel K2 per stage, K1 for the pointwise products);
  * the five proof MSMs (A, B in G1 and G2, H, L): the card, on the
    engine the policy names (`ops.msm_balanced` at proving scale,
    `ops.msm` below 2^16 points; kernel K3 for every G1 add, K1 under
    every G2 add);
  * CRS generation: the card's fixed-base multiplier (`ops.fixed_base`)
    for large circuits, host window tables for small ones;
  * verification: host pairing engine; the public-input MSM runs on the
    card when the verifying key lives there.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

import torch

from ..curves import instances as ci
from ..curves.fq2_device import Fq2Device
from ..curves.host import SWCurve
from ..curves import pairing as pairing_mod
from ..curves.weierstrass import SWDevice
from ..fields import instances as fi
from ..utils import metrics
from ..fields.bigint import LIMB_BITS, ints_to_limbs
from ..ops.msm import MSM
from ..ops.ntt import NTT
from ..r1cs.builder import ConstraintSystem


# ----------------------------------------------------------------- curve ctx
@dataclass
class CurveCtx:
    """All engines for one pairing-friendly curve."""

    name: str
    r: int  # scalar field
    g1: SWCurve
    g2_gen: tuple
    pairing: pairing_mod.PairingEngine
    device: str = "cuda"
    g1_dev: SWDevice = None
    g2_dev: SWDevice = None

    def __post_init__(self):
        if self.name == "bls12_381":
            Fq = fi.bls12_381_fq()
            b2 = ci.BLS12_381_G2_B
        else:
            Fq = fi.bn254_fq()
            from ..curves import fq2 as f2

            b2 = f2.mul((3, 0), f2.inv((9, 1), Fq.p), Fq.p)
        self.g1_dev = SWDevice(Fq, self.g1, device=self.device)
        self.g2_dev = SWDevice(Fq2Device(Fq), b=b2, device=self.device)
        self._msm_cache = {}
        self.Fr = fi.get_field(self.r, f"{self.name}_fr")

    def msm_g1(self, n: int) -> MSM:
        return self._msm_for("g1", n)

    def msm_g2(self, n: int) -> MSM:
        return self._msm_for("g2", n)

    def _msm_for(self, group: str, n: int) -> MSM:
        """Engine per (group, size) from the tested policy table
        (ops/msm_policy.py): its window width, digit signing and engine
        name — "lockstep" (ops/msm.py, small MSMs), "balanced"
        (ops/msm_balanced.py, every MSM of n >= 2^16) or "tree"
        (ops/msm_tree.py) — as the reference builds them."""
        from ..ops.msm_policy import msm_config

        cfg = msm_config(group, n, self.r.bit_length())
        key = (group, cfg.c, cfg.signed, cfg.engine)
        if key not in self._msm_cache:
            dev = self.g1_dev if group == "g1" else self.g2_dev
            if cfg.engine == "tree":
                from ..ops.msm_tree import TreeMSM as engine
            elif cfg.engine == "balanced":
                from ..ops.msm_balanced import BalancedMSM as engine
            else:
                engine = MSM
            self._msm_cache[key] = engine(
                dev, scalar_bits=self.r.bit_length(), c=cfg.c, signed=cfg.signed
            )
        return self._msm_cache[key]


_CTX = {}


def curve_ctx(name: str = "bls12_381", device="cuda") -> CurveCtx:
    key = (name, str(torch.device(device)))
    if key not in _CTX:
        if name == "bls12_381":
            _CTX[key] = CurveCtx(
                name,
                fi.BLS12_381_R,
                ci.BLS12_381_G1,
                (ci.BLS12_381_G2_GX, ci.BLS12_381_G2_GY),
                pairing_mod.bls12_381(),
                device=key[1],
            )
        elif name == "bn254":
            _CTX[key] = CurveCtx(
                name,
                fi.BN254_R,
                ci.BN254_G1,
                (ci.BN254_G2_GX, ci.BN254_G2_GY),
                pairing_mod.bn254(),
                device=key[1],
            )
        else:
            raise ValueError(name)
    return _CTX[key]


# ----------------------------------------------------------------------- QAP
class QAP:
    """Libsnark-style R1CS -> QAP over a radix-2 domain.

    Adds one input-consistency row per instance variable (A[nc+i][i] = 1)
    so instance polynomials are linearly independent, then works over a
    power-of-two domain of size >= nc + ni.
    """

    def __init__(self, cs: ConstraintSystem, r: int):
        self.r = r
        self.nc = cs.num_constraints
        self.ni = cs.num_instance
        self.nv = cs.num_variables
        self.domain = _next_pow2(self.nc + self.ni)
        A, B, C = cs.matrices_coo()
        for i in range(self.ni):
            A.append((self.nc + i, i, 1))
        self.A, self.B, self.C = A, B, C

    def eval_rows(self, z):
        """(a, b, c) evaluation vectors over the padded domain.

        Uses the native C++ engine (r1cs/native.py) when built — the
        host-side serial hot loop for large circuits — with an exact
        pure-Python fallback."""
        from ..r1cs import native

        r, d = self.r, self.domain
        if native.available() and r.bit_length() <= 256:
            abc = native.eval_rows_abc(r, self.A, self.B, self.C, z, d)
            if abc is not None:
                return abc
        a = [0] * d
        b = [0] * d
        c = [0] * d
        for row, col, coeff in self.A:
            a[row] = (a[row] + coeff * z[col]) % r
        for row, col, coeff in self.B:
            b[row] = (b[row] + coeff * z[col]) % r
        for row, col, coeff in self.C:
            c[row] = (c[row] + coeff * z[col]) % r
        return a, b, c

    def eval_rows_device(self, Fr, z, device="cuda"):
        """(a, b, c) as Montgomery limb tensors on `device`, NTT-ready.

        Native fast path hands raw u64 limb planes straight to the device
        encoder (no per-element Python ints on the boundary); exact
        fallback goes through eval_rows + Fr.encode."""
        from ..r1cs import native

        r, d = self.r, self.domain
        if native.available() and r.bit_length() <= 256:
            arrs = native.eval_rows_abc_arr(r, self.A, self.B, self.C, z, d)
            if arrs is not None:
                return tuple(Fr.encode_u64(a, device=device) for a in arrs)
        a, b, c = self.eval_rows(z)
        return tuple(Fr.encode(list(v), device=device) for v in (a, b, c))

    def eval_variable_polys(self, tau: int):
        """u_i(tau), v_i(tau), w_i(tau) for every variable (host, setup)."""
        r, d = self.r, self.domain
        # Lagrange basis at tau: L_i(tau) = Z(tau) * w^i / (d * (tau - w^i))
        w = fi.root_of_unity(r, d)
        z_tau = (pow(tau, d, r) - 1) % r
        u = [0] * self.nv
        v = [0] * self.nv
        wv = [0] * self.nv
        lag = [0] * d
        wi = 1
        dinv = pow(d, -1, r)
        for i in range(d):
            lag[i] = z_tau * wi % r * pow((tau - wi) % r, -1, r) % r * dinv % r
            wi = wi * w % r
        for row, col, coeff in self.A:
            u[col] = (u[col] + coeff * lag[row]) % r
        for row, col, coeff in self.B:
            v[col] = (v[col] + coeff * lag[row]) % r
        for row, col, coeff in self.C:
            wv[col] = (wv[col] + coeff * lag[row]) % r
        return u, v, wv


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


# ---------------------------------------------------------------------- keys
@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: list


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    a_query: list
    b_g1_query: list
    b_g2_query: list
    h_query: list
    l_query: list
    domain: int = 0


@dataclass
class Proof:
    a: tuple
    b: tuple
    c: tuple


# ------------------------------------------------------------ fixed-base mul
class FixedBaseTable:
    """Host windowed fixed-base scalar multiplication (CRS generation)."""

    def __init__(self, add_fn, base, bits: int, c: int = 8):
        self.add = add_fn
        self.c = c
        self.K = -(-bits // c)
        self.table = []
        cur = base
        for _ in range(self.K):
            row = [None] * (1 << c)
            acc = None
            for wdx in range(1, 1 << c):
                acc = self.add(acc, cur)
                row[wdx] = acc
            self.table.append(row)
            # advance cur by 2^c: double c times via repeated add
            for _ in range(c):
                cur = self.add(cur, cur)

    def mul(self, k: int):
        acc = None
        mask = (1 << self.c) - 1
        for j in range(self.K):
            d = (k >> (j * self.c)) & mask
            if d:
                acc = self.add(acc, self.table[j][d])
        return acc


# -------------------------------------------------------------------- Groth16
class Groth16:
    def __init__(self, curve: str = "bls12_381", device="cuda"):
        self.device = torch.device(device)
        self.ctx = curve_ctx(curve, device)

    # ------------------------------------------------------------- setup
    @metrics.timed("groth16.setup")
    def setup(
        self,
        cs: ConstraintSystem,
        rng: random.Random,
        engine: str = "auto",
        debug_trapdoor: bool = False,
    ):
        """CRS generation.

        engine: "host" (serial Python windowed muls — small circuits/
        tests), "device" (batched fixed-base multiplier on this engine's
        device, ops/fixed_base.py — the scale path), or "auto" (device
        for a CRS of 16384 elements or more).

        debug_trapdoor keeps the toxic waste and the QAP evaluations at
        tau on the ProvingKey (attribute `trapdoor`), so that `prove`
        checks every MSM against its expected scalar with exact host Fr
        arithmetic (`_debug_check_msms`) — never enable outside debugging.
        """
        ctx = self.ctx
        r = ctx.r
        qap = QAP(cs, r)
        alpha, beta, gamma, delta, tau = (rng.randrange(1, r) for _ in range(5))
        u, v, w = qap.eval_variable_polys(tau)
        ginv = pow(gamma, -1, r)
        dinv = pow(delta, -1, r)

        ni, nv = qap.ni, qap.nv
        d = qap.domain
        total = 3 * nv + d
        if engine == "auto":
            engine = "device" if total >= 16384 else "host"

        # scalar vectors for every CRS element
        abc = [(beta * u[i] + alpha * v[i] + w[i]) % r for i in range(nv)]
        gamma_abc_s = [abc[i] * ginv % r for i in range(ni)]
        l_s = [abc[i] * dinv % r for i in range(ni, nv)]
        z_tau = (pow(tau, d, r) - 1) % r
        h_s = []
        t = z_tau * dinv % r
        for _ in range(d - 1):
            h_s.append(t)
            t = t * tau % r

        if engine == "device":
            from ..ops.fixed_base import FixedBaseDevice

            bits = r.bit_length()
            g1_eng = FixedBaseDevice(ctx.g1_dev, ctx.g1.generator, bits)
            # G2 points are twice as wide and their adds keep ~30 Fq2
            # temporaries alive: half the G1 chunk bounds the peak memory
            g2_eng = FixedBaseDevice(ctx.g2_dev, ctx.g2_gen, bits, chunk=1 << 16)
            g1_scalars = (
                gamma_abc_s + l_s + u + v + h_s + [alpha, beta, delta]
            )
            # CRS stays resident on device (projective dicts) — the prover
            # MSMs consume it directly; only the handful of vk scalars is
            # decoded to host affine.
            g1_pts = g1_eng.mul_ints(g1_scalars)
            off = 0

            def take(k):
                nonlocal off
                out = {c: v_[off : off + k] for c, v_ in g1_pts.items()}
                off += k
                return out

            gamma_abc = take(ni)
            l_query = take(nv - ni)
            a_query = take(nv)
            b_g1_query = take(nv)
            h_query = take(d - 1)
            alpha_g1, beta_g1, delta_g1 = ctx.g1_dev.decode_points(take(3))
            g2_pts = g2_eng.mul_ints(v + [beta, gamma, delta])
            b_g2_query = {c: v_[:nv] for c, v_ in g2_pts.items()}
            beta_g2, gamma_g2, delta_g2 = ctx.g2_dev.decode_points(
                {c: v_[nv:] for c, v_ in g2_pts.items()}
            )
        else:
            g1_tab = FixedBaseTable(ctx.g1.add, ctx.g1.generator, r.bit_length())
            g2_tab = FixedBaseTable(ctx.g2_dev.host_add, ctx.g2_gen, r.bit_length())
            gamma_abc = [g1_tab.mul(s) for s in gamma_abc_s]
            l_query = [g1_tab.mul(s) for s in l_s]
            a_query = [g1_tab.mul(u[i]) for i in range(nv)]
            b_g1_query = [g1_tab.mul(v[i]) for i in range(nv)]
            b_g2_query = [g2_tab.mul(v[i]) for i in range(nv)]
            h_query = [g1_tab.mul(s) for s in h_s]
            alpha_g1 = g1_tab.mul(alpha)
            beta_g1 = g1_tab.mul(beta)
            delta_g1 = g1_tab.mul(delta)
            beta_g2 = g2_tab.mul(beta)
            gamma_g2 = g2_tab.mul(gamma)
            delta_g2 = g2_tab.mul(delta)
        vk = VerifyingKey(
            alpha_g1=alpha_g1,
            beta_g2=beta_g2,
            gamma_g2=gamma_g2,
            delta_g2=delta_g2,
            gamma_abc_g1=gamma_abc,
        )
        pk = ProvingKey(
            vk=vk,
            beta_g1=beta_g1,
            delta_g1=delta_g1,
            a_query=a_query,
            b_g1_query=b_g1_query,
            b_g2_query=b_g2_query,
            h_query=h_query,
            l_query=l_query,
            domain=d,
        )
        if debug_trapdoor:
            pk.trapdoor = {
                "alpha": alpha,
                "beta": beta,
                "gamma": gamma,
                "delta": delta,
                "tau": tau,
                "u": u,
                "v": v,
                "w": w,
            }
        return pk, vk

    # ------------------------------------------------------------- prove
    @metrics.timed("groth16.prove")
    def prove(self, pk: ProvingKey, cs: ConstraintSystem, rng: random.Random):
        ctx = self.ctx
        r = ctx.r
        Fr = ctx.Fr
        qap = QAP(cs, r)
        z = cs.full_assignment()
        rr, ss = rng.randrange(r), rng.randrange(r)

        # ---- H coefficients via device NTTs over the coset
        d = qap.domain
        ntt = _ntt_engine(Fr, d, self.device)
        with metrics.timer("groth16.prove.witness_eval"):
            a_dev, b_dev, c_dev = qap.eval_rows_device(Fr, z, self.device)
        with metrics.timer("groth16.prove.ntt_h"):
            g = fi.FIELD_GENERATORS[r]
            pa = ntt.inverse(a_dev)
            pb = ntt.inverse(b_dev)
            pc = ntt.inverse(c_dev)
            ea = ntt.coset_forward(pa, g)
            eb = ntt.coset_forward(pb, g)
            ec = ntt.coset_forward(pc, g)
            ab = Fr.mul(ea, eb)
            num = Fr.sub(ab, ec)
            zinv = pow((pow(g, d, r) - 1) % r, -1, r)  # Z const on the coset
            hev = Fr.mul(num, Fr.encode(zinv, device=self.device))
            h = ntt.coset_inverse(hev, g)
            # canonical H limbs straight into the MSM
            h_can = Fr.from_mont(h)[: d - 1]
            _sync(h_can)

        # ---- MSMs on device
        g1 = ctx.g1
        def _n_points(q):
            return int(q["x"].shape[0]) if isinstance(q, dict) else len(q)

        msm1 = ctx.msm_g1(_n_points(pk.a_query))
        msm2 = ctx.msm_g2(_n_points(pk.b_g2_query))
        # encode the assignment once: three MSMs share the same scalar
        # vector, and the byte-buffer limb conversion is host-serial
        with metrics.timer("groth16.prove.encode_z"):
            z_limbs = ints_to_limbs(z, -(-r.bit_length() // LIMB_BITS))
        with metrics.timer("groth16.prove.msm_a_g1"):
            a_acc = msm1.run(pk.a_query, z_limbs)
        with metrics.timer("groth16.prove.msm_b_g2"):
            b2_acc = msm2.run(pk.b_g2_query, z_limbs)
        with metrics.timer("groth16.prove.msm_b_g1"):
            b1_acc = msm1.run(pk.b_g1_query, z_limbs)
        with metrics.timer("groth16.prove.msm_l_g1"):
            l_acc = (
                ctx.msm_g1(_n_points(pk.l_query)).run(
                    pk.l_query, z_limbs[qap.ni :]
                )
                if _n_points(pk.l_query)
                else None
            )
        with metrics.timer("groth16.prove.msm_h_g1"):
            h_acc = (
                ctx.msm_g1(_n_points(pk.h_query)).run(pk.h_query, h_can)
                if _n_points(pk.h_query)
                else None
            )

        td = getattr(pk, "trapdoor", None)
        if td is not None:
            try:
                self._debug_check_msms(
                    td, qap, z, h_can, a_acc, b2_acc, b1_acc, l_acc, h_acc
                )
            except Exception as e:  # instrumentation must never kill a run
                print(f"[trapdoor] check crashed: {e!r}", flush=True)

        # ---- assemble (host point algebra)
        A = g1.add(g1.add(self._vk_alpha(pk), a_acc), g1.mul(rr, pk.delta_g1))
        g2add = ctx.g2_dev.host_add
        B = g2add(g2add(pk.vk.beta_g2, b2_acc), ctx.g2_dev.host_mul(ss, pk.vk.delta_g2))
        B1 = g1.add(g1.add(pk.beta_g1, b1_acc), g1.mul(ss, pk.delta_g1))
        C = g1.add(l_acc, h_acc)
        C = g1.add(C, g1.mul(ss, A))
        C = g1.add(C, g1.mul(rr, B1))
        C = g1.add(C, g1.neg(g1.mul(rr * ss % r, pk.delta_g1)))
        return Proof(a=A, b=B, c=C)

    def _vk_alpha(self, pk):
        return pk.vk.alpha_g1

    def _debug_check_msms(self, td, qap, z, h_can, a_acc, b2_acc, b1_acc, l_acc, h_acc):
        """Trapdoor-mode stage checks: every prover MSM against its
        expected scalar (exact host Fr arithmetic).  Prints one PASS/FAIL
        line per stage — pinpoints a bad engine without touching pairings."""
        from ..fields.bigint import limbs_to_ints

        ctx = self.ctx
        r, g1 = ctx.r, ctx.g1
        tau, alpha, beta, delta = td["tau"], td["alpha"], td["beta"], td["delta"]
        u, v, w = td["u"], td["v"], td["w"]
        dinv = pow(delta, -1, r)
        a_tau = sum(zi * ui for zi, ui in zip(z, u)) % r
        b_tau = sum(zi * vi for zi, vi in zip(z, v)) % r
        c_tau = sum(zi * wi for zi, wi in zip(z, w)) % r
        l_tau = (
            sum(
                zi * ((beta * ui + alpha * vi + wi) % r)
                for zi, ui, vi, wi in zip(
                    z[qap.ni :], u[qap.ni :], v[qap.ni :], w[qap.ni :]
                )
            )
            * dinv
            % r
        )
        hs = limbs_to_ints(h_can.cpu().numpy())
        h_tau = 0
        for c in reversed(hs):
            h_tau = (h_tau * tau + c) % r
        z_tau = (pow(tau, qap.domain, r) - 1) % r

        def rep(name, ok):
            print(f"[trapdoor] {name}: {'PASS' if ok else 'FAIL'}", flush=True)

        rep("qap_identity h(t)Z(t)==a(t)b(t)-c(t)",
            h_tau * z_tau % r == (a_tau * b_tau - c_tau) % r)
        rep("msm_a", a_acc == g1.mul(a_tau, g1.generator))
        rep("msm_b_g1", b1_acc == g1.mul(b_tau, g1.generator))
        g2d = ctx.g2_dev
        rep("msm_b_g2", b2_acc == g2d.host_mul(b_tau, ctx.g2_gen))
        rep("msm_l", l_acc == g1.mul(l_tau, g1.generator))
        rep("msm_h", h_acc == g1.mul(h_tau * z_tau % r * dinv % r, g1.generator))

    def input_sum(self, vk: VerifyingKey, public_inputs):
        """gamma_abc[0] + sum x_i gamma_abc[i + 1], a host affine point.

        The sum is itself an MSM: it runs on the device for a
        device-resident key, and for a key read from disk (host points)
        once it has DEVICE_INPUT_SUM_MIN inputs or more.  The reference
        keeps a host loop of scalar multiplications for the latter, which
        takes minutes for the tens of thousands of inputs of a large
        Proof of Encryption; the point is the same."""
        ctx = self.ctx
        g1 = ctx.g1
        gabc = vk.gamma_abc_g1
        nabc = int(gabc["x"].shape[0]) if isinstance(gabc, dict) else len(gabc)
        assert len(public_inputs) == nabc - 1, "input length"
        if isinstance(gabc, dict):
            first = ctx.g1_dev.decode_points({k: v[:1] for k, v in gabc.items()})[0]
            rest = {k: v[1:] for k, v in gabc.items()}
        elif nabc - 1 >= DEVICE_INPUT_SUM_MIN:
            first, rest = gabc[0], gabc[1:]
        else:
            acc = gabc[0]
            for x, base in zip(public_inputs, gabc[1:]):
                acc = g1.add(acc, g1.mul(x % ctx.r, base))
            return acc
        return g1.add(first, ctx.msm_g1(nabc - 1).run(rest, [x % ctx.r for x in public_inputs]))

    # ------------------------------------------------------------ verify
    @metrics.timed("groth16.verify")
    def verify(self, vk: VerifyingKey, public_inputs, proof: Proof) -> bool:
        """e(A,B) == e(alpha,beta) * e(acc,gamma) * e(C,delta)."""
        ctx = self.ctx
        g1 = ctx.g1
        acc = self.input_sum(vk, public_inputs)
        eng = ctx.pairing
        lhs = eng.multi_pairing(
            [
                (proof.a, proof.b),
                (g1.neg(acc), vk.gamma_g2),
                (g1.neg(proof.c), vk.delta_g2),
            ]
        )
        rhs = eng.pairing(vk.alpha_g1, vk.beta_g2)
        return lhs == rhs


# Public inputs from which a host-resident verifying key's input sum runs
# as a device MSM (Groth16.input_sum).
DEVICE_INPUT_SUM_MIN = 256

_NTT_CACHE = {}


def _ntt_engine(Fr, d, device):
    key = (Fr.p, d, str(device))
    if key not in _NTT_CACHE:
        _NTT_CACHE[key] = NTT(Fr, d, device=device)
    return _NTT_CACHE[key]


def _sync(t) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
