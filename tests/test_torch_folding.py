"""The folding accumulator and its decider on the port (torch, CPU)
against the JAX package, at the reference tests' own sizes.

  * the PoE-shaped structure `_mini_poe_cs(4, s)` of tests/test_folding.py
    for s = 11, 22, 33 (7 constraints, 13 variables), built by the port's
    circuits/poe_shape.py, equals the reference's;
  * sumcheck (`eq_table`, `eq_point`, round polynomials, challenges,
    finals), `hash_to_g1`, the fold bases, each lifted commitment, each
    fold's cross term, comm_T and rho and the accumulator, a VectorIPA
    proof at n = 16 and a DeciderProof equal the reference's exactly;
  * each side's verifier accepts the other's proofs (groth16/convert.py
    carries the reference's objects over; the reference's dataclasses are
    built from the port's fields the other way), and both reject the
    reference tests' tampered cases: a wrong u, va + 1, and a witness
    that breaks the "sumcheck invariant";
  * `batch_verify` on port-made proofs of tests/test_groth16.py's toy
    circuit agrees with the per-proof `Groth16.verify`;
  * the Groth16 trapdoor aids print six PASS lines, and a FAIL for a
    corrupted accumulator.

Every base count is at most 64 and every vector under 512 entries, so
neither side runs a device MSM or the device cofactor ladder: nothing is
compiled.  The device route (the kernels' twins) is in
tests/test_torch_zz_fold_device.py.
"""

import dataclasses
import functools
import random

import numpy as np
import pytest

from contangle_zkcp_tpu.groth16 import decider as jdec
from contangle_zkcp_tpu.groth16 import folding as jfold
from contangle_zkcp_tpu.groth16 import ipa_vec as jipa
from contangle_zkcp_tpu.groth16 import sumcheck as jsc
from contangle_zkcp_tpu_torch.circuits.poe_shape import mini_poe_cs
from contangle_zkcp_tpu_torch.groth16 import Groth16, Proof
from contangle_zkcp_tpu_torch.groth16 import convert, decider, folding, ipa_vec
from contangle_zkcp_tpu_torch.groth16 import sumcheck as sc
from contangle_zkcp_tpu_torch.groth16.aggregate import batch_verify
from tests.test_folding import _mini_poe_cs as jax_mini_poe_cs
from tests.test_torch_groth16 import toy_circuit
from tests.torch_port_util import one_torch_thread  # noqa: F401

P = folding._R
SEEDS = (11, 22, 33)


def rand_field(n, seed):
    """n field elements from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


# ------------------------------------------------------------- the fold
@functools.lru_cache(maxsize=None)
def jax_side():
    """The reference: three instances lifted, folded as tests/test_decider.py
    folds them ((0+1), then 2), the cross terms and comm_T of each fold."""
    css = [jax_mini_poe_cs(4, s) for s in SEEDS]
    scheme = jfold.FoldingScheme(css[0])
    return (scheme,) + _fold_chain(scheme, css)


@functools.lru_cache(maxsize=None)
def port_side():
    css = [mini_poe_cs(4, s) for s in SEEDS]
    scheme = folding.FoldingScheme(css[0], device="cpu")
    return (scheme,) + _fold_chain(scheme, css)


def _fold_chain(scheme, css):
    lifted = [scheme.instance_from_cs(cs) for cs in css]
    folds, acc = [], lifted[0]
    for nxt in lifted[1:]:
        T = scheme.cross_term(*acc, *nxt)
        comm_t = scheme._commit(scheme.bases_e, T)
        out = scheme.fold(*acc, *nxt)
        folds.append((acc[0], T, comm_t, out))
        acc = out
    return lifted, folds, acc


@pytest.mark.parametrize("seed", SEEDS)
def test_poe_shaped_structure_is_the_reference_structure(seed):
    port, ref = mini_poe_cs(4, seed), jax_mini_poe_cs(4, seed)
    assert port.matrices_coo() == ref.matrices_coo()
    assert port.full_assignment() == ref.full_assignment()
    assert (port.num_constraints, port.num_variables, port.num_instance) == (7, 13, 5)


@pytest.mark.parametrize("i", range(4))
def test_hash_to_g1(i):
    tag = b"contangle-decider-u" if i == 0 else b"test-b"
    assert ipa_vec.hash_to_g1(tag, i) == jipa.hash_to_g1(tag, i)


def test_fold_bases():
    ps, js = port_side()[0], jax_side()[0]
    assert ps.bases_w == js.bases_w and len(ps.bases_w) == 8
    assert ps.bases_e == js.bases_e and len(ps.bases_e) == 7
    assert folding._H1 == jfold._H1
    assert folding._hash_points_raw(b"t", 5) == jfold._hash_points_raw(b"t", 5)


@pytest.mark.parametrize("k", range(3))
def test_lifted_instances(k):
    (pi, pw), (ji, jw) = port_side()[1][k], jax_side()[1][k]
    assert dataclasses.asdict(pi) == dataclasses.asdict(ji)
    assert (pi.comm_w is not None) and pi.comm_e is None and pi.u == 1
    assert (pw.w, pw.e) == (jw.w, jw.e)


@pytest.mark.parametrize("k", range(2))
def test_fold_cross_term_challenge_and_accumulator(k):
    ps, js = port_side()[0], jax_side()[0]
    pprev, pT, pct, (pi, pw) = port_side()[2][k]
    jprev, jT, jct, (ji, jw) = jax_side()[2][k]
    assert pT == jT and len(pT) == 7
    assert pct == jct
    # the second instance is a lifted one (u = 1): the reference's rho is
    # u - u_prev of its accumulator
    nxt = port_side()[1][k + 1][0]
    assert nxt.u == 1 and pprev.u == jprev.u
    assert ps.fold_challenge(pprev, nxt, pct) == (ji.u - jprev.u) % P
    for f in ("comm_w", "comm_e", "u", "x"):
        assert getattr(pi, f) == getattr(ji, f), f
    assert (pw.w, pw.e) == (jw.w, jw.e)
    assert ps.check(pi, pw) and js.check(ji, jw)
    assert pi.u not in (0, 1)


def test_fold_check_rejects_bad_witness():
    ps = port_side()[0]
    acc_i, acc_w = port_side()[3]
    bad = folding.RelaxedWitness(w=list(acc_w.w), e=list(acc_w.e))
    bad.w[3] = (bad.w[3] + 1) % P
    assert not ps.check(acc_i, bad)


# ------------------------------------------------------------- sumcheck
@pytest.mark.parametrize("s", [1, 3, 4])
def test_eq_table_and_eq_point(s):
    taus = rand_field(s, seed=s)
    tbl = sc.eq_table(P, taus)
    assert tbl == jsc.eq_table(P, taus)
    for i in range(1 << s):
        bits = [(i >> (s - 1 - j)) & 1 for j in range(s)]
        assert tbl[i] == sc.eq_point(P, taus, bits) == jsc.eq_point(P, taus, bits)
    other = rand_field(s, seed=100 + s)
    assert sc.eq_point(P, taus, other) == jsc.eq_point(P, taus, other)


SUMCHECKS = {
    "sum": (1, lambda v: v[0] % P),
    "product": (2, lambda v: v[0] * v[1] % P),
    "outer": (3, lambda v: v[0] * ((v[1] * v[2] - v[3]) % P) % P),
}


@pytest.mark.parametrize("name", SUMCHECKS)
def test_sumcheck_rounds_challenges_and_finals(name):
    degree, combine = SUMCHECKS[name]
    s = 4
    ntab = {1: 1, 2: 2, 3: 4}[degree]
    tables = [rand_field(1 << s, seed=10 * degree + t) for t in range(ntab)]
    claimed = sum(combine([t[i] for t in tables]) for i in range(1 << s)) % P
    out = sc.prove(P, tables, combine, degree, claimed, decider.DeciderTranscript(b"t"))
    assert out == jsc.prove(P, tables, combine, degree, claimed, jdec.DeciderTranscript(b"t"))
    polys, rs, finals, final_claim = out
    assert sc._lagrange_at(P, polys[0], rs[0]) == jsc._lagrange_at(P, polys[0], rs[0])
    # each side's verifier replays the other's rounds
    assert sc.verify(P, claimed, degree, s, polys, decider.DeciderTranscript(b"t")) == (rs, final_claim)
    assert jsc.verify(P, claimed, degree, s, polys, jdec.DeciderTranscript(b"t")) == (rs, final_claim)
    assert final_claim == combine(finals)
    bad = [list(ev) for ev in polys]
    bad[1][0] = (bad[1][0] + 1) % P
    for mod, tr in ((sc, decider.DeciderTranscript), (jsc, jdec.DeciderTranscript)):
        with pytest.raises(ValueError):
            mod.verify(P, claimed, degree, s, bad, tr(b"t"))
        with pytest.raises(ValueError):
            mod.verify(P, claimed, degree, s + 1, polys, tr(b"t"))


# ----------------------------------------------------------- vector IPA
def _jax_ipa_proof(proof):
    """The reference's VecIpaProof from the port's fields."""
    return jipa.VecIpaProof(rounds=list(proof.rounds), a_final=proof.a_final)


def test_vector_ipa_proof_and_cross_verification():
    n = 16
    bases = [ipa_vec.hash_to_g1(b"test-b", i) for i in range(n)]
    port = ipa_vec.VectorIPA(bases, device="cpu")
    ref = jipa.VectorIPA(bases, use_device_msm=False)
    vec, b = rand_field(n, seed=4), rand_field(n, seed=5)
    comm = port.commit(vec)
    assert comm == ref.commit(vec)
    v = sum(x * y for x, y in zip(vec, b)) % P
    proof = port.open(vec, b, decider.DeciderTranscript(b"i"))
    jproof = ref.open(vec, b, jdec.DeciderTranscript(b"i"))
    assert proof.rounds == jproof.rounds and len(proof.rounds) == 4
    assert proof.a_final == jproof.a_final
    assert port.verify(comm, b, v, convert.ipa_proof_from_reference(jproof), decider.DeciderTranscript(b"i"))
    assert ref.verify(comm, b, v, _jax_ipa_proof(proof), jdec.DeciderTranscript(b"i"))
    assert not port.verify(comm, b, (v + 1) % P, proof, decider.DeciderTranscript(b"i"))
    assert not port.verify(comm, b, v, proof, decider.DeciderTranscript(b"j"))


# -------------------------------------------------------------- decider
@functools.lru_cache(maxsize=None)
def deciders():
    """Both packages' deciders and proofs of their own accumulators, and
    the port's proof of the reference's accumulator carried over."""
    ps, js = port_side()[0], jax_side()[0]
    pdec, jdecd = decider.Decider(ps), jdec.Decider(js, use_device_msm=False)
    pacc, jacc = port_side()[3], jax_side()[3]
    pproof, jproof = pdec.prove(*pacc), jdecd.prove(*jacc)
    carried = pdec.prove(convert.instance_from_reference(jacc[0]),
                         convert.witness_from_reference(jacc[1]))
    return pdec, jdecd, pproof, jproof, carried


def _jax_decider_proof(proof):
    """The reference's DeciderProof from the port's fields."""
    fields = dataclasses.asdict(proof)
    fields["open_e"] = _jax_ipa_proof(proof.open_e)
    fields["open_w"] = _jax_ipa_proof(proof.open_w)
    return jdec.DeciderProof(**fields)


def _jax_instance(inst):
    return jfold.RelaxedInstance(**dataclasses.asdict(inst))


def test_decider_proof_equals_the_reference_field_by_field():
    pdec, jdecd, pproof, jproof, carried = deciders()
    assert (pdec.NC, pdec.NZ, pdec.ipa_w.n, pdec.ipa_e.n) == (jdecd.NC, jdecd.NZ, 8, 8)
    assert pdec.ipa_w.G == jdecd.ipa_w.G and pdec.ipa_e.U == jdecd.ipa_e.U
    for f in ("outer_polys", "va", "vb", "vc", "ve", "inner_polys", "vz"):
        assert getattr(pproof, f) == getattr(jproof, f), f
    for f in ("open_e", "open_w"):
        assert getattr(pproof, f).rounds == getattr(jproof, f).rounds, f
        assert getattr(pproof, f).a_final == getattr(jproof, f).a_final, f
    assert len(pproof.outer_polys) == 3 and len(pproof.inner_polys) == 4
    # the reference's accumulator, decided by the port, gives the same proof
    assert dataclasses.asdict(carried) == dataclasses.asdict(pproof)


@pytest.mark.parametrize("verifier", ["port", "jax"])
def test_each_side_verifies_the_others_decider_proof(verifier):
    pdec, jdecd, pproof, jproof, _ = deciders()
    pacc, jacc = port_side()[3], jax_side()[3]
    if verifier == "port":
        inst = convert.instance_from_reference(jacc[0])
        assert pdec.verify(inst, convert.decider_proof_from_reference(jproof))
        assert pdec.verify(pacc[0], pproof)
    else:
        assert jdecd.verify(_jax_instance(pacc[0]), _jax_decider_proof(pproof))
        assert jdecd.verify(jacc[0], jproof)


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("case", ["wrong_u", "va_plus_1", "unsatisfied_witness"])
def test_both_sides_reject_the_tampered_cases(side, case):
    pdec, jdecd, pproof, jproof, _ = deciders()
    dec, proof = (pdec, pproof) if side == "port" else (jdecd, jproof)
    acc_i, acc_w = port_side()[3] if side == "port" else jax_side()[3]
    if case == "wrong_u":
        assert not dec.verify(dataclasses.replace(acc_i, u=(acc_i.u + 1) % P), proof)
    elif case == "va_plus_1":
        assert not dec.verify(acc_i, dataclasses.replace(proof, va=(proof.va + 1) % P))
    else:
        bad = dataclasses.replace(acc_w, w=[(acc_w.w[0] + 1) % P] + list(acc_w.w[1:]))
        with pytest.raises(AssertionError, match="sumcheck invariant"):
            dec.prove(acc_i, bad)


# ------------------------------------------------ aggregation, trapdoor
@functools.lru_cache(maxsize=None)
def toy_proofs():
    """Three port-made proofs of the toy circuit under one key (CPU)."""
    eng = Groth16("bls12_381", device="cpu")
    rng = random.Random(111)
    pk, vk = eng.setup(toy_circuit(eng.ctx.r), rng)
    statements = []
    for i in range(3):
        cs = toy_circuit(eng.ctx.r, x=3 + i, y=5 + i)
        statements.append((cs.public_inputs(), eng.prove(pk, cs, rng)))
    return eng, vk, statements


def _tamper(eng, statements, case):
    statements = list(statements)
    if case == "tampered_proof":
        g1 = eng.ctx.g1
        inputs, proof = statements[1]
        statements[1] = (inputs, Proof(a=g1.add(proof.a, g1.generator), b=proof.b, c=proof.c))
    elif case == "wrong_input_count":
        inputs, proof = statements[2]
        statements[2] = (inputs + [0], proof)
    return statements


@pytest.mark.parametrize("case", ["valid", "tampered_proof", "wrong_input_count"])
def test_batch_verify_agrees_with_per_proof_verify(case):
    eng, vk, statements = toy_proofs()
    statements = _tamper(eng, statements, case)
    want = case == "valid"
    per_proof = [
        len(inputs) == len(vk.gamma_abc_g1) - 1 and eng.verify(vk, inputs, proof)
        for inputs, proof in statements
    ]
    assert all(per_proof) == want
    assert batch_verify(vk, statements, rng=random.Random(7), device="cpu") == want
    assert batch_verify(vk, [], device="cpu")


@pytest.mark.parametrize("case", ["pass", "corrupt_msm_a", "crash"])
def test_trapdoor_checks(case, monkeypatch, capsys):
    eng = Groth16("bls12_381", device="cpu")
    rng = random.Random(20260819)
    cs = toy_circuit(eng.ctx.r)
    pk, vk = eng.setup(cs, rng, debug_trapdoor=True)
    assert set(pk.trapdoor) == {"alpha", "beta", "gamma", "delta", "tau", "u", "v", "w"}
    check = eng._debug_check_msms
    if case == "corrupt_msm_a":
        g1 = eng.ctx.g1

        def corrupted(td, qap, z, h_can, a_acc, *rest):
            return check(td, qap, z, h_can, g1.add(a_acc, g1.generator), *rest)

        monkeypatch.setattr(eng, "_debug_check_msms", corrupted)
    elif case == "crash":
        def crashing(*_):
            raise RuntimeError("boom")

        monkeypatch.setattr(eng, "_debug_check_msms", crashing)
    proof = eng.prove(pk, cs, rng)
    assert eng.verify(vk, cs.public_inputs(), proof)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[trapdoor]")]
    if case == "crash":
        assert lines == ["[trapdoor] check crashed: RuntimeError('boom')"]
        return
    names = ["qap_identity h(t)Z(t)==a(t)b(t)-c(t)", "msm_a", "msm_b_g1", "msm_b_g2", "msm_l", "msm_h"]
    want = ["FAIL" if case == "corrupt_msm_a" and n == "msm_a" else "PASS" for n in names]
    assert lines == [f"[trapdoor] {n}: {w}" for n, w in zip(names, want)]
