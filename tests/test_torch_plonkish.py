"""The port's PLONKish modules (contangle_zkcp_tpu_torch/plonkish/) against
the JAX package's, where the reference runs without compiling anything:
its host code (the circuit model, MockProver, the Blake2b transcript,
Poseidon-Pow5, the ECC chip's tables and gates, the IPA's host paths).
Exact equality throughout.  Checks that need the JAX prover or minutes
of CPU time are in the one-test files test_torch_prove_jax.py,
test_torch_quotient_jax.py and test_torch_proof_ipa.py, which the suite
schedules last.
"""

import json
import os
import random

import pytest

from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu.plonkish import ecc_chip as jecc
from contangle_zkcp_tpu.plonkish import elgamal_circuit as jel
from contangle_zkcp_tpu.plonkish import ipa as jipa
from contangle_zkcp_tpu.plonkish import mock as jmock
from contangle_zkcp_tpu.plonkish import poseidon_pow5 as jpos
from contangle_zkcp_tpu.plonkish import transcript as jtr
from contangle_zkcp_tpu.plonkish.circuit import Assignment as JAssignment
from contangle_zkcp_tpu.plonkish.circuit import CircuitMeta as JCircuitMeta
from contangle_zkcp_tpu_torch.fields import instances as fi
from contangle_zkcp_tpu_torch.plonkish import ecc_chip, ipa, poseidon_pow5, transcript
from contangle_zkcp_tpu_torch.plonkish.circuit import Assignment, CircuitMeta, Expr
from contangle_zkcp_tpu_torch.plonkish.convert import fields
from contangle_zkcp_tpu_torch.plonkish.elgamal_circuit import ElGamalCircuit, ElGamalPallas
from contangle_zkcp_tpu_torch.plonkish.mock import MockProver
from contangle_zkcp_tpu_torch.plonkish.prover import P, PlonkSystem, _coeffs_from_evals
from tests.torch_port_util import one_torch_thread  # noqa: F401

PORT_DIR = os.path.dirname(os.path.abspath(ecc_chip.__file__))


def elgamal(mods, seed, n=128):
    """The ElGamal circuit at n rows, built with either package's classes
    (Assignment, CircuitMeta, ElGamalCircuit, ElGamalPallas)."""
    A, M, E, S = mods
    scheme = S()
    rng = random.Random(seed)
    _, pk = scheme.keygen(rng)
    r = rng.randrange(1, scheme.curve.order)
    m = rng.randrange(scheme.curve.p)
    (c1, c2), s = scheme.encrypt(pk, m, r)
    meta = M(p=fi.PASTA_P)
    circ = E.build(meta, s, c1, m, c2)
    asg = A(meta, n)
    circ.synthesize(meta, asg)
    return meta, asg, [[c1[0], c1[1], c2]]


PORT_MODS = (Assignment, CircuitMeta, ElGamalCircuit, ElGamalPallas)
JAX_MODS = (JAssignment, JCircuitMeta, jel.ElGamalCircuit, jel.ElGamalPallas)


def test_mock_prover_accepts_elgamal_and_rejects_tampering():
    meta, asg, inst = elgamal(PORT_MODS, 92)
    jmeta, jasg, jinst = elgamal(JAX_MODS, 92)
    assert inst == jinst and asg.advice == jasg.advice and asg.fixed == jasg.fixed
    assert asg.copies == jasg.copies and asg.instance_cells == jasg.instance_cells
    assert MockProver(meta, asg, inst).verify() == [] == jmock.MockProver(jmeta, jasg, jinst).verify()
    bad = [[inst[0][0], inst[0][1], (inst[0][2] + 1) % fi.PASTA_P]]
    asg.advice[0][5] = (asg.advice[0][5] + 1) % fi.PASTA_P
    jasg.advice[0][5] = (jasg.advice[0][5] + 1) % fi.PASTA_P
    for i in (bad, inst):
        got = MockProver(meta, asg, i).verify()
        assert got and got == jmock.MockProver(jmeta, jasg, i).verify()


def test_transcript_bytes_equal_the_reference():
    rng = random.Random(4)
    C = ipa.CURVE
    ours, theirs = transcript.Blake2bTranscript(), jtr.Blake2bTranscript()
    outs = []
    for step in range(12):
        pt = None if step == 3 else C.mul(rng.randrange(1, C.order), C.generator)
        s = rng.randrange(1 << 300)  # reduced mod PASTA_P when absorbed
        for t in (ours, theirs):
            t.common_point(pt)
            t.common_scalar(s)
        outs.append((ours.squeeze_challenge(), theirs.squeeze_challenge()))
        assert ours._state.digest() == theirs._state.digest()
    assert all(a == b for a, b in outs)


def test_poseidon_pow5_matches_pinned_tables_and_reference():
    with open(os.path.join(PORT_DIR, "pow5_pinned_pasta.json")) as f:
        pinned = json.load(f)
    rc, mds = poseidon_pow5.pow5_constants(fi.PASTA_P)
    assert int(pinned["p"], 16) == fi.PASTA_P
    assert [[int(v, 16) for v in row] for row in pinned["round_constants"]] == rc
    assert (rc, mds) == jpos.pow5_constants(jfi.PASTA_P)
    ours, theirs = poseidon_pow5.PoseidonPow5Host(), jpos.PoseidonPow5Host()
    rng = random.Random(6)
    for _ in range(4):
        a, b = rng.randrange(fi.PASTA_P), rng.randrange(fi.PASTA_P)
        assert ours.hash2(a, b) == theirs.hash2(a, b)


def test_ecc_chip_tables_and_constraints_equal_the_reference():
    tables, jtables = ecc_chip.build_tables(), jecc.build_tables()
    assert tables.__dict__ == jtables.__dict__
    meta, jmeta = CircuitMeta(p=fi.PASTA_P), JCircuitMeta(p=jfi.PASTA_P)
    chip, jchip = ecc_chip.EccChip(meta, tables), jecc.EccChip(jmeta, jtables)
    k = random.Random(9).randrange(1 << 255)
    asg, jasg = Assignment(meta, 128), JAssignment(jmeta, 128)
    row, pt = chip.assign_mul(asg, k)
    assert (row, pt) == jchip.assign_mul(jasg, k)
    assert pt == ecc_chip.CURVE.mul(k % ecc_chip.ORDER, ecc_chip.CURVE.generator)
    assert asg.advice == jasg.advice and asg.fixed == jasg.fixed and asg.copies == jasg.copies
    assert MockProver(meta, asg, []).verify() == []
    asg.advice[chip.y_col.index][7] = (asg.advice[chip.y_col.index][7] + 1) % fi.PASTA_P
    assert MockProver(meta, asg, []).verify() != []


def test_ipa_matches_reference_host_paths():
    """Commitments at 256 generators (the port's MSM on the CPU's twins,
    the reference's host sum) and an opening through a shared transcript
    at 32 generators (both on the host); the port verifies its opening."""
    rng = random.Random(3)
    coeffs = [rng.randrange(fi.PASTA_P) if i % 4 == 0 else 0 for i in range(256)]
    x = rng.randrange(fi.PASTA_P)
    ours = ipa.IPA(256, use_device_msm=True, device="cpu")
    theirs = jipa.IPA(256)
    assert ours.G == theirs.G and ours.U == theirs.U
    assert ours.commit(coeffs) == theirs.commit(coeffs)
    small, jsmall = ipa.IPA(32), jipa.IPA(32)
    c = [rng.randrange(fi.PASTA_P) for _ in range(32)]
    proof = small.open(c, x, transcript=transcript.Blake2bTranscript())
    jproof = jsmall.open(c, x, transcript=jtr.Blake2bTranscript())
    assert fields(proof) == fields(jproof)
    v = sum(ci * pow(x, i, fi.PASTA_P) for i, ci in enumerate(c)) % fi.PASTA_P
    assert small.verify(small.commit(c), x, v, proof, transcript=transcript.Blake2bTranscript())
    assert not small.verify(small.commit(c), x, (v + 1) % fi.PASTA_P, proof,
                            transcript=transcript.Blake2bTranscript())


def lookup_gate_circuit(n=16):
    """A small circuit with every quotient term live: a gate with a
    rotation and a constant, a lookup into a fixed table, an instance
    column with a copy; the witness need not satisfy it (the quotient is
    a function of any tables)."""
    meta = CircuitMeta(p=P)
    a, b = meta.advice_column(), meta.advice_column()
    q, table = meta.selector(), meta.fixed_column()
    inst = meta.instance_column()
    meta.create_gate("g", [Expr.col(q) * (Expr.col(a.at(1)) - Expr.col(a) * Expr.col(b) + 3)])
    meta.lookup("range", [(Expr.col(b), Expr.col(table))])
    asg = Assignment(meta, n)
    rng = random.Random(11)
    for r in range(n):
        asg.assign(a, r, rng.randrange(P))
        asg.assign(b, r, r % 4)
        asg.assign(table, r, r % 8)
        if r % 3 == 0:
            asg.enable(q, r)
    asg.copy(a, 2, b, 5)
    asg.constrain_instance(a, 0, inst, 0)
    return meta, asg, [[asg.advice[0][0]]]


def test_quotient_device_equals_host_path():
    """QuotientDevice on the CPU (K1's twin) equals _quotient_host."""
    meta, asg, inst = lookup_gate_circuit()
    system = PlonkSystem(meta, 16, asg, device="cpu")
    rng = random.Random(9)
    n = system.n
    dev = system.device
    advice = [system._blind(_coeffs_from_evals(list(c), dev), rng) for c in asg.advice]
    inst_polys = [_coeffs_from_evals(list(c) + [0] * (n - len(c)), dev) for c in inst]
    z = system._blind(_coeffs_from_evals([1] * n, dev), rng)
    theta, beta, gamma, alpha = (rng.randrange(1, P) for _ in range(4))
    lookups = [{"ap_poly": system._blind(_coeffs_from_evals([rng.randrange(8) for _ in range(n)], dev), rng),
                "sp_poly": system._blind(_coeffs_from_evals([rng.randrange(8) for _ in range(n)], dev), rng),
                "z_poly": system._blind(_coeffs_from_evals([1] * n, dev), rng)}]
    args = (advice, inst_polys, z, lookups, theta, beta, gamma, alpha)
    want = system._quotient_host(*args)
    assert system._quotient_device(*args) == want
    assert len(want) == n * system.ext and any(want)


@pytest.mark.parametrize("use_device", [False, True])
def test_small_proof_verifies_and_binds_its_instance(use_device):
    """The lookup circuit with a satisfying witness, proved and verified
    on the CPU on both paths (host and twins); a tampered instance is
    refused."""
    meta = CircuitMeta(p=P)
    val, table = meta.advice_column(), meta.fixed_column()
    inst = meta.instance_column()
    meta.lookup("range16", [(Expr.col(val), Expr.col(table))])
    n = 16
    asg = Assignment(meta, n)
    rng = random.Random(5)
    for r in range(n):
        asg.assign(table, r, r % 16)
        asg.assign(val, r, rng.randrange(16))
    asg.constrain_instance(val, 0, inst, 0)
    instances = [[asg.advice[0][0]]]
    assert MockProver(meta, asg, instances).verify() == []
    system = PlonkSystem(meta, n, asg, use_device=use_device, device="cpu")
    proof = system.prove(asg, instances, rng=random.Random(100))
    assert system.verify(proof, instances)
    assert not system.verify(proof, [[(instances[0][0] + 1) % P]])


PHASE_TIMERS = ("plonk.lookups", "plonk.grand_products", "plonk.quotient", "plonk.evals")


@pytest.mark.parametrize("fault", [None, "lookups"], ids=["normal", "raise_in_lookups"])
def test_prover_phase_timers(fault, monkeypatch):
    """The prover's four phase timers are `with` blocks: a small prove
    records each of them once; a step inside `plonk.lookups` that raises
    reaches the caller unchanged, with that timer closed (recorded) and
    no later phase begun."""
    from contangle_zkcp_tpu_torch.utils import metrics

    meta = CircuitMeta(p=P)
    val, table = meta.advice_column(), meta.fixed_column()
    inst = meta.instance_column()
    meta.lookup("range16", [(Expr.col(val), Expr.col(table))])
    n = 16
    asg = Assignment(meta, n)
    rng = random.Random(5)
    for r in range(n):
        asg.assign(table, r, r % 16)
        asg.assign(val, r, rng.randrange(16))
    asg.constrain_instance(val, 0, inst, 0)
    instances = [[asg.advice[0][0]]]
    system = PlonkSystem(meta, n, asg, device="cpu")
    boom = RuntimeError("lookup step failed")
    if fault:
        def failing(*_):
            raise boom

        monkeypatch.setattr(system, "_permute_lookup", failing)
    metrics.registry().reset()
    if fault:
        with pytest.raises(RuntimeError) as err:
            system.prove(asg, instances, rng=random.Random(100))
        assert err.value is boom
    else:
        assert system.verify(system.prove(asg, instances, rng=random.Random(100)), instances)
    timers = metrics.registry().snapshot()["timers"]
    got = {name: timers.get(name, {}).get("count", 0) for name in PHASE_TIMERS}
    want = {name: 1 for name in PHASE_TIMERS}
    if fault:
        want = {name: int(name == "plonk.lookups") for name in PHASE_TIMERS}
    assert got == want
