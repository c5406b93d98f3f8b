"""The port's circom layer and Proof of Property (contangle_zkcp_tpu_torch
circomx/ and zkcp/property.py) against the JAX package's, on the CPU:
r1cs bytes, the wasm interpreter and the circom witness ABI, the witness
solvers, the composed constraint system and the mock round trip.  Host
Python only, seconds in all; the real Groth16 round trip sits in
tests/test_torch_property_groth16.py (minutes on the kernels' twins).
"""

import dataclasses
import random
import struct

import pytest

from contangle_zkcp_tpu.circomx import r1cs_format as j_r1cs
from contangle_zkcp_tpu.circomx import wasm as j_wasm
from contangle_zkcp_tpu.circomx import witness_calc as j_wc
from contangle_zkcp_tpu.circomx import wrapper as j_wrapper
from contangle_zkcp_tpu.circomx.dummy import compile_dummy as j_compile_dummy
from contangle_zkcp_tpu.circomx.dummy import dummy_signal_map as j_signal_map
from contangle_zkcp_tpu.circomx.dummy import dummy_witness as j_dummy_witness
from contangle_zkcp_tpu.circuits import elgamal as j_elgamal
from contangle_zkcp_tpu.curves import instances as jci
from contangle_zkcp_tpu.fields import instances as jfi
from contangle_zkcp_tpu.utils.errors import ProofError as JProofError
from contangle_zkcp_tpu.zkcp.config import CircomParams as JCircomParams
from contangle_zkcp_tpu.zkcp.property import ZkPropertyVerifier as JZkPropertyVerifier
from contangle_zkcp_tpu_torch.circomx import (
    CircomBuilder,
    CircomConfig,
    compile_dummy,
    dummy_signal_map,
    dummy_witness,
    read_r1cs,
    write_r1cs,
)
from contangle_zkcp_tpu_torch.circomx import wasm
from contangle_zkcp_tpu_torch.circomx.witness_calc import WitnessCalculator, fnv1a_64
from contangle_zkcp_tpu_torch.circuits import elgamal
from contangle_zkcp_tpu_torch.curves import instances as ci
from contangle_zkcp_tpu_torch.fields import instances as fi
from contangle_zkcp_tpu_torch.utils.errors import ProofError, SerializationError
from contangle_zkcp_tpu_torch.zkcp import ZkPropertyVerifier
from contangle_zkcp_tpu_torch.zkcp.config import CircomParams
from tests.test_circom_nonlinear import _expected, _zkphoto_shaped
from tests.test_wasm_independent import MODULE as INDEPENDENT_MODULE
from tests.wasm_fixture import build_module, fixture_r1cs

PRIMES = {"bn254": fi.BN254_R, "bls12_381": fi.BLS12_381_R}


def _to_port(j_file):
    """A JAX-package R1csFile crosses as its write_r1cs bytes."""
    return read_r1cs(j_r1cs.write_r1cs(j_file))


# ------------------------------------------------------------------- r1cs
@pytest.mark.parametrize("prime", sorted(PRIMES))
@pytest.mark.parametrize("n", [1, 8, 100])
def test_r1cs_bytes_equal(n, prime):
    p = PRIMES[prime]
    assert jfi.BN254_R == fi.BN254_R and jfi.BLS12_381_R == fi.BLS12_381_R
    mine, theirs = compile_dummy(n, p), j_compile_dummy(n, p)
    data = write_r1cs(mine)
    assert data == j_r1cs.write_r1cs(theirs)
    for back in (read_r1cs(data), j_r1cs.read_r1cs(data)):
        assert (back.prime, back.n_wires, back.n_prv_in, back.n_labels) == (p, n + 3, n + 2, n + 3)
        assert back.constraints == mine.constraints and back.wire2label == mine.wire2label
    pt = list(range(p - 1, p - 1 - n, -1))
    assert dummy_witness(n, p, p + 3, pt, 9) == j_dummy_witness(n, p, p + 3, pt, 9) == [1, 3] + pt + [9]
    # cut short anywhere: the port raises SerializationError; the JAX
    # package raises too wherever the header or a constraint is cut
    header_end = 12 + 12 + 4 + mine.field_bytes() + 28
    for cut in range(len(data)):
        with pytest.raises(SerializationError):
            read_r1cs(data[:cut])
    for cut in (0, 3, 10, header_end - 1, header_end + 20, header_end + 40):
        with pytest.raises((j_r1cs.SerializationError, struct.error)):
            j_r1cs.read_r1cs(data[:cut])


# ------------------------------------------------------- wasm interpreter
MODULES = {"fixture": build_module(), "independent": INDEPENDENT_MODULE}
INPUTS = {
    "fixture": [{"something": 7, "other": 11}, {"something": 3, "other": 5}, {"something": 0, "other": 9}],
    "independent": [{"in": x} for x in (0, 1, 3, 1000, 2**19)],
}


def _outcome(fn):
    """A call's result, or the kind of its trap."""
    try:
        return "ok", fn()
    except (wasm.WasmTrap, j_wasm.WasmTrap):
        return "trap", None
    except (ProofError, JProofError):
        return "proof_error", None


@pytest.mark.parametrize("name", sorted(MODULES))
def test_wasm_module_equal(name):
    data = MODULES[name]
    assert dataclasses.asdict(wasm.parse_module(data)) == dataclasses.asdict(j_wasm.parse_module(data))
    mine, theirs = WitnessCalculator(data), j_wc.WitnessCalculator(data)
    assert (mine.n32, mine.prime) == (theirs.n32, theirs.prime) == (8, fi.BN254_R)
    for inputs in INPUTS[name]:
        got = mine.calculate_witness(inputs)
        assert got == theirs.calculate_witness(inputs)
        # the same instance's memory, globals and exports after the run
        assert mine.inst.mem == theirs.inst.mem
        assert [g for g in mine.inst.globals] == [g for g in theirs.inst.globals]
    # traps: an unknown signal, a witness index past the end, a read
    # past the shared buffer
    n_wit = len(got)
    probes = [
        (lambda c: c.calculate_witness({"nonsense": 1})),
        (lambda c: c.inst.invoke("getWitness", n_wit + 2)),
        (lambda c: c.inst.invoke("readSharedRWMemory", 1 << 20)),
    ]
    for probe in probes:
        a = _outcome(lambda: probe(WitnessCalculator(data)))
        b = _outcome(lambda: probe(j_wc.WitnessCalculator(data)))
        assert a == b


@pytest.mark.parametrize("name", ["", "a", "in", "something", "main.plaintext[3]", "ü"])
def test_fnv1a_64_equal(name):
    assert fnv1a_64(name) == j_wc.fnv1a_64(name)


# ----------------------------------------------------------- witness solve
def _solve_both(j_cfg, cfg, variables=None, inputs=None, assign=None):
    """solve_witness's outcome in the port and in the JAX package, after
    the same push_variable and push_input calls (and direct wire
    assignments); asserts that the two agree."""
    out = []
    for builder in (CircomBuilder(cfg), j_wrapper.CircomBuilder(j_cfg)):
        for name, v in (variables or {}).items():
            builder.push_variable(name, v)
        for name, v in (inputs or {}).items():
            builder.push_input(name, v)
        builder.assignments.update(assign or {})
        out.append(_outcome(builder.solve_witness))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("x", [13, 7, 0, 15])
def test_solve_witness_propagation_equal(x):
    """tests/test_circom_nonlinear.py's circuit: products, squares and the
    Num2Bits hint, solved without wasm."""
    j_cfg = _zkphoto_shaped()
    cfg = CircomConfig(r1cs=_to_port(j_cfg.r1cs), signal_map=dict(j_cfg.signal_map), sanity_check=True)
    kind, wit = _solve_both(j_cfg, cfg, inputs={"in": x})
    out, u, bits, t = _expected(x)
    assert kind == "ok" and wit[1] == out and wit[3] == u and wit[4:12] == bits and wit[12] == t


@pytest.mark.parametrize("case", [(9, 13), (2, 3), "disagree"], ids=str)
def test_solve_witness_wasm_equal(case):
    """The wasm path: wasm_fixture's generator for its circuit; a direct
    assignment that contradicts the generator raises in both."""
    signal_map = {"something": 2, "other": 3, "challenge": 1}
    j_cfg = j_wrapper.CircomConfig(r1cs=fixture_r1cs(), signal_map=signal_map,
                                   sanity_check=True, wasm=build_module())
    cfg = CircomConfig(r1cs=_to_port(fixture_r1cs()), signal_map=signal_map,
                       sanity_check=True, wasm=build_module())
    s, o = (9, 13) if case == "disagree" else case
    got = _solve_both(j_cfg, cfg, inputs={"something": s, "other": o},
                      assign={1: 5} if case == "disagree" else None)
    assert got == (("proof_error", None) if case == "disagree" else ("ok", [1, s * o * s, s, o, s * o]))


@pytest.mark.parametrize("pushes", [
    {"plaintext": [3, 7, 9], "something": 3, "challenge": 9},
    {"plaintext": [5, 0, 0, 0], "something": 5},  # challenge solved from something^2
    {"plaintext": [4], "something": 3, "challenge": 9},  # violates plaintext[0] == something
    {"plaintext": [3], "something": 3, "challenge": 10},  # violates challenge == something^2
], ids=["true", "solved", "false_plaintext", "false_challenge"])
def test_solve_witness_dummy_equal(pushes):
    n, p = 8, fi.BLS12_381_R
    j_cfg = j_wrapper.CircomConfig(r1cs=j_compile_dummy(n, p), signal_map=j_signal_map(n), sanity_check=True)
    cfg = CircomConfig(r1cs=compile_dummy(n, p), signal_map=dummy_signal_map(n), sanity_check=True)
    inputs = {k: v for k, v in pushes.items() if k != "plaintext"}
    kind, _ = _solve_both(j_cfg, cfg, variables={"plaintext": pushes["plaintext"]}, inputs=inputs)
    s = pushes["something"]
    truth = pushes["plaintext"][0] == s and pushes.get("challenge", s * s) == s * s
    assert kind == ("ok" if truth else "proof_error")


# --------------------------------------------------------- the composition
def _verifiers(tmp_path, n, backend):
    missing = str(tmp_path / "no_such.r1cs")
    mine = ZkPropertyVerifier(tmp_path / "port", CircomParams(r1cs_path=missing), n,
                              backend=backend, device="cpu")
    theirs = JZkPropertyVerifier(tmp_path / "jax", JCircomParams(r1cs_path=missing), n, backend=backend)
    return mine, theirs


@pytest.mark.parametrize("n", [4, 8])
def test_compose_equal(tmp_path, n):
    """The composed system (dummy circom LCs, then the encryption circuit
    merged after them) has the JAX package's matrices and assignment."""
    mine, theirs = _verifiers(tmp_path, n, "mock")
    params = elgamal.ElGamalParams(curve=ci.JUBJUB, n=n)
    sk, pk = elgamal.keygen(params, random.Random(n))
    rng = random.Random(100 + n)
    msg = [rng.randrange(1, 256) for _ in range(n)]
    r = elgamal.random_scalar(params, rng)
    cipher = elgamal.encrypt(params, pk, msg, r)
    args = {"something": msg[0], "challenge": msg[0] ** 2}
    cs, circom = mine._compose(pk, msg, r, cipher, args)
    j_cs, j_circom = theirs._compose(pk, msg, r, cipher, args)
    assert cs.matrices_coo() == j_cs.matrices_coo()
    assert cs.full_assignment() == j_cs.full_assignment()
    assert circom.witness == j_circom.witness == [1, msg[0]] + msg + [msg[0] ** 2]
    assert cs.num_constraints == j_cs.num_constraints
    assert cs.is_satisfied()


def test_property_mock_round_trip(tmp_path):
    """backend="mock" (tests/test_circom.py's round trip): the same
    ciphertext and proof bytes as the JAX package, accepted by both
    verifiers; a flipped ciphertext byte and a false property are not."""
    n = 8
    mine, theirs = _verifiers(tmp_path, n, "mock")
    for v in (mine, theirs):
        v.compile()
    params = elgamal.ElGamalParams(curve=ci.JUBJUB, n=n)
    sk, pk = elgamal.keygen(params, random.Random(82))
    msg = bytes([5, 1, 2, 3])
    args = {"something": 5, "challenge": 25}
    cipher, pop = mine.assess_property_and_encrypt(msg, sk, pk, args, random.Random(7))
    j_cipher, j_pop = theirs.assess_property_and_encrypt(msg, sk, pk, args, random.Random(7))
    assert (cipher, pop.to_json()) == (j_cipher, j_pop.to_json())
    assert mine.verify_proof(pop, cipher) and theirs.verify_proof(pop, cipher)
    bad = cipher[:-1] + bytes([cipher[-1] ^ 1])
    assert not mine.verify_proof(pop, bad) and not theirs.verify_proof(pop, bad)
    for v, err in ((mine, ProofError), (theirs, JProofError)):
        with pytest.raises(err):
            v.assess_property_and_encrypt(msg, sk, pk, {"something": 5, "challenge": 26}, random.Random(7))
    assert jci.JUBJUB.p == ci.JUBJUB.p
