"""Programmatic compilation of the reference's DummyProperty circuit.

Port of `contangle_zkcp_tpu/circomx/dummy.py`.

The reference builds circom circuits with a private patched compiler
("HACKED_CIRCOM_PATH", nulltea/contangle-zkcp:circom/Makefile:1-4) whose
artifacts are not in its repository, so we compile the shipped dummy.circom
(nulltea/contangle-zkcp:circom/dummy.circom:1-13) programmatically into the same
r1cs layout a circom 2 compiler produces:

  template DummyProperty(n):
      signal input something; signal input plaintext[n];
      signal input challenge;
      plaintext[0] === something;
      challenge === something * something;

Wire layout (circom 2, no public list on main => all inputs private):
  0 = constant one; 1 = something; 2..n+1 = plaintext[0..n-1];
  n+2 = challenge.
Constraints in circom's A*B = C normal form over the chosen prime
(BN254 Fr for stock circom; BLS12-381 Fr for the reference's hacked
variant).
"""

from __future__ import annotations

from ..fields import instances as fi
from .r1cs_format import R1csFile

SIGNALS = ("something", "plaintext", "challenge")


def dummy_signal_map(n: int):
    """name -> wire id (or (start, len) for arrays)."""
    return {
        "something": 1,
        "plaintext": (2, n),
        "challenge": 2 + n,
    }


def compile_dummy(n: int = 100, prime: int = None) -> R1csFile:
    prime = prime or fi.BN254_R
    n_wires = n + 3
    one = 1
    # circom's === emits A*B = C with the linear parts arranged so that
    # linear constraints have empty B:  (lhs - rhs) * 0 ... circom canonical
    # form is A*B - C = 0; a linear equality x === y becomes
    # A = {x: 1, y: -1}, B = {}, C = {}.
    m1 = prime - 1
    # circom normal form: A*B - C = 0; linear equalities carry the linear
    # part in C (A = B = empty), quadratic ones use A*B.
    c1 = ({}, {}, {2: one, 1: m1})  # plaintext[0] - something = 0
    # challenge === something^2:  (-s)*(s) - (-challenge) = 0
    c2 = ({1: m1}, {1: one}, {2 + n: m1})
    constraints = [c1, c2]
    return R1csFile(
        prime=prime,
        n_wires=n_wires,
        n_pub_out=0,
        n_pub_in=0,
        n_prv_in=n + 2,
        n_labels=n_wires,
        constraints=constraints,
        wire2label=list(range(n_wires)),
    )


def dummy_witness(n: int, prime: int, something: int, plaintext, challenge: int):
    """Full wire assignment [1, something, plaintext..., challenge]."""
    pt = list(plaintext) + [0] * (n - len(plaintext))
    return (
        [1, something % prime]
        + [x % prime for x in pt]
        + [challenge % prime]
    )
