from .circuit import Assignment, CircuitMeta, ColumnRef, Expr
from .mock import MockProver, VerifyFailure
from .poseidon_pow5 import PoseidonPow5Host, pow5_constants
from .elgamal_circuit import ElGamalCircuit, ElGamalPallas
from .ipa import IPA, IpaProof
