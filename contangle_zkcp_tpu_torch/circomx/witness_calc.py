"""Circom 2.x witness calculator over the embedded wasm interpreter.

Port of `contangle_zkcp_tpu/circomx/witness_calc.py`.

Drives the standard witness-generator ABI that `circom --wasm` modules
export (the same protocol snarkjs' witness_calculator.js and the wasmer
runtime inside the reference's patched ark-circom speak —
nulltea/contangle-zkcp:circuits-ark/src/circom_wrapper.rs:153-225 runs zkPhoto's
generator this way):

  exports: getFieldNumLen32, getRawPrime, readSharedRWMemory,
           writeSharedRWMemory, init(sanity), setInputSignal(hMSB,hLSB,pos),
           getWitnessSize, getWitness(i)
  imports (module "runtime"): exceptionHandler, printErrorMessage,
           writeBufferMessage, showSharedRWMemory

Signal names address the input map through the 64-bit FNV-1a hash of the
name, split into two i32 halves — exactly the keying circom bakes into the
generated module.
"""

from __future__ import annotations

from ..utils.errors import ProofError
from .wasm import Instance, WasmTrap, parse_module

_ERROR_CODES = {
    1: "signal not found",
    2: "too many input signals set",
    3: "signal already set",
    4: "assert failed",
    5: "not enough input signals set",
    6: "input signal array access out of bounds",
}


def fnv1a_64(name: str) -> int:
    h = 0xCBF29CE484222325
    for b in name.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class WitnessCalculator:
    def __init__(self, wasm_bytes: bytes, sanity_check: bool = False):
        self._err: list[int] = []
        runtime = {
            "exceptionHandler": self._exception,
            "printErrorMessage": lambda *a: 0,
            "writeBufferMessage": lambda *a: 0,
            "showSharedRWMemory": lambda *a: 0,
            # circom <2.0.7 modules import a few more log hooks
            "error": self._legacy_error,
            "log": lambda *a: 0,
            "logSetSignal": lambda *a: 0,
            "logGetSignal": lambda *a: 0,
            "logFinishComponent": lambda *a: 0,
            "logStartComponent": lambda *a: 0,
        }
        self.inst = Instance(parse_module(wasm_bytes), {"runtime": runtime})
        self.n32 = self.inst.invoke("getFieldNumLen32")
        self.inst.invoke("getRawPrime")
        self.prime = self._read_shared()
        self.sanity_check = sanity_check

    def _exception(self, code: int) -> int:
        self._err.append(code)
        raise WasmTrap(
            f"circom runtime error {code}: "
            f"{_ERROR_CODES.get(code, 'unknown')}"
        )

    def _legacy_error(self, *a) -> int:
        raise WasmTrap(f"circom runtime error {a}")

    def _read_shared(self) -> int:
        v = 0
        for i in range(self.n32):
            v |= (self.inst.invoke("readSharedRWMemory", i) & 0xFFFFFFFF) << (
                32 * i
            )
        return v

    def _write_shared(self, v: int) -> None:
        for i in range(self.n32):
            self.inst.invoke(
                "writeSharedRWMemory", i, (v >> (32 * i)) & 0xFFFFFFFF
            )

    def calculate_witness(self, inputs: dict) -> list[int]:
        """inputs: {signal_name: int | list[int] (row-major flattened)}.
        Returns the full witness vector in r1cs wire order (w[0] = 1)."""
        self.inst.invoke("init", 1 if self.sanity_check else 0)
        for name, values in inputs.items():
            if isinstance(values, int):
                values = [values]
            h = fnv1a_64(name)
            h_msb, h_lsb = (h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF
            declared = None
            if "getInputSignalSize" in self.inst.m.exports:
                declared = self.inst.invoke(
                    "getInputSignalSize", h_msb, h_lsb
                )
            if declared is not None and declared != len(values):
                raise ProofError(
                    f"signal {name}: expected {declared} values, "
                    f"got {len(values)}"
                )
            for pos, v in enumerate(values):
                self._write_shared(v % self.prime)
                try:
                    self.inst.invoke("setInputSignal", h_msb, h_lsb, pos)
                except WasmTrap as e:
                    raise ProofError(f"signal {name}[{pos}]: {e}") from e
        # consistent error surface: size/getWitness traps (e.g. circom
        # error 5 "not enough input signals set" when a caller omits an
        # input) surface as ProofError, mirroring the setInputSignal path
        try:
            size = self.inst.invoke("getWitnessSize")
            out = []
            for i in range(size):
                self.inst.invoke("getWitness", i)
                out.append(self._read_shared())
        except WasmTrap as e:
            raise ProofError(f"witness extraction: {e}") from e
        return out
