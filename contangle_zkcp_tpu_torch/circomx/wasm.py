"""Minimal WebAssembly (MVP) interpreter for circom witness generators.

Port of `contangle_zkcp_tpu/circomx/wasm.py`, pure Python as there (no
torch): the witness generator runs on the host.

The reference runs compiled circom circuits through their `.wasm` witness
calculator via the wasmer runtime inside its patched ark-circom fork
(nulltea/contangle-zkcp:circuits-ark/src/circom_wrapper.rs:153-225
exercises the zkPhoto circuit this way; the fork itself is a path
dependency outside that repository).  The project depends on no wasm
runtime, so we interpret the module directly: circom-emitted witness
generators use only the integer subset of the WebAssembly MVP — i32/i64
arithmetic, linear memory, structured control flow, direct/indirect
calls — which a few hundred lines of Python cover exactly.

Scope: full MVP integer semantics (two's-complement wraparound, trapping
division, little-endian loads/stores with static offsets, `br_table`,
`call_indirect` with type checking, mutable globals, `memory.grow`) plus
the sign-extension operators (`i32.extend8_s` family) circom 2.1 emits.
Floating point is parsed but traps on execution — circom witness code
never executes it.

This is an interpreter for *trusted local artifacts* (the prover's own
compiled circuit), not an isolation boundary for adversarial modules.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


class WasmTrap(RuntimeError):
    pass


MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def _s32(v: int) -> int:
    v &= MASK32
    return v - 0x100000000 if v >= 0x80000000 else v


def _s64(v: int) -> int:
    v &= MASK64
    return v - 0x10000000000000000 if v >= 0x8000000000000000 else v


# ------------------------------------------------------------------ decode
class _Reader:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes, i: int = 0):
        self.b = b
        self.i = i

    def u8(self) -> int:
        v = self.b[self.i]
        self.i += 1
        return v

    def bytes(self, n: int) -> bytes:
        v = self.b[self.i : self.i + n]
        self.i += n
        return v

    def uleb(self) -> int:
        r = s = 0
        while True:
            byte = self.u8()
            r |= (byte & 0x7F) << s
            if not byte & 0x80:
                return r
            s += 7

    def sleb(self) -> int:
        r = s = 0
        while True:
            byte = self.u8()
            r |= (byte & 0x7F) << s
            s += 7
            if not byte & 0x80:
                if byte & 0x40:
                    r -= 1 << s
                return r

    def name(self) -> str:
        return self.bytes(self.uleb()).decode("utf-8")

    def eof(self) -> bool:
        return self.i >= len(self.b)


@dataclass
class FuncType:
    params: tuple
    results: tuple


@dataclass
class Function:
    type_idx: int
    locals: list = field(default_factory=list)  # valtype codes, params first
    code: list = field(default_factory=list)  # pre-decoded ops


@dataclass
class Module:
    types: list = field(default_factory=list)
    imports: list = field(default_factory=list)  # (mod, name, kind, desc)
    funcs: list = field(default_factory=list)  # Function (locally defined)
    func_types: list = field(default_factory=list)  # type idx per func index
    n_imported_funcs: int = 0
    table: list = field(default_factory=list)
    mem_limits: tuple = (0, None)
    globals: list = field(default_factory=list)  # (valtype, mutable, init)
    n_imported_globals: int = 0
    exports: dict = field(default_factory=dict)  # name -> (kind, idx)
    data: list = field(default_factory=list)  # (offset_expr, bytes)
    elems: list = field(default_factory=list)  # (offset_expr, [func idx])
    start: int | None = None


# op tuple layout: (opcode:int, imm) — imm meaning depends on opcode.
# Structured-control opcodes carry resolved jump targets filled in by
# `_resolve_branches`.
OP_BLOCK, OP_LOOP, OP_IF, OP_ELSE, OP_END = 0x02, 0x03, 0x04, 0x05, 0x0B

_MEM_OPS = set(range(0x28, 0x3F))
_CONST_F = {0x43: 4, 0x44: 8}


def _decode_body(r: _Reader) -> list:
    """Decode an expression into a flat op list (terminated by END)."""
    ops = []
    depth = 0
    while True:
        op = r.u8()
        if op in (OP_BLOCK, OP_LOOP, OP_IF):
            bt = r.sleb()  # blocktype: -64 empty, negative valtype, else typeidx
            ops.append([op, bt, -1, -1])  # [-, blocktype, target, else_target]
            depth += 1
        elif op == OP_ELSE:
            ops.append([op, -1])
        elif op == OP_END:
            ops.append([op])
            if depth == 0:
                return ops
            depth -= 1
        elif op in (0x0C, 0x0D):  # br, br_if
            ops.append([op, r.uleb()])
        elif op == 0x0E:  # br_table
            n = r.uleb()
            tbl = [r.uleb() for _ in range(n)]
            tbl.append(r.uleb())
            ops.append([op, tbl])
        elif op in (0x0F, 0x00, 0x01, 0x1A, 0x1B):  # return/unreachable/nop/drop/select
            ops.append([op])
        elif op == 0x10:  # call
            ops.append([op, r.uleb()])
        elif op == 0x11:  # call_indirect
            ti = r.uleb()
            r.uleb()  # table index (0 in MVP)
            ops.append([op, ti])
        elif 0x20 <= op <= 0x24:  # local/global get/set/tee
            ops.append([op, r.uleb()])
        elif op in _MEM_OPS:
            r.uleb()  # alignment hint (ignored)
            ops.append([op, r.uleb()])  # static offset
        elif op in (0x3F, 0x40):  # memory.size/grow
            r.u8()
            ops.append([op])
        elif op == 0x41:
            ops.append([op, r.sleb() & MASK32])
        elif op == 0x42:
            ops.append([op, r.sleb() & MASK64])
        elif op in _CONST_F:
            r.bytes(_CONST_F[op])
            ops.append([0x00])  # executing a float const traps
        elif op == 0xFC:  # saturating truncation / bulk memory prefix
            sub = r.uleb()
            if sub in (10, 11):  # memory.copy / memory.fill
                if sub == 10:
                    r.u8()
                    r.u8()
                else:
                    r.u8()
                ops.append([0xFC, sub])
            else:
                ops.append([0x00])
        else:
            ops.append([op])  # plain stack op (arith/compare/convert)
    raise AssertionError


def _resolve_branches(ops: list) -> None:
    """Fill jump targets: block/if -> matching END, loop -> itself."""
    stack = []
    for pc, ins in enumerate(ops):
        op = ins[0]
        if op in (OP_BLOCK, OP_LOOP, OP_IF):
            stack.append(pc)
        elif op == OP_ELSE:
            ops[stack[-1]][3] = pc  # if's else target
            ins[1] = stack[-1]  # remember opener to find END later
        elif op == OP_END and stack:
            opener = stack.pop()
            ops[opener][2] = pc
            if ops[opener][0] == OP_IF and ops[opener][3] == -1:
                ops[opener][3] = pc  # if without else: false -> END


def parse_module(data: bytes) -> Module:
    if data[:4] != b"\x00asm" or data[4:8] != b"\x01\x00\x00\x00":
        raise WasmTrap("not a wasm v1 module")
    r = _Reader(data, 8)
    m = Module()
    code_bodies: list[bytes] = []
    while not r.eof():
        sec = r.u8()
        size = r.uleb()
        body = _Reader(r.bytes(size))
        if sec == 1:  # types
            for _ in range(body.uleb()):
                assert body.u8() == 0x60
                params = tuple(body.u8() for _ in range(body.uleb()))
                results = tuple(body.u8() for _ in range(body.uleb()))
                m.types.append(FuncType(params, results))
        elif sec == 2:  # imports
            for _ in range(body.uleb()):
                mod, nm, kind = body.name(), body.name(), body.u8()
                if kind == 0:
                    ti = body.uleb()
                    m.imports.append((mod, nm, "func", ti))
                    m.func_types.append(ti)
                    m.n_imported_funcs += 1
                elif kind == 2:  # memory import
                    fl = body.u8()
                    mn = body.uleb()
                    mx = body.uleb() if fl & 1 else None
                    m.imports.append((mod, nm, "memory", (mn, mx)))
                    m.mem_limits = (mn, mx)
                elif kind == 1:  # table import
                    body.u8()
                    fl = body.u8()
                    body.uleb()
                    if fl & 1:
                        body.uleb()
                    m.imports.append((mod, nm, "table", None))
                elif kind == 3:  # global import
                    vt, mut = body.u8(), body.u8()
                    m.imports.append((mod, nm, "global", (vt, mut)))
                    m.n_imported_globals += 1
        elif sec == 3:  # function decls
            for _ in range(body.uleb()):
                m.func_types.append(body.uleb())
        elif sec == 4:  # table
            for _ in range(body.uleb()):
                body.u8()  # elemtype
                fl = body.u8()
                mn = body.uleb()
                if fl & 1:
                    body.uleb()
                m.table = [None] * mn
        elif sec == 5:  # memory
            for _ in range(body.uleb()):
                fl = body.u8()
                mn = body.uleb()
                mx = body.uleb() if fl & 1 else None
                m.mem_limits = (mn, mx)
        elif sec == 6:  # globals
            for _ in range(body.uleb()):
                vt, mut = body.u8(), body.u8()
                init = _decode_body(body)
                m.globals.append((vt, mut, init))
        elif sec == 7:  # exports
            for _ in range(body.uleb()):
                nm, kind, idx = body.name(), body.u8(), body.uleb()
                m.exports[nm] = (kind, idx)
        elif sec == 8:  # start
            m.start = body.uleb()
        elif sec == 9:  # elements
            for _ in range(body.uleb()):
                body.uleb()  # table idx / flags (0 in MVP)
                off = _decode_body(body)
                idxs = [body.uleb() for _ in range(body.uleb())]
                m.elems.append((off, idxs))
        elif sec == 10:  # code
            for _ in range(body.uleb()):
                code_bodies.append(body.bytes(body.uleb()))
        elif sec == 11:  # data
            for _ in range(body.uleb()):
                body.uleb()
                off = _decode_body(body)
                m.data.append((off, body.bytes(body.uleb())))
        # sections 0 (custom) and others: skipped
    for i, cb in enumerate(code_bodies):
        br = _Reader(cb)
        locs = []
        for _ in range(br.uleb()):
            n = br.uleb()
            vt = br.u8()
            locs.extend([vt] * n)
        ops = _decode_body(br)
        _resolve_branches(ops)
        m.funcs.append(
            Function(m.func_types[m.n_imported_funcs + i], locs, ops)
        )
    return m


# --------------------------------------------------------------- execute
PAGE = 65536


class Instance:
    """An instantiated module: memory, globals, table, callable exports.

    imports: {module_name: {field_name: python callable}} for function
    imports (the circom `runtime` host functions).
    """

    def __init__(self, module: Module, imports: dict | None = None):
        self.m = module
        self.mem = bytearray(module.mem_limits[0] * PAGE)
        self.mem_max = module.mem_limits[1]
        self.host_funcs: list = []
        imports = imports or {}
        for mod, nm, kind, _desc in module.imports:
            if kind == "func":
                try:
                    self.host_funcs.append(imports[mod][nm])
                except KeyError:
                    raise WasmTrap(f"missing import {mod}.{nm}") from None
            elif kind in ("memory", "table", "global"):
                raise WasmTrap(f"unsupported non-func import {mod}.{nm}")
        self.globals = [self._eval_const(g[2]) for g in module.globals]
        self.table = list(module.table)
        for off_expr, idxs in module.elems:
            base = self._eval_const(off_expr)
            need = base + len(idxs)
            if need > len(self.table):
                self.table.extend([None] * (need - len(self.table)))
            self.table[base : base + len(idxs)] = idxs
        for off_expr, blob in module.data:
            base = self._eval_const(off_expr)
            self.mem[base : base + len(blob)] = blob
        if module.start is not None:
            self.call_index(module.start, [])

    def _eval_const(self, ops: list) -> int:
        for ins in ops:
            if ins[0] in (0x41, 0x42):
                return ins[1]
            if ins[0] == 0x23:
                return self.globals[ins[1]]
        raise WasmTrap("unsupported constant expression")

    # -- exports -----------------------------------------------------
    def invoke(self, name: str, *args: int):
        kind, idx = self.m.exports[name]
        if kind != 0:
            raise WasmTrap(f"export {name} is not a function")
        # call/call_indirect recurse through Python frames; production
        # circom modules (deep component chains, e.g. zkPhoto) can blow
        # the default 1000-frame limit — give them headroom and surface
        # exhaustion as a trap instead of a raw RecursionError
        import sys

        if sys.getrecursionlimit() < 100_000:
            sys.setrecursionlimit(100_000)
        try:
            res = self.call_index(idx, list(args))
        except RecursionError as e:
            raise WasmTrap("call stack exhausted") from e
        if not res:
            return None
        return res[0] if len(res) == 1 else tuple(res)

    def memory_read(self, addr: int, n: int) -> bytes:
        return bytes(self.mem[addr : addr + n])

    def memory_write(self, addr: int, blob: bytes) -> None:
        self.mem[addr : addr + len(blob)] = blob

    # -- interpreter core --------------------------------------------
    def call_index(self, fidx: int, args: list):
        m = self.m
        if fidx < m.n_imported_funcs:
            out = self.host_funcs[fidx](*args)
            ft = m.types[m.func_types[fidx]]
            if not ft.results:
                return []
            return [int(out) & (MASK32 if ft.results[0] == 0x7F else MASK64)]
        fn = m.funcs[fidx - m.n_imported_funcs]
        ft = m.types[fn.type_idx]
        locals_ = args + [0] * len(fn.locals)
        return self._exec(fn.code, locals_, len(ft.results))

    def _exec(self, ops: list, locals_: list, n_results: int):
        stack: list = []
        # label: (is_loop, branch_target_pc, arity, stack_height, end_pc)
        labels: list = []
        mem = self.mem
        glb = self.globals
        pc = 0
        n_ops = len(ops)
        while pc < n_ops:
            ins = ops[pc]
            op = ins[0]
            if op == 0x41 or op == 0x42:  # i32/i64.const
                stack.append(ins[1])
            elif op == 0x20:  # local.get
                stack.append(locals_[ins[1]])
            elif op == 0x21:  # local.set
                locals_[ins[1]] = stack.pop()
            elif op == 0x22:  # local.tee
                locals_[ins[1]] = stack[-1]
            elif op == OP_END:
                if labels and labels[-1][4] == pc:
                    labels.pop()
            elif op == OP_BLOCK or op == OP_IF:
                arity = 0 if ins[1] == -64 else 1
                if op == OP_IF:
                    cond = stack.pop()
                    if not cond:
                        # jump to else-branch (or END)
                        tgt = ins[3]
                        if tgt == ins[2]:  # no else: skip whole if
                            pc = ins[2] + 1
                            continue
                        labels.append(
                            (False, ins[2], arity, len(stack), ins[2])
                        )
                        pc = tgt + 1
                        continue
                labels.append((False, ins[2], arity, len(stack), ins[2]))
            elif op == OP_LOOP:
                labels.append((True, pc, 0, len(stack), ins[2]))
            elif op == OP_ELSE:
                # fell through the then-branch: jump to the END, which
                # pops this if's label
                pc = ops[ins[1]][2]
                continue
            elif op == 0x0C or op == 0x0D or op == 0x0E:  # br / br_if / br_table
                if op == 0x0D:
                    if not stack.pop():
                        pc += 1
                        continue
                    depth = ins[1]
                elif op == 0x0E:
                    sel = _s32(stack.pop())
                    tbl = ins[1]
                    depth = tbl[sel] if 0 <= sel < len(tbl) - 1 else tbl[-1]
                else:
                    depth = ins[1]
                if depth == len(labels):
                    # branch to the implicit function-body label: acts
                    # as a return (valid MVP wasm; real circom-emitted
                    # modules contain function-level branches)
                    return (
                        stack[len(stack) - n_results :] if n_results else []
                    )
                is_loop, tgt, arity, height, _end = labels[
                    len(labels) - 1 - depth
                ]
                keep = stack[len(stack) - arity :] if arity else []
                del stack[height:]
                stack.extend(keep)
                del labels[len(labels) - depth :]
                if is_loop:
                    pc = tgt + 1  # loop label stays; jump after LOOP op
                else:
                    labels.pop()
                    pc = tgt + 1  # past END
                continue
            elif op == 0x0F:  # return
                return stack[len(stack) - n_results :] if n_results else []
            elif op == 0x10:  # call
                fidx = ins[1]
                ft = self.m.types[self.m.func_types[fidx]]
                np_ = len(ft.params)
                args = stack[len(stack) - np_ :] if np_ else []
                del stack[len(stack) - np_ :]
                stack.extend(self.call_index(fidx, args))
            elif op == 0x11:  # call_indirect
                ti = stack.pop()
                if ti >= len(self.table) or self.table[ti] is None:
                    raise WasmTrap("call_indirect: bad table entry")
                fidx = self.table[ti]
                if (
                    self.m.types[self.m.func_types[fidx]]
                    != self.m.types[ins[1]]
                ):
                    raise WasmTrap("call_indirect: type mismatch")
                ft = self.m.types[ins[1]]
                np_ = len(ft.params)
                args = stack[len(stack) - np_ :] if np_ else []
                del stack[len(stack) - np_ :]
                stack.extend(self.call_index(fidx, args))
            elif op == 0x1A:  # drop
                stack.pop()
            elif op == 0x1B:  # select
                c = stack.pop()
                b = stack.pop()
                a = stack.pop()
                stack.append(a if c else b)
            elif op == 0x23:  # global.get
                stack.append(glb[ins[1]])
            elif op == 0x24:  # global.set
                glb[ins[1]] = stack.pop()
            elif 0x28 <= op <= 0x35:  # loads
                addr = (stack.pop() & MASK32) + ins[1]
                stack.append(_load(mem, op, addr))
            elif 0x36 <= op <= 0x3E:  # stores
                val = stack.pop()
                addr = (stack.pop() & MASK32) + ins[1]
                _store(mem, op, addr, val)
            elif op == 0x3F:  # memory.size
                stack.append(len(mem) // PAGE)
            elif op == 0x40:  # memory.grow
                delta = stack.pop()
                old = len(mem) // PAGE
                if self.mem_max is not None and old + delta > self.mem_max:
                    stack.append(MASK32)  # -1
                else:
                    mem.extend(b"\x00" * (delta * PAGE))
                    stack.append(old)
            elif op == 0xFC:  # memory.copy / memory.fill
                if ins[1] == 10:
                    n = stack.pop() & MASK32
                    src = stack.pop() & MASK32
                    dst = stack.pop() & MASK32
                    mem[dst : dst + n] = mem[src : src + n]
                else:
                    n = stack.pop() & MASK32
                    v = stack.pop() & 0xFF
                    dst = stack.pop() & MASK32
                    mem[dst : dst + n] = bytes([v]) * n
            elif op == 0x00:  # unreachable
                raise WasmTrap("unreachable")
            elif op == 0x01:  # nop
                pass
            else:
                _numeric(op, stack)
            pc += 1
        return stack[len(stack) - n_results :] if n_results else []


_LOAD_WIDTH = {
    0x28: 4, 0x29: 8, 0x2C: 1, 0x2D: 1, 0x2E: 2, 0x2F: 2,
    0x30: 1, 0x31: 1, 0x32: 2, 0x33: 2, 0x34: 4, 0x35: 4,
}
_STORE_WIDTH = {0x36: 4, 0x37: 8, 0x3A: 1, 0x3B: 2, 0x3C: 1, 0x3D: 2, 0x3E: 4}


def _load(mem: bytearray, op: int, a: int) -> int:
    # spec-compliant trap: Python short slices would otherwise return a
    # truncated value for multi-byte loads near the end of memory
    w = _LOAD_WIDTH.get(op)
    if w is not None and a + w > len(mem):
        raise WasmTrap("out-of-bounds load")
    try:
        if op == 0x28:
            return int.from_bytes(mem[a : a + 4], "little")
        if op == 0x29:
            return int.from_bytes(mem[a : a + 8], "little")
        if op in (0x2A, 0x2B):
            raise WasmTrap("float load")
        if op == 0x2C:
            v = mem[a]
            return (v - 0x100 if v >= 0x80 else v) & MASK32
        if op == 0x2D:
            return mem[a]
        if op == 0x2E:
            v = int.from_bytes(mem[a : a + 2], "little")
            return (v - 0x10000 if v >= 0x8000 else v) & MASK32
        if op == 0x2F:
            return int.from_bytes(mem[a : a + 2], "little")
        if op == 0x30:
            v = mem[a]
            return (v - 0x100 if v >= 0x80 else v) & MASK64
        if op == 0x31:
            return mem[a]
        if op == 0x32:
            v = int.from_bytes(mem[a : a + 2], "little")
            return (v - 0x10000 if v >= 0x8000 else v) & MASK64
        if op == 0x33:
            return int.from_bytes(mem[a : a + 2], "little")
        if op == 0x34:
            v = int.from_bytes(mem[a : a + 4], "little")
            return (v - 0x100000000 if v >= 0x80000000 else v) & MASK64
        if op == 0x35:
            return int.from_bytes(mem[a : a + 4], "little")
    except IndexError:
        raise WasmTrap("out-of-bounds load") from None
    raise WasmTrap(f"bad load opcode {op:#x}")


def _store(mem: bytearray, op: int, a: int, v: int) -> None:
    # spec-compliant trap: slice assignment past len(mem) would silently
    # extend the bytearray at the wrong position instead of trapping
    w = _STORE_WIDTH.get(op)
    if w is not None and a + w > len(mem):
        raise WasmTrap("out-of-bounds store")
    if op == 0x36:
        mem[a : a + 4] = (v & MASK32).to_bytes(4, "little")
    elif op == 0x37:
        mem[a : a + 8] = (v & MASK64).to_bytes(8, "little")
    elif op in (0x38, 0x39):
        raise WasmTrap("float store")
    elif op == 0x3A:
        mem[a] = v & 0xFF
    elif op == 0x3B:
        mem[a : a + 2] = (v & 0xFFFF).to_bytes(2, "little")
    elif op == 0x3C:
        mem[a] = v & 0xFF
    elif op == 0x3D:
        mem[a : a + 2] = (v & 0xFFFF).to_bytes(2, "little")
    elif op == 0x3E:
        mem[a : a + 4] = (v & MASK32).to_bytes(4, "little")
    else:
        raise WasmTrap(f"bad store opcode {op:#x}")


def _clz(v: int, bits: int) -> int:
    return bits - v.bit_length() if v else bits


def _ctz(v: int, bits: int) -> int:
    return (v & -v).bit_length() - 1 if v else bits


def _div_s(a: int, b: int, mask: int) -> int:
    if b == 0:
        raise WasmTrap("integer divide by zero")
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    if q == (mask >> 1) + 1:
        raise WasmTrap("integer overflow")
    return q & mask


def _rem_s(a: int, b: int, mask: int) -> int:
    if b == 0:
        raise WasmTrap("integer divide by zero")
    r = abs(a) % abs(b)
    return (-r if a < 0 else r) & mask


def _numeric(op: int, stack: list) -> None:
    """i32/i64 compare, arithmetic and conversion ops."""
    # i32 compares
    if op == 0x45:
        stack[-1] = 1 if (stack[-1] & MASK32) == 0 else 0
        return
    if 0x46 <= op <= 0x4F:
        b = stack.pop()
        a = stack[-1]
        au, bu = a & MASK32, b & MASK32
        as_, bs = _s32(a), _s32(b)
        stack[-1] = 1 if (
            (op == 0x46 and au == bu)
            or (op == 0x47 and au != bu)
            or (op == 0x48 and as_ < bs)
            or (op == 0x49 and au < bu)
            or (op == 0x4A and as_ > bs)
            or (op == 0x4B and au > bu)
            or (op == 0x4C and as_ <= bs)
            or (op == 0x4D and au <= bu)
            or (op == 0x4E and as_ >= bs)
            or (op == 0x4F and au >= bu)
        ) else 0
        return
    if op == 0x50:
        stack[-1] = 1 if (stack[-1] & MASK64) == 0 else 0
        return
    if 0x51 <= op <= 0x5A:
        b = stack.pop()
        a = stack[-1]
        au, bu = a & MASK64, b & MASK64
        as_, bs = _s64(a), _s64(b)
        stack[-1] = 1 if (
            (op == 0x51 and au == bu)
            or (op == 0x52 and au != bu)
            or (op == 0x53 and as_ < bs)
            or (op == 0x54 and au < bu)
            or (op == 0x55 and as_ > bs)
            or (op == 0x56 and au > bu)
            or (op == 0x57 and as_ <= bs)
            or (op == 0x58 and au <= bu)
            or (op == 0x59 and as_ >= bs)
            or (op == 0x5A and au >= bu)
        ) else 0
        return
    # i32 unary
    if op in (0x67, 0x68, 0x69):
        v = stack[-1] & MASK32
        stack[-1] = (
            _clz(v, 32) if op == 0x67 else _ctz(v, 32) if op == 0x68 else bin(v).count("1")
        )
        return
    # i32 binary
    if 0x6A <= op <= 0x78:
        b = stack.pop()
        a = stack[-1]
        au, bu = a & MASK32, b & MASK32
        if op == 0x6A:
            r = au + bu
        elif op == 0x6B:
            r = au - bu
        elif op == 0x6C:
            r = au * bu
        elif op == 0x6D:
            r = _div_s(_s32(a), _s32(b), MASK32)
        elif op == 0x6E:
            if bu == 0:
                raise WasmTrap("integer divide by zero")
            r = au // bu
        elif op == 0x6F:
            r = _rem_s(_s32(a), _s32(b), MASK32)
        elif op == 0x70:
            if bu == 0:
                raise WasmTrap("integer divide by zero")
            r = au % bu
        elif op == 0x71:
            r = au & bu
        elif op == 0x72:
            r = au | bu
        elif op == 0x73:
            r = au ^ bu
        elif op == 0x74:
            r = au << (bu & 31)
        elif op == 0x75:
            r = _s32(a) >> (bu & 31)
        elif op == 0x76:
            r = au >> (bu & 31)
        elif op == 0x77:
            s = bu & 31
            r = (au << s) | (au >> (32 - s)) if s else au
        else:  # 0x78 rotr
            s = bu & 31
            r = (au >> s) | (au << (32 - s)) if s else au
        stack[-1] = r & MASK32
        return
    # i64 unary
    if op in (0x79, 0x7A, 0x7B):
        v = stack[-1] & MASK64
        stack[-1] = (
            _clz(v, 64) if op == 0x79 else _ctz(v, 64) if op == 0x7A else bin(v).count("1")
        )
        return
    # i64 binary
    if 0x7C <= op <= 0x8A:
        b = stack.pop()
        a = stack[-1]
        au, bu = a & MASK64, b & MASK64
        if op == 0x7C:
            r = au + bu
        elif op == 0x7D:
            r = au - bu
        elif op == 0x7E:
            r = au * bu
        elif op == 0x7F:
            r = _div_s(_s64(a), _s64(b), MASK64)
        elif op == 0x80:
            if bu == 0:
                raise WasmTrap("integer divide by zero")
            r = au // bu
        elif op == 0x81:
            r = _rem_s(_s64(a), _s64(b), MASK64)
        elif op == 0x82:
            if bu == 0:
                raise WasmTrap("integer divide by zero")
            r = au % bu
        elif op == 0x83:
            r = au & bu
        elif op == 0x84:
            r = au | bu
        elif op == 0x85:
            r = au ^ bu
        elif op == 0x86:
            r = au << (bu & 63)
        elif op == 0x87:
            r = _s64(a) >> (bu & 63)
        elif op == 0x88:
            r = au >> (bu & 63)
        elif op == 0x89:
            s = bu & 63
            r = (au << s) | (au >> (64 - s)) if s else au
        else:  # 0x8A rotr
            s = bu & 63
            r = (au >> s) | (au << (64 - s)) if s else au
        stack[-1] = r & MASK64
        return
    # conversions
    if op == 0xA7:  # i32.wrap_i64
        stack[-1] = stack[-1] & MASK32
        return
    if op == 0xAC:  # i64.extend_i32_s
        stack[-1] = _s32(stack[-1]) & MASK64
        return
    if op == 0xAD:  # i64.extend_i32_u
        stack[-1] = stack[-1] & MASK32
        return
    if op == 0xC0:  # i32.extend8_s
        v = stack[-1] & 0xFF
        stack[-1] = ((v - 0x100) if v >= 0x80 else v) & MASK32
        return
    if op == 0xC1:  # i32.extend16_s
        v = stack[-1] & 0xFFFF
        stack[-1] = ((v - 0x10000) if v >= 0x8000 else v) & MASK32
        return
    if op == 0xC2:  # i64.extend8_s
        v = stack[-1] & 0xFF
        stack[-1] = ((v - 0x100) if v >= 0x80 else v) & MASK64
        return
    if op == 0xC3:  # i64.extend16_s
        v = stack[-1] & 0xFFFF
        stack[-1] = ((v - 0x10000) if v >= 0x8000 else v) & MASK64
        return
    if op == 0xC4:  # i64.extend32_s
        v = stack[-1] & MASK32
        stack[-1] = ((v - 0x100000000) if v >= 0x80000000 else v) & MASK64
        return
    raise WasmTrap(f"unimplemented opcode {op:#x}")
