"""Base class for instruction chips: the receive side of the CPU dispatch.

Every opcode-class chip (AddSub, Bitwise, Branch, MemoryInstructions, ...)
shares the same front matter: one row per event, opcode selector flags,
the 22-field Instruction message received against its own columns, and
control-flag constants per opcode (which the CPU is thereby forced to set
correctly — see machine/cpu.py).
"""

from __future__ import annotations

import numpy as np

from ..utils.pool import zeros_mt

from ..executor.opcodes import Opcode
from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .cpu import IMMUTABLE_A, NON_SEQUENTIAL, PA_IS_PREV_A, WRITES_HI
from .gadgets import ByteSink, ColView, Schema
from .lookups import instr_msg
from .words import split_u32

COMMON = [
    "shard", "clk", "pc", "next_pc", "next_next_pc",
    "a_lo", "a_hi", "b_lo", "b_hi", "c_lo", "c_hi",
    "pa_lo", "pa_hi", "hiw_lo", "hiw_hi", "hp_lo", "hp_hi", "is_real",
]


class InstrAir(BaseAir):
    """Subclasses set OPCODES + EXTRA_COLS and implement eval_op / fill_op."""

    OPCODES: list[Opcode] = []
    EXTRA_COLS: list[str] = []
    IS_HALT = 0  # overridden only by the syscall chip

    def __init__(self):
        self.sel_names = [f"is_{op.name.lower()}" for op in self.OPCODES]
        self.schema = Schema(COMMON + self.sel_names + self.EXTRA_COLS + self._access_names())
        self.main_width = self.schema.width

    def _access_names(self) -> list[str]:
        return []

    # ------------------------------------------------------------------ AIR

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        sels = [col(n) for n in self.sel_names]
        is_real = col("is_real")
        b.assert_bool(is_real)
        total = sels[0]
        for s_ in sels[1:]:
            total = total + s_
        b.assert_eq(total, is_real)
        for s_ in sels:
            b.assert_bool(s_)

        def flag(table) -> object:
            e = 0
            for op, s_ in zip(self.OPCODES, sels):
                if op in table:
                    e = e + s_
            return e

        opcode = 0
        for op, s_ in zip(self.OPCODES, sels):
            opcode = opcode + s_ * int(op)

        is_halt, is_seq = self.control_flags(col, is_real, flag)
        msg = instr_msg(
            opcode,
            col("shard"), col("clk"), col("pc"), col("next_pc"), col("next_next_pc"),
            col.word("a"), col.word("b"), col.word("c"), col.word("pa"), col.word("hiw"),
            col.word("hp"),
            self.num_extra_expr(col),
            flag(WRITES_HI), flag(PA_IS_PREV_A), is_halt, is_seq, flag(IMMUTABLE_A),
        )
        b.receive(LookupKind.Instruction, msg, is_real)

        self.eval_op(b, col, sels)

    def num_extra_expr(self, col):
        return 0

    def control_flags(self, col, is_real, flag):
        """(is_halt, is_sequential) exprs; overridden by the syscall chip."""
        return 0, is_real - flag(NON_SEQUENTIAL)

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        raise NotImplementedError

    # ------------------------------------------------------------ trace gen

    def nested_of(self, record) -> list:
        """Nested helper-ALU events this chip also receives (default none)."""
        return []

    def events_of(self, record) -> list:
        """Event objects in row order: cpu events matching OPCODES + nested."""
        from ..executor.columnar import indices_of

        idx = indices_of(record, self.OPCODES)
        cpu = record.cpu_events
        return [cpu[i] for i in idx] + self.nested_of(record)

    def included(self, record) -> bool:
        """Event-driven shard membership (reference MachineAir::included):
        an instruction chip with no events receives no lookup messages, so
        excluding it keeps the shard's lookup multiset balanced while
        dropping its commit/opening/transcript cost."""
        from ..executor.columnar import indices_of

        return len(indices_of(record, self.OPCODES)) > 0 or bool(self.nested_of(record))

    def generate_trace(self, record, output):
        from ..executor.columnar import cpu_struct, indices_of

        idx = indices_of(record, self.OPCODES)
        nested = self.nested_of(record)
        k, n = len(idx), len(idx) + len(nested)
        s = self.schema
        t = zeros_mt((n, s.width), dtype=np.uint32, order="F")
        if n == 0:
            return t
        sink = ByteSink(record)

        cs = cpu_struct(record)[idx]
        t[:k, s.idx("shard")] = record.shard
        t[:k, s.idx("clk")] = cs["clk"]
        t[:k, s.idx("pc")] = cs["pc"]
        t[:k, s.idx("next_pc")] = cs["next_pc"]
        t[:k, s.idx("next_next_pc")] = cs["nnpc"]
        opv = np.empty(n, dtype=np.uint32)
        opv[:k] = cs["opcode"]
        vals = {}
        for key in ("a", "b", "c", "pa", "hiw", "hp"):
            col = np.empty(n, dtype=np.uint32)
            col[:k] = cs[key]
            vals[key] = col
        for i, e in enumerate(nested):
            row = k + i
            vals["a"][row] = e.a
            vals["b"][row] = e.b
            vals["c"][row] = e.c
            vals["pa"][row] = e.pa
            vals["hiw"][row] = e.hiw
            vals["hp"][row] = e.hp
            opv[row] = int(e.opcode)
        for key, v in vals.items():
            t[:, s.idx(f"{key}_lo")] = v & 0xFFFF
            t[:, s.idx(f"{key}_hi")] = v >> 16
        t[:, s.idx("is_real")] = 1
        for op in self.OPCODES:
            t[:, s.idx(f"is_{op.name.lower()}")] = opv == int(op)
        ops = _OpcodeSeq(opv)
        if self.fill_cols(t, cs, len(nested), opv, sink):
            return t
        events = _LazyEvents(record, idx, nested)
        if self.fill_vec(t, events, ops, sink):
            return t
        for i in range(n):
            self.fill_op(t, i, events[i], ops[i], sink)
        return t

    def fill_cols(self, t, cs, n_nested, opv, sink) -> bool:
        """Column-driven vectorized fill over the sliced cpu struct (cs covers
        rows [0, len(t) - n_nested)); return True if done."""
        return False

    def fill_vec(self, t, events, ops, sink) -> bool:
        """Subclasses may implement a vectorized fill; return True if done."""
        return False

    def fill_op(self, t, i, event, op, sink: ByteSink):
        raise NotImplementedError


class _OpcodeSeq:
    """Opcode view over a uint32 array: indexing/iteration yields Opcode
    enums (what fill_op expects); ``.array`` is the raw vector for
    vectorized fills."""

    __slots__ = ("array",)

    def __init__(self, arr):
        self.array = arr

    def __len__(self):
        return len(self.array)

    def __getitem__(self, i):
        return Opcode(int(self.array[i]))

    def __iter__(self):
        return (Opcode(int(v)) for v in self.array)


class _LazyEvents:
    """Row-ordered event objects, materialized only if a fill touches them
    (the vectorized fills work from the already-filled trace columns)."""

    __slots__ = ("_record", "_idx", "_nested", "_cpu")

    def __init__(self, record, idx, nested):
        self._record = record
        self._idx = idx
        self._nested = nested
        self._cpu = None

    def __len__(self):
        return len(self._idx) + len(self._nested)

    def __getitem__(self, i):
        k = len(self._idx)
        if i < k:
            return self._record.cpu_events[self._idx[i]]
        return self._nested[i - k]

    def __iter__(self):
        cpu = self._record.cpu_events
        for i in self._idx:
            yield cpu[i]
        yield from self._nested


from dataclasses import dataclass


@dataclass(frozen=True, slots=True)
class NestedAluEvent:
    """Helper-ALU request emitted by another chip (zero control fields)."""

    opcode: Opcode
    a: int
    b: int
    c: int
    pa: int = 0
    hiw: int = 0
    hp: int = 0
