"""Columnar view of a shard's CPU events.

Chip trace generation is numpy-vectorized, but each chip re-extracting the
fields it needs from 100k+ CpuEvent objects costs dozens of Python attribute
passes per shard.  This module builds ONE structured array per record (one
pass over the events) that every chip slices with C-speed fancy indexing —
the analog of the reference's C++ event->row encoders operating on packed
event buffers (core/machine/cpp/extern.cpp).

The native trace-mode executor can fill the same structure directly in C,
making this the hand-off format between the emulator and trace generation.
"""

from __future__ import annotations

import numpy as np

# one row per CPU cycle; all fields u4 (canonical u32 values)
CPU_DTYPE = np.dtype(
    [
        ("clk", "u4"), ("pc", "u4"), ("next_pc", "u4"), ("nnpc", "u4"),
        ("opcode", "u4"), ("op_a", "u4"), ("op_b", "u4"), ("op_c", "u4"),
        ("imm_b", "u4"), ("imm_c", "u4"),
        ("a", "u4"), ("b", "u4"), ("c", "u4"), ("pa", "u4"), ("syscall", "u4"),
        # register-access previous records (position A/B/C/HI)
        ("a_ps", "u4"), ("a_pt", "u4"), ("a_pv", "u4"),
        ("b_ps", "u4"), ("b_pt", "u4"), ("b_pv", "u4"),
        ("c_ps", "u4"), ("c_pt", "u4"), ("c_pv", "u4"),
        ("hi_has", "u4"), ("hi_ps", "u4"), ("hi_pt", "u4"), ("hi_pv", "u4"),
        ("hiw", "u4"), ("hp", "u4"),
        # memory access (loads/stores)
        ("mem_has", "u4"), ("mem_addr", "u4"), ("mem_val", "u4"),
        ("mem_ps", "u4"), ("mem_pt", "u4"), ("mem_pv", "u4"),
    ]
)


def _acc_prev(rec):
    if rec is None:
        return 0, 0, 0
    return rec.prev_shard, rec.prev_timestamp, rec.prev_value


def cpu_struct(record) -> np.ndarray:
    """The record's CPU events as a CPU_DTYPE array (cached on the record)."""
    arr = getattr(record, "_cpu_struct", None)
    if arr is not None:
        return arr
    events = record.cpu_events

    def gen():
        for e in events:
            acc = e.access
            ins = e.instruction
            hi = acc.hi
            mem = acc.memory
            yield (
                e.clk, e.pc, e.next_pc, e.next_next_pc,
                int(ins.opcode), ins.op_a, ins.op_b, ins.op_c,
                ins.imm_b, ins.imm_c,
                e.a, e.b, e.c, e.hi_or_prev_a or 0, e.syscall_code,
                *_acc_prev(acc.a), *_acc_prev(acc.b), *_acc_prev(acc.c),
                0 if hi is None else 1, *_acc_prev(hi),
                0 if hi is None else hi.value,
                0 if hi is None else hi.prev_value,
                0 if mem is None else 1,
                0 if mem is None else acc.memory_addr,
                0 if mem is None else mem.value,
                *_acc_prev(mem),
            )

    packed = np.fromiter(gen(), dtype=CPU_DTYPE, count=len(events))
    # structured-field views are strided (row stride = record size), which
    # slows every downstream vector op; hand out contiguous per-field arrays
    arr = Columns({name: np.ascontiguousarray(packed[name]) for name in CPU_DTYPE.names})
    record._cpu_struct = arr
    return arr


class Columns(dict):
    """Dict of per-field contiguous arrays, sliceable like a struct array."""

    def __getitem__(self, key):
        if isinstance(key, str):
            return dict.__getitem__(self, key)
        return Columns({k: v[key] for k, v in self.items()})


def indices_of(record, opcodes) -> np.ndarray:
    """Row indices of the record's CPU events matching the opcode list."""
    ops = cpu_struct(record)["opcode"]
    vals = np.array([int(o) for o in opcodes], dtype=np.uint32)
    return np.flatnonzero(np.isin(ops, vals))


# ---------------------------------------------------------------------------
# Array-backed event views (native trace executor path)
# ---------------------------------------------------------------------------


class _Rec:
    """Memory access record view (read and write records share the shape)."""

    __slots__ = ("value", "shard", "timestamp", "prev_value", "prev_shard", "prev_timestamp")

    def __init__(self, value, shard, timestamp, prev_value, prev_shard, prev_timestamp):
        self.value = value
        self.shard = shard
        self.timestamp = timestamp
        self.prev_value = prev_value
        self.prev_shard = prev_shard
        self.prev_timestamp = prev_timestamp


# access-position clk offsets (opcodes.py POS_*)
_POS_MEMORY, _POS_C, _POS_B, _POS_A, _POS_HI = 0, 1, 2, 3, 4


class _ArrayAccess:
    """MemoryAccessRecord view over one row of the column struct."""

    __slots__ = ("_c", "_i", "_shard")

    def __init__(self, cols, i, shard):
        self._c = cols
        self._i = i
        self._shard = shard

    def _rec(self, prefix, value, pos):
        c, i = self._c, self._i
        return _Rec(
            value, self._shard, int(c["clk"][i]) + pos,
            int(c[f"{prefix}_pv"][i]), int(c[f"{prefix}_ps"][i]), int(c[f"{prefix}_pt"][i]),
        )

    @property
    def a(self):
        # the stored a-register value is not a column; chips only read the
        # prev triple from this record
        return self._rec("a", int(self._c["a"][self._i]), _POS_A)

    @property
    def b(self):
        c, i = self._c, self._i
        if c["imm_b"][i]:
            return None
        return self._rec("b", int(c["b_pv"][i]), _POS_B)

    @property
    def c(self):
        c, i = self._c, self._i
        if c["imm_c"][i]:
            return None
        return self._rec("c", int(c["c_pv"][i]), _POS_C)

    @property
    def hi(self):
        c, i = self._c, self._i
        if not c["hi_has"][i]:
            return None
        return _Rec(
            int(c["hiw"][i]), self._shard, int(c["clk"][i]) + _POS_HI,
            int(c["hp"][i]), int(c["hi_ps"][i]), int(c["hi_pt"][i]),
        )

    @property
    def memory(self):
        c, i = self._c, self._i
        if not c["mem_has"][i]:
            return None
        return self._rec("mem", int(c["mem_val"][i]), _POS_MEMORY)

    @property
    def memory_addr(self):
        return int(self._c["mem_addr"][self._i])


class ArrayEvent:
    """CpuEvent view over one row of the column struct."""

    __slots__ = ("_c", "_i", "_program", "_shard")

    def __init__(self, cols, i, program, shard):
        self._c = cols
        self._i = i
        self._program = program
        self._shard = shard

    @property
    def clk(self):
        return int(self._c["clk"][self._i])

    @property
    def pc(self):
        return int(self._c["pc"][self._i])

    @property
    def next_pc(self):
        return int(self._c["next_pc"][self._i])

    @property
    def next_next_pc(self):
        return int(self._c["nnpc"][self._i])

    @property
    def instruction(self):
        return self._program.fetch(int(self._c["pc"][self._i]))

    @property
    def a(self):
        return int(self._c["a"][self._i])

    @property
    def b(self):
        return int(self._c["b"][self._i])

    @property
    def c(self):
        return int(self._c["c"][self._i])

    @property
    def hi_or_prev_a(self):
        return int(self._c["pa"][self._i])

    @property
    def syscall_code(self):
        return int(self._c["syscall"][self._i])

    @property
    def access(self):
        return _ArrayAccess(self._c, self._i, self._shard)

    exit_code = 0
    is_delay_slot = False


class ArrayCpuEvents:
    """Lazy sequence of ArrayEvent views (record.cpu_events stand-in)."""

    __slots__ = ("cols", "program", "shard")

    def __init__(self, cols, program, shard):
        self.cols = cols
        self.program = program
        self.shard = shard

    def __len__(self):
        return len(self.cols["clk"])

    def __bool__(self):
        return len(self) > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        return ArrayEvent(self.cols, i, self.program, self.shard)

    def __iter__(self):
        for i in range(len(self)):
            yield ArrayEvent(self.cols, i, self.program, self.shard)
