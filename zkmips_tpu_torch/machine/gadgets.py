"""Shared chip-building helpers: named column schemas, memory-access and
range-check gadgets (AIR side + trace side).

The AIR-side gadgets mirror the reference's MemoryAirBuilder
(crates/core/machine/src/air/memory.rs): a register/memory access receives
the previous (shard, clk, addr, value) record and sends the new one, with a
lexicographic (shard, clk) ordering check range-checked through the byte
table (diff decomposed into 16 + 8 bit limbs; clk < 2^24).
"""

from __future__ import annotations

import numpy as np

from ..stark.air import AirBuilder, LookupKind
from .lookups import ByteOpcode, byte_msg, memory_msg
from .words import WordExpr


class Schema:
    """Named main-trace columns for a chip."""

    def __init__(self, names: list[str]):
        self.names = list(names)
        self.index = {n: i for i, n in enumerate(self.names)}
        assert len(self.index) == len(self.names), "duplicate column name"

    @property
    def width(self) -> int:
        return len(self.names)

    def idx(self, name: str) -> int:
        return self.index[name]

    def access_cols(self, prefix: str) -> list[str]:
        """Column names for one memory-access gadget instance."""
        return [
            f"{prefix}_prev_shard",
            f"{prefix}_prev_clk",
            f"{prefix}_prev_lo",
            f"{prefix}_prev_hi",
            f"{prefix}_cmp_clk",
            f"{prefix}_d16",
            f"{prefix}_d8",
        ]


class ColView:
    """AIR-side accessor: col('name') / col('name', 1) -> Expr."""

    def __init__(self, builder: AirBuilder, schema: Schema):
        self.b = builder
        self.s = schema

    def __call__(self, name: str, offset: int = 0):
        return self.b.main(self.s.idx(name), offset)

    def word(self, prefix: str, offset: int = 0) -> WordExpr:
        return WordExpr(self(f"{prefix}_lo", offset), self(f"{prefix}_hi", offset))


# ------------------------------------------------------------------ AIR side


def send_u16_check(builder, value, mult):
    builder.send(LookupKind.Byte, byte_msg(int(ByteOpcode.U16Range), value, 0, 0), mult)


def send_u8_pair(builder, b, c, mult):
    builder.send(LookupKind.Byte, byte_msg(int(ByteOpcode.U8Pair), 0, b, c), mult)


def send_byte_op(builder, op, a, b, c, mult):
    """op may be a ByteOpcode constant or an Expr (selector-combined)."""
    if isinstance(op, (int, ByteOpcode)):
        op = int(op)
    builder.send(LookupKind.Byte, byte_msg(op, a, b, c), mult)


def eval_memory_access(builder, col: ColView, prefix: str, shard, clk, addr, value: WordExpr, mult):
    """Receive the previous record, send the new one, check ordering.

    Columns required (Schema.access_cols): prev_shard, prev_clk, prev_lo,
    prev_hi, cmp_clk, d16, d8.  ``mult`` must be boolean (0/1).
    """
    prev_shard = col(f"{prefix}_prev_shard")
    prev_clk = col(f"{prefix}_prev_clk")
    prev = col.word(f"{prefix}_prev")
    cmp_clk = col(f"{prefix}_cmp_clk")
    d16 = col(f"{prefix}_d16")
    d8 = col(f"{prefix}_d8")

    builder.receive(LookupKind.Memory, memory_msg(prev_shard, prev_clk, addr, prev), mult)
    builder.send(LookupKind.Memory, memory_msg(shard, clk, addr, value), mult)

    # ordering: (prev_shard, prev_clk) < (shard, clk)
    builder.assert_bool(cmp_clk)
    w = builder.when(mult)
    w.when(cmp_clk).assert_eq(shard, prev_shard)
    diff = d16 + d8 * 65536
    w.when(cmp_clk).assert_eq(diff, clk - prev_clk - 1)
    w.when_not(cmp_clk).assert_eq(diff, shard - prev_shard - 1)
    # d16 in [0,2^16), d8 in [0,2^8): diff < 2^24
    send_u16_check(builder, d16, mult)
    send_u8_pair(builder, d8, 0, mult)


# ---------------------------------------------------------------- trace side


def populate_access(trace, s: Schema, rows, prefix: str, prev_shard, prev_clk, prev_val_u32, shard, clk, byte_sink):
    """Fill access gadget columns for the given row indices (all numpy)."""
    prev_shard = np.asarray(prev_shard, dtype=np.uint32)
    prev_clk = np.asarray(prev_clk, dtype=np.uint32)
    shard = np.asarray(shard, dtype=np.uint32)
    clk = np.asarray(clk, dtype=np.uint32)
    same = prev_shard == shard
    diff = np.where(same, clk - prev_clk - 1, shard - prev_shard - 1).astype(np.uint32)
    d16 = diff & 0xFFFF
    d8 = diff >> 16
    assert (d8 < 256).all(), "timestamp diff exceeds 24 bits"
    trace[rows, s.idx(f"{prefix}_prev_shard")] = prev_shard
    trace[rows, s.idx(f"{prefix}_prev_clk")] = prev_clk
    pv = np.asarray(prev_val_u32, dtype=np.uint32)
    trace[rows, s.idx(f"{prefix}_prev_lo")] = pv & 0xFFFF
    trace[rows, s.idx(f"{prefix}_prev_hi")] = pv >> 16
    trace[rows, s.idx(f"{prefix}_cmp_clk")] = same.astype(np.uint32)
    trace[rows, s.idx(f"{prefix}_d16")] = d16
    trace[rows, s.idx(f"{prefix}_d8")] = d8
    byte_sink.u16(d16)
    byte_sink.u8pair(d8, np.zeros_like(d8))


class ByteSink:
    """Collects byte-table lookup multiplicities during trace generation."""

    def __init__(self, record):
        self.record = record

    def _add(self, op: ByteOpcode, a, b, c):
        # fields the Byte chip's multiplicity bincount never reads are None
        # (the send-side message values come from each chip's own AIR exprs)
        cv = lambda x: None if x is None else np.asarray(x, dtype=np.uint32).ravel()
        self.record.byte_lookups.setdefault("arrays", []).append(
            (int(op), cv(a), cv(b), cv(c))
        )

    def u16(self, v):
        self._add(ByteOpcode.U16Range, v, None, None)

    def u8pair(self, b, c):
        self._add(ByteOpcode.U8Pair, None, b, c)

    def byte_op(self, op, a, b, c):
        assert op != ByteOpcode.U16Range
        self._add(op, None, b, c)

    def msb(self, msb, b):
        self._add(ByteOpcode.MSB, None, b, None)

    def ltu(self, lt, b, c):
        self._add(ByteOpcode.LTU, None, b, c)

    def pow2(self, m, s):
        self._add(ByteOpcode.POW2, None, s, None)


def pad_height(n: int, min_rows: int = 16) -> int:
    if n == 0:
        return min_rows
    return max(min_rows, 1 << (n - 1).bit_length())
