"""Syscall bridge chips: SyscallCore + SyscallPrecompile.

Analog of the reference's SyscallChip pair (crates/core/machine/src/syscall/
chip.rs:28-218).  Precompile syscalls cross shard boundaries through the
septic-curve Global argument:

  core shard:      SyscallInstrs --local Syscall--> SyscallCore --Global send-->
  deferred shard:  --Global receive--> SyscallPrecompile --local Syscall-->
                   precompile chip

When the precompile events stay in the CPU shard (small families), both
chips live in the same shard and the Global send/receive cancel within it —
the same constraint set covers both layouts.

The Global message packs the syscall as
``[shard, clk, id_lo + id_hi*2^16, arg1_lo, arg1_hi, arg2_lo, arg2_hi]``
(m0 = shard is u16-checked by the Global chip; every defined syscall code
word keeps the top bit clear so the recombined id fits the field).
"""

from __future__ import annotations

import numpy as np

from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .gadgets import ColView, Schema
from .lookups import global_msg, syscall_msg
from .memory_bridge import GlobalLookupEvent

_COLS = [
    "shard", "clk", "id_lo", "id_hi",
    "a1_lo", "a1_hi", "a2_lo", "a2_hi", "is_real",
]


def _syscall_global_message(ev):
    # the recombined code word must fit the field (p = 2^31 - 2^24 + 1); all
    # defined codes keep the top bit clear
    assert ev.syscall_id < 0x7F000001, f"syscall code {ev.syscall_id:#x} too wide"
    return (
        ev.shard, ev.clk, ev.syscall_id,
        ev.arg1 & 0xFFFF, ev.arg1 >> 16, ev.arg2 & 0xFFFF, ev.arg2 >> 16,
    )


class _SyscallBridgeAir(BaseAir):
    IS_CORE = True

    def __init__(self):
        self.schema = Schema(_COLS)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        b.assert_bool(is_real)
        msg = syscall_msg(
            col("shard"), col("clk"), col("id_lo"), col("id_hi"),
            (col("a1_lo"), col("a1_hi")), (col("a2_lo"), col("a2_hi")),
        )
        gmsg = [
            col("shard"), col("clk"), col("id_lo") + col("id_hi") * 65536,
            col("a1_lo"), col("a1_hi"), col("a2_lo"), col("a2_hi"),
        ]
        if self.IS_CORE:
            b.receive(LookupKind.Syscall, msg, is_real)
            b.send(
                LookupKind.Global,
                global_msg(gmsg, is_real, 0, int(LookupKind.Syscall)),
                is_real,
            )
        else:
            b.send(LookupKind.Syscall, msg, is_real)
            b.send(
                LookupKind.Global,
                global_msg(gmsg, 0, is_real, int(LookupKind.Syscall)),
                is_real,
            )

    def _events(self, record) -> list:
        if self.IS_CORE:
            return record.syscall_events
        return [ev for evs in record.precompile_syscall_events.values() for ev in evs]

    def included(self, record) -> bool:
        return bool(self._events(record))

    def generate_dependencies(self, record, output):
        for ev in self._events(record):
            record.global_lookup_events.append(
                GlobalLookupEvent(
                    _syscall_global_message(ev),
                    not self.IS_CORE,  # core side sends, precompile side receives
                    int(LookupKind.Syscall),
                )
            )

    def generate_trace(self, record, output):
        events = self._events(record)
        s = self.schema
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32, order="F")
        for i, ev in enumerate(events):
            t[i] = (
                ev.shard, ev.clk, ev.syscall_id & 0xFFFF, ev.syscall_id >> 16,
                ev.arg1 & 0xFFFF, ev.arg1 >> 16, ev.arg2 & 0xFFFF, ev.arg2 >> 16, 1,
            )
        return t


class SyscallCoreAir(_SyscallBridgeAir):
    name = "SyscallCore"
    IS_CORE = True


class SyscallPrecompileAir(_SyscallBridgeAir):
    name = "SyscallPrecompile"
    IS_CORE = False
