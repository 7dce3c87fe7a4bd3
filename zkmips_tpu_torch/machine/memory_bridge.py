"""Memory bridge chips: MemoryLocal + MemoryGlobalInit/Finalize.

MemoryLocal (analog of crates/core/machine/src/memory/local.rs) anchors each
shard's per-address access chain: it *sends* the initial record into the
shard-local Memory multiset (consumed by the address's first access) and
*receives* the final record (produced by the last access); both endpoint
records are exported to the cross-shard argument as Global-kind lookups
consumed by the Global chip.

MemoryGlobalInit/Finalize (memory/global.rs) are the shard-0 endpoints:
initialization sends (0, 0, addr, image value), finalization receives the
final state; both keep their address columns strictly increasing (duplicate
init/finalize of an address would break memory soundness).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.pool import zeros_mt

from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .gadgets import ByteSink, ColView, Schema, send_u16_check, send_u8_pair
from .lookups import global_msg, memory_msg
from .words import split_u32


@dataclass(frozen=True, slots=True)
class GlobalLookupEvent:
    message: tuple  # 7 canonical ints
    is_receive: bool
    kind: int


def _mem_global_message(shard, clk, addr, v_lo, v_hi):
    return (shard, clk, addr, v_lo, v_hi, 0, 0)


class MemoryLocalAir(BaseAir):
    name = "MemoryLocal"

    _COLS = [
        "addr", "i_shard", "i_clk", "i_lo", "i_hi",
        "f_shard", "f_clk", "f_lo", "f_hi", "is_real",
    ]

    def __init__(self):
        self.schema = Schema(self._COLS)
        self.main_width = self.schema.width

    def included(self, record) -> bool:
        return bool(record.all_local_memory_events())

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        b.assert_bool(is_real)
        addr = col("addr")
        init = col.word("i")
        fin = col.word("f")
        # open/close the shard-local chain
        b.send(LookupKind.Memory, memory_msg(col("i_shard"), col("i_clk"), addr, init), is_real)
        b.receive(LookupKind.Memory, memory_msg(col("f_shard"), col("f_clk"), addr, fin), is_real)
        # export both endpoints to the global argument
        b.send(
            LookupKind.Global,
            global_msg([col("i_shard"), col("i_clk"), addr, init.lo, init.hi, 0, 0], 0, is_real, int(LookupKind.Memory)),
            is_real,
        )
        b.send(
            LookupKind.Global,
            global_msg([col("f_shard"), col("f_clk"), addr, fin.lo, fin.hi, 0, 0], is_real, 0, int(LookupKind.Memory)),
            is_real,
        )

    def generate_dependencies(self, record, output):
        for ev in record.all_local_memory_events():
            i_lo, i_hi = split_u32(ev.initial.value)
            f_lo, f_hi = split_u32(ev.final.value)
            record.global_lookup_events.append(
                GlobalLookupEvent(
                    _mem_global_message(ev.initial.shard, ev.initial.timestamp, ev.addr, i_lo, i_hi),
                    True, int(LookupKind.Memory),
                )
            )
            record.global_lookup_events.append(
                GlobalLookupEvent(
                    _mem_global_message(ev.final.shard, ev.final.timestamp, ev.addr, f_lo, f_hi),
                    False, int(LookupKind.Memory),
                )
            )

    def generate_trace(self, record, output):
        events = sorted(record.all_local_memory_events(), key=lambda e: e.addr)
        s = self.schema
        t = zeros_mt((len(events), s.width), dtype=np.uint32, order="F")
        for i, ev in enumerate(events):
            i_lo, i_hi = split_u32(ev.initial.value)
            f_lo, f_hi = split_u32(ev.final.value)
            t[i] = (
                ev.addr, ev.initial.shard, ev.initial.timestamp, i_lo, i_hi,
                ev.final.shard, ev.final.timestamp, f_lo, f_hi, 1,
            )
        return t


class _MemoryEndpointAir(BaseAir):
    """Shared structure for init/finalize: sorted addresses + global export.

    Cross-shard ordering rides the public values (reference memory/global.rs
    :330-440): the first real row's address must exceed the chained
    ``previous_*_addr`` endpoint (or be address 0 with a second real row when
    the chain is empty), and the last real row's address is exported as
    ``last_*_addr`` — the verifier chains prev(i+1) == last(i), so no address
    can be initialized/finalized twice across shards.
    """

    _COLS = [
        "addr", "a16", "a15", "v_lo", "v_hi", "shard", "clk",
        "cmp_hi", "d", "has_next", "is_real",
        # first-row comparison against the chained previous address endpoint
        "prev_inv", "fc", "fcmp_hi", "fd",
    ]
    IS_INIT = True

    def __init__(self):
        self.schema = Schema(self._COLS)
        self.main_width = self.schema.width

    def _pv_base(self):
        from .pv import (
            PV_LAST_FINALIZE_ADDR,
            PV_LAST_INIT_ADDR,
            PV_PREV_FINALIZE_ADDR,
            PV_PREV_INIT_ADDR,
        )

        if self.IS_INIT:
            return PV_PREV_INIT_ADDR, PV_LAST_INIT_ADDR
        return PV_PREV_FINALIZE_ADDR, PV_LAST_FINALIZE_ADDR

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        b.assert_bool(is_real)
        addr = col("addr")
        v = col.word("v")
        shard, clk = col("shard"), col("clk")
        if self.IS_INIT:
            b.when(is_real).assert_zero(shard)
            b.when(is_real).assert_zero(clk)
            # initial values enter the system here: range check the limbs
            send_u16_check(b, v.lo, is_real)
            send_u16_check(b, v.hi, is_real)
        b.send(
            LookupKind.Global,
            global_msg(
                [shard, clk, addr, v.lo, v.hi, 0, 0],
                is_real if self.IS_INIT else 0,
                0 if self.IS_INIT else is_real,
                int(LookupKind.Memory),
            ),
            is_real,
        )
        # addr = a16 + a15 * 2^16, a15 < 2^15  (addr < 2^31)
        b.when(is_real).assert_eq(addr, col("a16") + col("a15") * 65536)
        send_u16_check(b, col("a16"), is_real)
        send_u16_check(b, col("a15") * 2, is_real)
        # strictly increasing addresses among real rows
        nxt_real = col("is_real", 1)
        b.when_transition().when(nxt_real).assert_one(is_real)  # real-rows prefix
        has_next = col("has_next")
        b.when_transition().assert_eq(has_next, is_real * nxt_real)
        b.when_last_row().assert_zero(has_next)
        cmp_hi = col("cmp_hi")
        b.assert_bool(cmp_hi)
        t = b.when_transition().when(nxt_real)
        t.when(cmp_hi).assert_eq(col("d"), col("a15", 1) - col("a15") - 1)
        t.when_not(cmp_hi).assert_eq(col("a15", 1), col("a15"))
        t.when_not(cmp_hi).assert_eq(col("d"), col("a16", 1) - col("a16") - 1)
        send_u16_check(b, col("d"), col("has_next"))

        # ---- public-value address endpoints ------------------------------
        pv_prev, pv_last = self._pv_base()
        prev_lo = b.public_value(pv_prev)
        prev_hi = b.public_value(pv_prev + 1)
        # fc = 1 on the first row iff prev != 0 (limbs are canonical by the
        # verifier's chain: prev(i+1) == last(i), last bound below, first
        # shard prev == 0); s = lo + hi < 2^17 so s == 0 iff prev == 0
        fc = col("fc")
        s = prev_lo + prev_hi
        fr = b.when_first_row()
        fr.assert_eq(fc, s * col("prev_inv"))
        fr.assert_zero((1 - fc) * s)
        b.when_transition().assert_zero(col("fc", 1))  # fc lives on row 0 only
        # a present chip must carry at least one real row, so the last-row
        # endpoint binding below always fires (an absent chip is instead
        # checked by the verifier's prev == last rule)
        fr.assert_one(is_real)
        # prev == 0: the chain opens here — first address must be 0 and a
        # second real row must exist so last > 0 chains nonzero onward
        # (reference global.rs:393-397 double-init guard)
        fr.when_not(fc).assert_zero(addr)
        fr.when_not(fc).assert_one(nxt_real)
        # prev != 0: prev < addr lexicographically over (hi, lo) limbs
        fcmp_hi = col("fcmp_hi")
        fd = col("fd")
        b.assert_bool(fcmp_hi)
        b.when(fc).when(fcmp_hi).assert_eq(fd, col("a15") - prev_hi - 1)
        b.when(fc).when_not(fcmp_hi).assert_eq(col("a15"), prev_hi)
        b.when(fc).when_not(fcmp_hi).assert_eq(fd, col("a16") - prev_lo - 1)
        send_u16_check(b, fd, fc)
        # the last real row exports its address as the shard's last endpoint
        is_last_real = is_real - has_next
        b.when(is_last_real).assert_eq(col("a16"), b.public_value(pv_last))
        b.when(is_last_real).assert_eq(col("a15"), b.public_value(pv_last + 1))

    def _events(self, record):
        evs = record.global_memory_initialize_events if self.IS_INIT else record.global_memory_finalize_events
        return sorted(evs, key=lambda e: e.addr)

    def included(self, record) -> bool:
        return bool(self._events(record))

    def generate_dependencies(self, record, output):
        for ev in self._events(record):
            lo, hi = split_u32(ev.value)
            record.global_lookup_events.append(
                GlobalLookupEvent(
                    _mem_global_message(ev.shard, ev.timestamp, ev.addr, lo, hi),
                    not self.IS_INIT, int(LookupKind.Memory),
                )
            )

    def generate_trace(self, record, output):
        events = self._events(record)
        s = self.schema
        t = zeros_mt((len(events), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        if events:
            from ..ops import field as ff

            rpv = record.public_values
            prev = rpv.prev_init_addr if self.IS_INIT else rpv.prev_finalize_addr
            last = rpv.last_init_addr if self.IS_INIT else rpv.last_finalize_addr
            assert events[-1].addr == last, (
                f"{self.name}: pv last addr {last:#x} != {events[-1].addr:#x}"
            )
            p_lo, p_hi = prev & 0xFFFF, prev >> 16
            ssum = p_lo + p_hi
            if ssum:
                t[0, s.idx("fc")] = 1
                t[0, s.idx("prev_inv")] = ff.inv_int(ssum)
                a0 = events[0].addr
                a16_0, a15_0 = a0 & 0xFFFF, a0 >> 16
                if a15_0 > p_hi:
                    t[0, s.idx("fcmp_hi")] = 1
                    fd = a15_0 - p_hi - 1
                else:
                    assert a15_0 == p_hi and a16_0 > p_lo, (
                        f"{self.name}: first addr {a0:#x} not above prev {prev:#x}"
                    )
                    fd = a16_0 - p_lo - 1
                t[0, s.idx("fd")] = fd
                sink.u16(np.array([fd], dtype=np.uint32))
            else:
                assert events[0].addr == 0, (
                    f"{self.name}: chain opens at {events[0].addr:#x}, expected 0"
                )
                assert len(events) >= 2, f"{self.name}: chain opener needs >= 2 rows"
        for i, ev in enumerate(events):
            lo, hi = split_u32(ev.value)
            a16, a15 = ev.addr & 0xFFFF, ev.addr >> 16
            t[i, s.idx("addr")] = ev.addr
            t[i, s.idx("a16")] = a16
            t[i, s.idx("a15")] = a15
            t[i, s.idx("v_lo")] = lo
            t[i, s.idx("v_hi")] = hi
            t[i, s.idx("shard")] = ev.shard
            t[i, s.idx("clk")] = ev.timestamp
            t[i, s.idx("is_real")] = 1
            sink.u16(np.array([a16], dtype=np.uint32))
            sink.u16(np.array([a15 * 2], dtype=np.uint32))
            if self.IS_INIT:
                sink.u16(np.array([lo], dtype=np.uint32))
                sink.u16(np.array([hi], dtype=np.uint32))
            if i + 1 < len(events):
                nxt = events[i + 1]
                n16, n15 = nxt.addr & 0xFFFF, nxt.addr >> 16
                if n15 > a15:
                    t[i, s.idx("cmp_hi")] = 1
                    d = n15 - a15 - 1
                else:
                    assert n15 == a15 and n16 > a16, "addresses not strictly increasing"
                    d = n16 - a16 - 1
                t[i, s.idx("d")] = d
                t[i, s.idx("has_next")] = 1
                sink.u16(np.array([d], dtype=np.uint32))
        return t


class MemoryGlobalInitAir(_MemoryEndpointAir):
    name = "MemoryGlobalInit"
    IS_INIT = True


class MemoryGlobalFinalizeAir(_MemoryEndpointAir):
    name = "MemoryGlobalFinalize"
    IS_INIT = False
