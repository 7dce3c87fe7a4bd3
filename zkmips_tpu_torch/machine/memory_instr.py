"""MemoryInstructions chip: LB..SC including the unaligned LWL/LWR/SWL/SWR.

Analog of crates/core/machine/src/memory/instructions: computes the wrapped
effective address, performs the RAM access through the shared memory-access
gadget at timestamp clk (POS_MEMORY), and verifies the per-opcode byte
extraction/merge against byte decompositions of the previous memory word and
the rt operand (carried as pa in the dispatch message).
"""

from __future__ import annotations

import numpy as np

from ..executor.opcodes import Opcode
from ..ops import field as ff
from ..stark.air import AirBuilder
from .gadgets import ByteSink, ColView, Schema, eval_memory_access, populate_access, send_byte_op, send_u16_check, send_u8_pair
from .instr_chip import InstrAir
from .lookups import ByteOpcode

O = Opcode
TWO32 = (1 << 32) % ff.P
LOADS = [O.LB, O.LBU, O.LH, O.LHU, O.LW, O.LWL, O.LWR, O.LL]
STORES = [O.SB, O.SH, O.SW, O.SWL, O.SWR, O.SC]


class MemoryInstrAir(InstrAir):
    name = "MemoryInstrs"
    OPCODES = LOADS + STORES
    EXTRA_COLS = (
        ["addr", "wrap", "a16", "a15", "p0", "p1", "p2", "p3", "w_lo", "w_hi"]
        + [f"mb{i}" for i in range(4)]
        + [f"pb{i}" for i in range(4)]
        + ["sb", "msb_sb", "sh1", "msb_sh"]
        + Schema([]).access_cols("m")
    )

    def _access_names(self):
        return []

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        sel = dict(zip([f"is_{op.name.lower()}" for op in self.OPCODES], sels))
        is_real = col("is_real")
        a, bw, cw, pa = col.word("a"), col.word("b"), col.word("c"), col.word("pa")
        shard, clk = col("shard"), col("clk")

        def S(*ops):
            e = 0
            for op in ops:
                e = e + sel[f"is_{op.name.lower()}"]
            return e

        is_load = S(*LOADS)
        is_store = S(*STORES)

        # effective address: addr = (b + c) mod 2^32, decomposed + positioned
        addr, wrap = col("addr"), col("wrap")
        b.assert_bool(wrap)
        b.when(is_real).assert_eq(addr + wrap * TWO32, bw.value_expr() + cw.value_expr())
        p = [col(f"p{k}") for k in range(4)]
        tot = 0
        for pk in p:
            b.assert_bool(pk)
            tot = tot + pk
        b.when(is_real).assert_eq(tot, 1)
        i_expr = p[1] + p[2] * 2 + p[3] * 3
        aligned = addr - i_expr
        # addr range: a16 + a15*2^16 with a15 < 2^15 (and memory fence >= 0x1000)
        b.when(is_real).assert_eq(addr, col("a16") + col("a15") * 65536)
        send_u16_check(b, col("a16"), is_real)
        send_u16_check(b, col("a15") * 2, is_real)
        # alignment rules
        b.when(S(O.LH, O.LHU, O.SH)).assert_zero(p[1] + p[3])
        b.when(S(O.LW, O.LL, O.SW, O.SC)).assert_eq(p[0], 1)

        # the RAM access (ts = clk + POS_MEMORY = clk)
        w = col.word("w")
        eval_memory_access(b, col, "m", shard, clk, aligned, w, is_real)
        mprev = col.word("m_prev")
        # loads leave memory unchanged
        b.when(is_load).assert_eq(w.lo, mprev.lo)
        b.when(is_load).assert_eq(w.hi, mprev.hi)

        # byte decompositions: previous memory word and rt (= pa)
        mb = [col(f"mb{i}") for i in range(4)]
        pb = [col(f"pb{i}") for i in range(4)]
        b.when(is_real).assert_eq(mprev.lo, mb[0] + mb[1] * 256)
        b.when(is_real).assert_eq(mprev.hi, mb[2] + mb[3] * 256)
        b.when(is_real).assert_eq(pa.lo, pb[0] + pb[1] * 256)
        b.when(is_real).assert_eq(pa.hi, pb[2] + pb[3] * 256)
        for x, y in ((mb[0], mb[1]), (mb[2], mb[3]), (pb[0], pb[1]), (pb[2], pb[3])):
            send_u8_pair(b, x, y, is_real)

        # --- loads -----------------------------------------------------------
        sb_ = col("sb")
        b.when(is_real).assert_eq(sb_, p[0] * mb[0] + p[1] * mb[1] + p[2] * mb[2] + p[3] * mb[3])
        send_byte_op(b, ByteOpcode.MSB, col("msb_sb"), sb_, 0, S(O.LB))
        sh1 = col("sh1")  # top byte of the selected halfword
        b.when(is_real).assert_eq(sh1, p[0] * mb[1] + p[2] * mb[3])
        send_byte_op(b, ByteOpcode.MSB, col("msb_sh"), sh1, 0, S(O.LH))
        half = p[0] * (mb[0] + mb[1] * 256) + p[2] * (mb[2] + mb[3] * 256)

        b.when(S(O.LB)).assert_eq(a.lo, sb_ + col("msb_sb") * 0xFF00)
        b.when(S(O.LB)).assert_eq(a.hi, col("msb_sb") * 0xFFFF)
        b.when(S(O.LBU)).assert_eq(a.lo, sb_)
        b.when(S(O.LBU)).assert_zero(a.hi)
        b.when(S(O.LH)).assert_eq(a.lo, half)
        b.when(S(O.LH)).assert_eq(a.hi, col("msb_sh") * 0xFFFF)
        b.when(S(O.LHU)).assert_eq(a.lo, half)
        b.when(S(O.LHU)).assert_zero(a.hi)
        b.when(S(O.LW, O.LL)).assert_eq(a.lo, mprev.lo)
        b.when(S(O.LW, O.LL)).assert_eq(a.hi, mprev.hi)

        # LWL: bytes >= 3-i from mem (shifted), below from rt
        def lwl_byte(j):
            e = 0
            for k in range(4):
                src = mb[j - 3 + k] if j >= 3 - k else pb[j]
                e = e + p[k] * src
            return e

        # LWR: bytes <= 3-i from mem (shifted), above from rt
        def lwr_byte(j):
            e = 0
            for k in range(4):
                src = mb[j + k] if j <= 3 - k else pb[j]
                e = e + p[k] * src
            return e

        b.when(S(O.LWL)).assert_eq(a.lo, lwl_byte(0) + lwl_byte(1) * 256)
        b.when(S(O.LWL)).assert_eq(a.hi, lwl_byte(2) + lwl_byte(3) * 256)
        b.when(S(O.LWR)).assert_eq(a.lo, lwr_byte(0) + lwr_byte(1) * 256)
        b.when(S(O.LWR)).assert_eq(a.hi, lwr_byte(2) + lwr_byte(3) * 256)

        # --- stores ----------------------------------------------------------
        # a == rt for plain stores, 1 for SC
        ns = S(O.SB, O.SH, O.SW, O.SWL, O.SWR)
        b.when(ns).assert_eq(a.lo, pa.lo)
        b.when(ns).assert_eq(a.hi, pa.hi)
        b.when(S(O.SC)).assert_eq(a.lo, 1)
        b.when(S(O.SC)).assert_zero(a.hi)

        def sb_byte(j):  # store byte
            e = 0
            for k in range(4):
                e = e + p[k] * (pb[0] if j == k else mb[j])
            return e

        def sh_byte(j):  # store halfword (i in {0, 2})
            e = p[0] * (pb[j] if j <= 1 else mb[j]) + p[2] * (pb[j - 2] if j >= 2 else mb[j])
            return e

        def swl_byte(j):  # bytes <= i from rt high bytes, others mem
            e = 0
            for k in range(4):
                e = e + p[k] * (pb[j + 3 - k] if j <= k else mb[j])
            return e

        def swr_byte(j):  # bytes >= i from rt low bytes
            e = 0
            for k in range(4):
                e = e + p[k] * (pb[j - k] if j >= k else mb[j])
            return e

        for name, fn in (("sb", sb_byte), ("sh", sh_byte), ("swl", swl_byte), ("swr", swr_byte)):
            g = S({"sb": O.SB, "sh": O.SH, "swl": O.SWL, "swr": O.SWR}[name])
            b.when(g).assert_eq(w.lo, fn(0) + fn(1) * 256)
            b.when(g).assert_eq(w.hi, fn(2) + fn(3) * 256)
        b.when(S(O.SW, O.SC)).assert_eq(w.lo, pa.lo)
        b.when(S(O.SW, O.SC)).assert_eq(w.hi, pa.hi)

    # ------------------------------------------------------------ trace side

    def fill_cols(self, t, cs, n_nested, opv, sink) -> bool:
        assert n_nested == 0, "MemoryInstrs receives no nested events"
        n = len(opv)
        if n == 0:
            return True
        s = self.schema
        bb = cs["b"].astype(np.uint64)
        c = cs["c"].astype(np.uint64)
        pa = cs["pa"]
        full = bb + c
        addr = (full & 0xFFFFFFFF).astype(np.uint32)
        t[:, s.idx("addr")] = addr
        t[:, s.idx("wrap")] = (full >> 32).astype(np.uint32)
        pos = addr & 3
        for k in range(4):
            t[:, s.idx(f"p{k}")] = pos == k
        a16 = addr & 0xFFFF
        a15 = addr >> 16
        t[:, s.idx("a16")] = a16
        t[:, s.idx("a15")] = a15
        sink.u16(a16)
        sink.u16(a15 * 2)
        assert cs["mem_has"].all(), "memory instruction without a memory access"
        prev = cs["mem_pv"]
        newv = cs["mem_val"]
        t[:, s.idx("w_lo")] = newv & 0xFFFF
        t[:, s.idx("w_hi")] = newv >> 16
        populate_access(
            t, s, np.arange(n), "m",
            cs["mem_ps"], cs["mem_pt"], prev,
            t[:, s.idx("shard")], cs["clk"], sink,
        )
        for j in range(4):
            t[:, s.idx(f"mb{j}")] = (prev >> (8 * j)) & 0xFF
            t[:, s.idx(f"pb{j}")] = (pa >> (8 * j)) & 0xFF
        sink.u8pair(prev & 0xFF, (prev >> 8) & 0xFF)
        sink.u8pair((prev >> 16) & 0xFF, prev >> 24)
        sink.u8pair(pa & 0xFF, (pa >> 8) & 0xFF)
        sink.u8pair((pa >> 16) & 0xFF, pa >> 24)
        sb_v = (prev >> (8 * pos)) & 0xFF
        t[:, s.idx("sb")] = sb_v
        is_lb = opv == int(O.LB)
        t[:, s.idx("msb_sb")] = np.where(is_lb, sb_v >> 7, 0)
        if is_lb.any():
            sink.msb((sb_v >> 7)[is_lb], sb_v[is_lb])
        sh1_v = np.where(pos == 0, (prev >> 8) & 0xFF, np.where(pos == 2, prev >> 24, 0))
        t[:, s.idx("sh1")] = sh1_v
        is_lh = opv == int(O.LH)
        t[:, s.idx("msb_sh")] = np.where(is_lh, sh1_v >> 7, 0)
        if is_lh.any():
            sink.msb((sh1_v >> 7)[is_lh], sh1_v[is_lh])
        return True

    def fill_op(self, t, i, e, op, sink: ByteSink):
        s = self.schema
        bb, c, pa = int(e.b), int(e.c), int(e.hi_or_prev_a or 0)
        addr = (bb + c) & 0xFFFFFFFF
        t[i, s.idx("addr")] = addr
        if (bb + c) >> 32:
            t[i, s.idx("wrap")] = 1
        pos = addr & 3
        t[i, s.idx(f"p{pos}")] = 1
        t[i, s.idx("a16")] = addr & 0xFFFF
        t[i, s.idx("a15")] = addr >> 16
        sink.u16(np.array([addr & 0xFFFF], dtype=np.uint32))
        sink.u16(np.array([(addr >> 16) * 2], dtype=np.uint32))
        rec = e.access.memory
        prev = int(rec.prev_value)
        newv = int(rec.value)
        t[i, s.idx("w_lo")], t[i, s.idx("w_hi")] = newv & 0xFFFF, newv >> 16
        populate_access(
            t, s, np.array([i]), "m",
            np.array([rec.prev_shard]), np.array([rec.prev_timestamp]), np.array([prev]),
            np.array([rec.shard]), np.array([rec.timestamp]), sink,
        )
        for j in range(4):
            t[i, s.idx(f"mb{j}")] = (prev >> (8 * j)) & 0xFF
            t[i, s.idx(f"pb{j}")] = (pa >> (8 * j)) & 0xFF
        sink.u8pair(np.array([prev & 0xFF], dtype=np.uint32), np.array([(prev >> 8) & 0xFF], dtype=np.uint32))
        sink.u8pair(np.array([(prev >> 16) & 0xFF], dtype=np.uint32), np.array([(prev >> 24) & 0xFF], dtype=np.uint32))
        sink.u8pair(np.array([pa & 0xFF], dtype=np.uint32), np.array([(pa >> 8) & 0xFF], dtype=np.uint32))
        sink.u8pair(np.array([(pa >> 16) & 0xFF], dtype=np.uint32), np.array([(pa >> 24) & 0xFF], dtype=np.uint32))
        sb_v = (prev >> (8 * pos)) & 0xFF
        t[i, s.idx("sb")] = sb_v
        if op == O.LB:
            t[i, s.idx("msb_sb")] = sb_v >> 7
            sink.msb(np.array([sb_v >> 7], dtype=np.uint32), np.array([sb_v], dtype=np.uint32))
        sh1_v = (prev >> 8) & 0xFF if pos == 0 else ((prev >> 24) & 0xFF if pos == 2 else 0)
        t[i, s.idx("sh1")] = sh1_v
        if op == O.LH:
            t[i, s.idx("msb_sh")] = sh1_v >> 7
            sink.msb(np.array([sh1_v >> 7], dtype=np.uint32), np.array([sh1_v], dtype=np.uint32))
