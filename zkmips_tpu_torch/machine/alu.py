"""ALU chips: AddSub, Bitwise, Lt, CloClz (shift/mul/div in their own files).

Analogs of the reference's alu chip family (crates/core/machine/src/alu/),
re-derived for 16-bit limb words: AddSub checks the carry-chain identity in
both directions; Bitwise decomposes limbs to bytes and consults the byte
table; Lt compares via one-hot {lt, eq, gt} limb comparisons with
range-checked differences; CloClz normalizes via the shift-left gadget.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcodes import Opcode
from ..stark.air import AirBuilder
from .gadgets import ByteSink, ColView, send_byte_op, send_u16_check, send_u8_pair
from .instr_chip import InstrAir
from .lookups import ByteOpcode
from .words import split_u32

O = Opcode


class AddSubAir(InstrAir):
    name = "AddSub"
    OPCODES = [O.ADD, O.SUB]
    EXTRA_COLS = ["carry0", "carry1"]

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_add, is_sub = sels
        c0, c1 = col("carry0"), col("carry1")
        b.assert_bool(c0)
        b.assert_bool(c1)
        a, bw, cw = col.word("a"), col.word("b"), col.word("c")
        # ADD: a = b + c;  SUB: a = b - c  <=>  b = a + c
        x_lo = is_add * a.lo + is_sub * bw.lo
        x_hi = is_add * a.hi + is_sub * bw.hi
        y_lo = is_add * bw.lo + is_sub * a.lo
        y_hi = is_add * bw.hi + is_sub * a.hi
        b.assert_zero(x_lo + c0 * 65536 - y_lo - cw.lo)
        b.assert_zero(x_hi + c1 * 65536 - y_hi - cw.hi - c0)
        send_u16_check(b, a.lo, col("is_real"))
        send_u16_check(b, a.hi, col("is_real"))

    def fill_vec(self, t, events, ops, sink: ByteSink) -> bool:
        s = self.schema
        a = (t[:, s.idx("a_lo")].astype(np.uint64) | (t[:, s.idx("a_hi")].astype(np.uint64) << 16))
        bb = (t[:, s.idx("b_lo")].astype(np.uint64) | (t[:, s.idx("b_hi")].astype(np.uint64) << 16))
        c = (t[:, s.idx("c_lo")].astype(np.uint64) | (t[:, s.idx("c_hi")].astype(np.uint64) << 16))
        is_add = t[:, s.idx("is_add")] == 1
        y = np.where(is_add, bb, a)
        carry0 = ((y & 0xFFFF) + (c & 0xFFFF)) >> 16
        carry1 = ((y >> 16) + (c >> 16) + carry0) >> 16
        t[:, s.idx("carry0")] = carry0
        t[:, s.idx("carry1")] = carry1
        sink.u16(t[:, s.idx("a_lo")])
        sink.u16(t[:, s.idx("a_hi")])
        return True


_BW_BYTEOP = {O.AND: ByteOpcode.AND, O.OR: ByteOpcode.OR, O.XOR: ByteOpcode.XOR, O.NOR: ByteOpcode.NOR}


class BitwiseAir(InstrAir):
    name = "Bitwise"
    OPCODES = [O.AND, O.OR, O.XOR, O.NOR]
    EXTRA_COLS = [f"{w}_b{j}" for w in ("a", "b", "c") for j in range(4)]

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_real = col("is_real")
        byte_op = 0
        for op, s_ in zip(self.OPCODES, sels):
            byte_op = byte_op + s_ * int(_BW_BYTEOP[op])
        for w in ("a", "b", "c"):
            word = col.word(w)
            b.when(is_real).assert_eq(word.lo, col(f"{w}_b0") + col(f"{w}_b1") * 256)
            b.when(is_real).assert_eq(word.hi, col(f"{w}_b2") + col(f"{w}_b3") * 256)
        for j in range(4):
            send_byte_op(b, byte_op, col(f"a_b{j}"), col(f"b_b{j}"), col(f"c_b{j}"), is_real)

    def fill_vec(self, t, events, ops, sink: ByteSink) -> bool:
        s = self.schema
        words = {}
        for w in ("a", "b", "c"):
            words[w] = t[:, s.idx(f"{w}_lo")].astype(np.uint32) | (
                t[:, s.idx(f"{w}_hi")].astype(np.uint32) << 16
            )
            for j in range(4):
                t[:, s.idx(f"{w}_b{j}")] = (words[w] >> (8 * j)) & 0xFF
        for j in range(4):
            for op in self.OPCODES:
                m = (ops.array == int(op))
                if not m.any():
                    continue
                sink.byte_op(
                    _BW_BYTEOP[op],
                    (words["a"][m] >> (8 * j)) & 0xFF,
                    (words["b"][m] >> (8 * j)) & 0xFF,
                    (words["c"][m] >> (8 * j)) & 0xFF,
                )
        return True

    def fill_op(self, t, i, e, op, sink: ByteSink):
        s = self.schema
        vals = {"a": int(e.a), "b": int(e.b), "c": int(e.c)}
        for w, v in vals.items():
            for j in range(4):
                t[i, s.idx(f"{w}_b{j}")] = (v >> (8 * j)) & 0xFF
        bop = _BW_BYTEOP[op]
        for j in range(4):
            sink.byte_op(
                bop,
                np.array([(vals["a"] >> (8 * j)) & 0xFF], dtype=np.uint32),
                np.array([(vals["b"] >> (8 * j)) & 0xFF], dtype=np.uint32),
                np.array([(vals["c"] >> (8 * j)) & 0xFF], dtype=np.uint32),
            )


class LtAir(InstrAir):
    name = "Lt"
    OPCODES = [O.SLT, O.SLTU]
    EXTRA_COLS = [
        "b_h0", "b_h1", "c_h0", "c_h1", "msb_b", "msb_c",
        "lt_hi", "eq_hi", "gt_hi", "lt_lo", "eq_lo", "gt_lo", "d_hi", "d_lo",
    ]

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_slt, is_sltu = sels
        is_real = col("is_real")
        a, bw, cw = col.word("a"), col.word("b"), col.word("c")
        # decompose high limbs to bytes for MSB extraction (signed compare)
        for w in ("b", "c"):
            b.when(is_real).assert_eq(col.word(w).hi, col(f"{w}_h0") + col(f"{w}_h1") * 256)
            send_u8_pair(b, col(f"{w}_h0"), col(f"{w}_h1"), is_real)
        send_byte_op(b, ByteOpcode.MSB, col("msb_b"), col("b_h1"), 0, is_real)
        send_byte_op(b, ByteOpcode.MSB, col("msb_c"), col("c_h1"), 0, is_real)
        # signed compare == unsigned compare with sign-flipped high limbs
        flip_b = bw.hi + is_slt * (32768 - 65536 * col("msb_b"))
        flip_c = cw.hi + is_slt * (32768 - 65536 * col("msb_c"))
        # one-hot {lt, eq, gt} on the (possibly flipped) high limb
        lt_h, eq_h, gt_h = col("lt_hi"), col("eq_hi"), col("gt_hi")
        for f_ in (lt_h, eq_h, gt_h):
            b.assert_bool(f_)
        b.when(is_real).assert_eq(lt_h + eq_h + gt_h, 1)
        b.when(eq_h).assert_eq(flip_b, flip_c)
        b.when(lt_h).assert_eq(col("d_hi"), flip_c - flip_b - 1)
        b.when(gt_h).assert_eq(col("d_hi"), flip_b - flip_c - 1)
        send_u16_check(b, col("d_hi"), is_real)
        # low limb comparison (only relevant when high limbs equal)
        lt_l, eq_l, gt_l = col("lt_lo"), col("eq_lo"), col("gt_lo")
        for f_ in (lt_l, eq_l, gt_l):
            b.assert_bool(f_)
        b.when(is_real).assert_eq(lt_l + eq_l + gt_l, 1)
        b.when(eq_l).assert_eq(bw.lo, cw.lo)
        b.when(lt_l).assert_eq(col("d_lo"), cw.lo - bw.lo - 1)
        b.when(gt_l).assert_eq(col("d_lo"), bw.lo - cw.lo - 1)
        send_u16_check(b, col("d_lo"), is_real)
        # result
        b.when(is_real).assert_eq(a.lo, lt_h + eq_h * lt_l)
        b.when(is_real).assert_zero(a.hi)

    def nested_of(self, record):
        ops = set(self.OPCODES)
        return [e for e in record.nested_alu_events if e.opcode in ops]

    def fill_vec(self, t, events, ops, sink: ByteSink) -> bool:
        s = self.schema
        bb = t[:, s.idx("b_lo")].astype(np.int64) | (t[:, s.idx("b_hi")].astype(np.int64) << 16)
        c = t[:, s.idx("c_lo")].astype(np.int64) | (t[:, s.idx("c_hi")].astype(np.int64) << 16)
        b_hi, c_hi = bb >> 16, c >> 16
        b_h0, b_h1 = (b_hi & 0xFF).astype(np.uint32), (b_hi >> 8).astype(np.uint32)
        c_h0, c_h1 = (c_hi & 0xFF).astype(np.uint32), (c_hi >> 8).astype(np.uint32)
        t[:, s.idx("b_h0")], t[:, s.idx("b_h1")] = b_h0, b_h1
        t[:, s.idx("c_h0")], t[:, s.idx("c_h1")] = c_h0, c_h1
        msb_b, msb_c = (b_hi >> 15).astype(np.uint32), (c_hi >> 15).astype(np.uint32)
        t[:, s.idx("msb_b")], t[:, s.idx("msb_c")] = msb_b, msb_c
        sink.u8pair(b_h0, b_h1)
        sink.u8pair(c_h0, c_h1)
        sink.msb(msb_b, b_h1)
        sink.msb(msb_c, c_h1)
        signed = ops.array == int(O.SLT)
        fb = np.where(signed, b_hi ^ 0x8000, b_hi)
        fc = np.where(signed, c_hi ^ 0x8000, c_hi)
        lt_h, eq_h = fb < fc, fb == fc
        t[:, s.idx("lt_hi")] = lt_h
        t[:, s.idx("eq_hi")] = eq_h
        t[:, s.idx("gt_hi")] = ~lt_h & ~eq_h
        d_hi = np.where(lt_h, fc - fb - 1, np.where(eq_h, 0, fb - fc - 1)).astype(np.uint32)
        b_lo, c_lo = bb & 0xFFFF, c & 0xFFFF
        lt_l, eq_l = b_lo < c_lo, b_lo == c_lo
        t[:, s.idx("lt_lo")] = lt_l
        t[:, s.idx("eq_lo")] = eq_l
        t[:, s.idx("gt_lo")] = ~lt_l & ~eq_l
        d_lo = np.where(lt_l, c_lo - b_lo - 1, np.where(eq_l, 0, b_lo - c_lo - 1)).astype(np.uint32)
        t[:, s.idx("d_hi")] = d_hi
        t[:, s.idx("d_lo")] = d_lo
        sink.u16(d_hi)
        sink.u16(d_lo)
        return True

    def fill_op(self, t, i, e, op, sink: ByteSink):
        s = self.schema
        a, bb, c = int(e.a), int(e.b), int(e.c)
        b_hi, c_hi = bb >> 16, c >> 16
        t[i, s.idx("b_h0")], t[i, s.idx("b_h1")] = b_hi & 0xFF, b_hi >> 8
        t[i, s.idx("c_h0")], t[i, s.idx("c_h1")] = c_hi & 0xFF, c_hi >> 8
        msb_b, msb_c = b_hi >> 15, c_hi >> 15
        t[i, s.idx("msb_b")], t[i, s.idx("msb_c")] = msb_b, msb_c
        sink.u8pair(np.array([b_hi & 0xFF], dtype=np.uint32), np.array([b_hi >> 8], dtype=np.uint32))
        sink.u8pair(np.array([c_hi & 0xFF], dtype=np.uint32), np.array([c_hi >> 8], dtype=np.uint32))
        sink.msb(np.array([msb_b], dtype=np.uint32), np.array([b_hi >> 8], dtype=np.uint32))
        sink.msb(np.array([msb_c], dtype=np.uint32), np.array([c_hi >> 8], dtype=np.uint32))
        signed = op == O.SLT
        fb = (b_hi ^ 0x8000) if signed else b_hi
        fc = (c_hi ^ 0x8000) if signed else c_hi
        if fb < fc:
            t[i, s.idx("lt_hi")] = 1
            d_hi = fc - fb - 1
        elif fb == fc:
            t[i, s.idx("eq_hi")] = 1
            d_hi = 0
        else:
            t[i, s.idx("gt_hi")] = 1
            d_hi = fb - fc - 1
        b_lo, c_lo = bb & 0xFFFF, c & 0xFFFF
        if b_lo < c_lo:
            t[i, s.idx("lt_lo")] = 1
            d_lo = c_lo - b_lo - 1
        elif b_lo == c_lo:
            t[i, s.idx("eq_lo")] = 1
            d_lo = 0
        else:
            t[i, s.idx("gt_lo")] = 1
            d_lo = b_lo - c_lo - 1
        t[i, s.idx("d_hi")] = d_hi
        t[i, s.idx("d_lo")] = d_lo
        sink.u16(np.array([d_hi], dtype=np.uint32))
        sink.u16(np.array([d_lo], dtype=np.uint32))
