"""Mul chip: MUL / MULT / MULTU via byte-product accumulation.

Analog of crates/core/machine/src/alu/mul: the 64-bit product is built from
16 byte partial products with range-checked carries; signed MULT adjusts the
unsigned high word by msb_b * c + msb_c * b (two's-complement identity).
Rows also serve nested requests (DivRem, MADD family verify through here).
"""

from __future__ import annotations

import numpy as np

from ..executor.opcodes import Opcode
from ..stark.air import AirBuilder
from .gadgets import ByteSink, ColView, send_byte_op, send_u16_check, send_u8_pair
from .instr_chip import InstrAir
from .lookups import ByteOpcode

O = Opcode


class MulAir(InstrAir):
    name = "Mul"
    OPCODES = [O.MUL, O.MULT, O.MULTU]
    EXTRA_COLS = (
        [f"b_b{i}" for i in range(4)]
        + [f"c_b{i}" for i in range(4)]
        + [f"r_b{i}" for i in range(8)]
        + [f"carry{i}" for i in range(7)]
        + ["b_h1", "c_h1", "msb_b", "msb_c", "adj_lo", "adj_hi", "adj_c0", "adj_c1", "k0", "k1", "k2", "hs_lo", "hs_hi"]
    )

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_mul, is_mult, is_multu = sels
        is_real = col("is_real")
        a, bw, cw = col.word("a"), col.word("b"), col.word("c")
        bb = [col(f"b_b{i}") for i in range(4)]
        cb = [col(f"c_b{i}") for i in range(4)]
        rb = [col(f"r_b{i}") for i in range(8)]
        # byte decompositions (pair checks also range check the bytes)
        b.when(is_real).assert_eq(bw.lo, bb[0] + bb[1] * 256)
        b.when(is_real).assert_eq(bw.hi, bb[2] + bb[3] * 256)
        b.when(is_real).assert_eq(cw.lo, cb[0] + cb[1] * 256)
        b.when(is_real).assert_eq(cw.hi, cb[2] + cb[3] * 256)
        for x, y in ((bb[0], bb[1]), (bb[2], bb[3]), (cb[0], cb[1]), (cb[2], cb[3])):
            send_u8_pair(b, x, y, is_real)
        for j in range(0, 8, 2):
            send_u8_pair(b, rb[j], rb[j + 1], is_real)
        # carry chain over positional byte sums
        carries = [col(f"carry{i}") for i in range(7)]
        prev_carry = 0
        for k in range(8):
            prod = 0
            for i in range(4):
                j = k - i
                if 0 <= j <= 3:
                    prod = prod + bb[i] * cb[j]
            if k < 7:
                b.when(is_real).assert_eq(prod + prev_carry, rb[k] + carries[k] * 256)
                send_u16_check(b, carries[k], is_real)
                prev_carry = carries[k]
            else:
                # top byte: remaining carry folds in mod 2^64
                b.when(is_real).assert_eq(prod + prev_carry - rb[k], col("k1") * 256)
        lo_lo = rb[0] + rb[1] * 256
        lo_hi = rb[2] + rb[3] * 256
        hu_lo = rb[4] + rb[5] * 256
        hu_hi = rb[6] + rb[7] * 256
        # a = low word for all three ops
        b.when(is_real).assert_eq(a.lo, lo_lo)
        b.when(is_real).assert_eq(a.hi, lo_hi)

        # signed adjustment: hs = hu - (msb_b * c + msb_c * b) mod 2^32
        b.when(is_real).assert_eq(col("b_h1"), bb[3])
        b.when(is_real).assert_eq(col("c_h1"), cb[3])
        send_byte_op(b, ByteOpcode.MSB, col("msb_b"), col("b_h1"), 0, is_real)
        send_byte_op(b, ByteOpcode.MSB, col("msb_c"), col("c_h1"), 0, is_real)
        mb = is_mult * col("msb_b")  # only MULT is signed
        mc = is_mult * col("msb_c")
        adj_lo, adj_hi = col("adj_lo"), col("adj_hi")
        adj_c0, adj_c1 = col("adj_c0"), col("adj_c1")
        b.assert_bool(adj_c0)
        b.assert_bool(adj_c1)
        b.when(is_real).assert_eq(mb * cw.lo + mc * bw.lo, adj_lo + adj_c0 * 65536)
        b.when(is_real).assert_eq(mb * cw.hi + mc * bw.hi + adj_c0, adj_hi + adj_c1 * 65536)
        send_u16_check(b, adj_lo, is_real)
        send_u16_check(b, adj_hi, is_real)
        # hs + adj == hu (mod 2^32): limb identity with discarded wrap k2
        hs_lo, hs_hi = col("hs_lo"), col("hs_hi")
        k0, k2 = col("k0"), col("k2")
        b.assert_bool(k0)
        b.assert_zero(k2 * (k2 - 1) * (k2 - 2))
        b.when(is_real).assert_eq(hs_lo + adj_lo, hu_lo + k0 * 65536)
        b.when(is_real).assert_eq(hs_hi + adj_hi + k0, hu_hi + k2 * 65536)
        send_u16_check(b, hs_lo, is_real)
        send_u16_check(b, hs_hi, is_real)
        # hi word written: MULT -> hs, MULTU -> hu (MUL writes none)
        hiw = col.word("hiw")
        b.when(is_mult).assert_eq(hiw.lo, hs_lo)
        b.when(is_mult).assert_eq(hiw.hi, hs_hi)
        b.when(is_multu).assert_eq(hiw.lo, hu_lo)
        b.when(is_multu).assert_eq(hiw.hi, hu_hi)

    def nested_of(self, record):
        ops = set(self.OPCODES)
        return [e for e in record.nested_alu_events if e.opcode in ops]

    def fill_op(self, t, i, e, op, sink: ByteSink):
        s = self.schema
        bb, c = int(e.b), int(e.c)
        full = bb * c  # unsigned 64-bit
        for j in range(4):
            t[i, s.idx(f"b_b{j}")] = (bb >> (8 * j)) & 0xFF
            t[i, s.idx(f"c_b{j}")] = (c >> (8 * j)) & 0xFF
        sink.u8pair(np.array([bb & 0xFF], dtype=np.uint32), np.array([(bb >> 8) & 0xFF], dtype=np.uint32))
        sink.u8pair(np.array([(bb >> 16) & 0xFF], dtype=np.uint32), np.array([(bb >> 24) & 0xFF], dtype=np.uint32))
        sink.u8pair(np.array([c & 0xFF], dtype=np.uint32), np.array([(c >> 8) & 0xFF], dtype=np.uint32))
        sink.u8pair(np.array([(c >> 16) & 0xFF], dtype=np.uint32), np.array([(c >> 24) & 0xFF], dtype=np.uint32))
        for j in range(8):
            t[i, s.idx(f"r_b{j}")] = (full >> (8 * j)) & 0xFF
        for j in range(0, 8, 2):
            sink.u8pair(np.array([(full >> (8 * j)) & 0xFF], dtype=np.uint32), np.array([(full >> (8 * (j + 1))) & 0xFF], dtype=np.uint32))
        prev = 0
        for k in range(7):
            prod = sum(((bb >> (8 * ii)) & 0xFF) * ((c >> (8 * jj)) & 0xFF) for ii in range(4) for jj in range(4) if ii + jj == k)
            carry = (prod + prev - ((full >> (8 * k)) & 0xFF)) // 256
            t[i, s.idx(f"carry{k}")] = carry
            sink.u16(np.array([carry], dtype=np.uint32))
            prev = carry
        prod7 = sum(((bb >> (8 * ii)) & 0xFF) * ((c >> (8 * jj)) & 0xFF) for ii in range(4) for jj in range(4) if ii + jj == 7)
        k1 = (prod7 + prev - ((full >> 56) & 0xFF)) // 256
        t[i, s.idx("k1")] = k1
        msb_b, msb_c = bb >> 31, c >> 31
        t[i, s.idx("b_h1")] = (bb >> 24) & 0xFF
        t[i, s.idx("c_h1")] = (c >> 24) & 0xFF
        t[i, s.idx("msb_b")] = msb_b
        t[i, s.idx("msb_c")] = msb_c
        sink.msb(np.array([msb_b], dtype=np.uint32), np.array([(bb >> 24) & 0xFF], dtype=np.uint32))
        sink.msb(np.array([msb_c], dtype=np.uint32), np.array([(c >> 24) & 0xFF], dtype=np.uint32))
        signed = op == O.MULT
        mb = msb_b if signed else 0
        mc = msb_c if signed else 0
        adj = mb * c + mc * bb
        adj_lo = adj & 0xFFFF
        adj_c0 = 1 if ((mb * (c & 0xFFFF) + mc * (bb & 0xFFFF)) >> 16) else 0
        adj_hi = (mb * (c >> 16) + mc * (bb >> 16) + adj_c0) & 0xFFFF
        adj_c1 = (mb * (c >> 16) + mc * (bb >> 16) + adj_c0) >> 16
        t[i, s.idx("adj_lo")] = adj_lo
        t[i, s.idx("adj_hi")] = adj_hi
        t[i, s.idx("adj_c0")] = adj_c0
        t[i, s.idx("adj_c1")] = adj_c1
        sink.u16(np.array([adj_lo], dtype=np.uint32))
        sink.u16(np.array([adj_hi], dtype=np.uint32))
        hu = (full >> 32) & 0xFFFFFFFF
        hs = (hu - adj) & 0xFFFFFFFF
        t[i, s.idx("hs_lo")] = hs & 0xFFFF
        t[i, s.idx("hs_hi")] = hs >> 16
        sink.u16(np.array([hs & 0xFFFF], dtype=np.uint32))
        sink.u16(np.array([hs >> 16], dtype=np.uint32))
        k0 = 1 if ((hs & 0xFFFF) + adj_lo) >= 65536 else 0
        t[i, s.idx("k0")] = k0
        hu_hi = hu >> 16
        t[i, s.idx("k2")] = ((hs >> 16) + adj_hi + k0 - hu_hi) >> 16
