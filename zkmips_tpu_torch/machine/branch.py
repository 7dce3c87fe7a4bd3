"""Branch chip: BEQ/BNE/BGEZ/BGTZ/BLEZ/BLTZ with delay-slot pc semantics.

Analog of crates/core/machine/src/control_flow/branch.rs.  Conditions are
derived from word equality (is-zero gadgets on limb differences) and the
sign bit (MSB byte lookup); the taken target is next_pc + offset with u32
wraparound handled by a boolean wrap column (pc values are bound to the
program table by the next row's fetch).
"""

from __future__ import annotations

import numpy as np

from ..executor.opcodes import Opcode
from ..ops import field as ff
from ..stark.air import AirBuilder
from .gadgets import ByteSink, ColView, send_byte_op, send_u8_pair
from .instr_chip import InstrAir
from .lookups import ByteOpcode

O = Opcode
TWO32 = (1 << 32) % ff.P


class BranchAir(InstrAir):
    name = "Branch"
    OPCODES = [O.BEQ, O.BNE, O.BGEZ, O.BGTZ, O.BLEZ, O.BLTZ]
    EXTRA_COLS = [
        "z_lo", "inv_lo", "z_hi", "inv_hi", "eq",
        "a_h0", "a_h1", "msb_a", "is_taken", "wrap",
    ]

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_beq, is_bne, is_bgez, is_bgtz, is_blez, is_bltz = sels
        is_real = col("is_real")
        a, bw, cw = col.word("a"), col.word("b"), col.word("c")

        # word equality a == b (for one-operand branches b == 0 -> a == 0 test)
        dl = a.lo - bw.lo
        dh = a.hi - bw.hi
        z_lo, inv_lo = col("z_lo"), col("inv_lo")
        z_hi, inv_hi = col("z_hi"), col("inv_hi")
        for z, inv, d in ((z_lo, inv_lo, dl), (z_hi, inv_hi, dh)):
            b.assert_bool(z)
            b.assert_zero(z * d)
            b.when(is_real).assert_zero(z + d * inv - 1)
        eq = col("eq")
        b.assert_eq(eq, z_lo * z_hi)

        # sign of a
        b.when(is_real).assert_eq(a.hi, col("a_h0") + col("a_h1") * 256)
        send_u8_pair(b, col("a_h0"), col("a_h1"), is_real)
        send_byte_op(b, ByteOpcode.MSB, col("msb_a"), col("a_h1"), 0, is_real)
        msb = col("msb_a")

        taken = col("is_taken")
        b.assert_bool(taken)
        cond = (
            is_beq * eq
            + is_bne * (1 - eq)
            + is_bgez * (1 - msb)
            + is_bltz * msb
            + is_bgtz * (1 - msb) * (1 - eq)
            + is_blez * (msb + (1 - msb) * eq)
        )
        b.when(is_real).assert_eq(taken, cond)

        # target pc
        wrap = col("wrap")
        b.assert_bool(wrap)
        nnpc = col("next_next_pc")
        next_pc = col("next_pc")
        b.when(taken).assert_eq(nnpc + wrap * TWO32, next_pc + cw.value_expr())
        b.when(is_real).when_not(taken).assert_eq(nnpc, next_pc + 4)

    def fill_vec(self, t, events, ops, sink) -> bool:
        s = self.schema
        a = t[:, s.idx("a_lo")].astype(np.int64) | (t[:, s.idx("a_hi")].astype(np.int64) << 16)
        bb = t[:, s.idx("b_lo")].astype(np.int64) | (t[:, s.idx("b_hi")].astype(np.int64) << 16)
        c = t[:, s.idx("c_lo")].astype(np.int64) | (t[:, s.idx("c_hi")].astype(np.int64) << 16)
        next_pc = t[:, s.idx("next_pc")].astype(np.int64)
        dl = (a & 0xFFFF) - (bb & 0xFFFF)
        dh = (a >> 16) - (bb >> 16)
        z_lo, z_hi = dl == 0, dh == 0
        t[:, s.idx("z_lo")] = z_lo
        t[:, s.idx("z_hi")] = z_hi
        for d, zcol, icol in ((dl, z_lo, "inv_lo"), (dh, z_hi, "inv_hi")):
            dm = ff.to_monty(np.where(zcol, 1, d % ff.P).astype(np.uint32))
            t[:, s.idx(icol)] = np.where(zcol, 0, ff.from_monty(ff.inv(dm)))
        t[:, s.idx("eq")] = z_lo & z_hi
        a_hi = a >> 16
        a_h0, a_h1 = (a_hi & 0xFF).astype(np.uint32), (a_hi >> 8).astype(np.uint32)
        t[:, s.idx("a_h0")], t[:, s.idx("a_h1")] = a_h0, a_h1
        sink.u8pair(a_h0, a_h1)
        msb = (a >> 31).astype(np.uint32)
        t[:, s.idx("msb_a")] = msb
        sink.msb(msb, a_h1)
        sa = np.where(a >> 31, a - (1 << 32), a)
        opv = (ops.array.astype(np.int64) if hasattr(ops, "array")
               else np.array([int(o) for o in ops], dtype=np.int64))
        taken = np.select(
            [opv == int(O.BEQ), opv == int(O.BNE), opv == int(O.BGEZ),
             opv == int(O.BGTZ), opv == int(O.BLEZ), opv == int(O.BLTZ)],
            [a == bb, a != bb, sa >= 0, sa > 0, sa <= 0, sa < 0],
        )
        t[:, s.idx("is_taken")] = taken
        t[:, s.idx("wrap")] = taken & (next_pc + c >= (1 << 32))
        return True

    def fill_op(self, t, i, e, op, sink: ByteSink):
        s = self.schema
        a, bb = int(e.a), int(e.b)
        dl = (a & 0xFFFF) - (bb & 0xFFFF)
        dh = (a >> 16) - (bb >> 16)
        z_lo, z_hi = int(dl == 0), int(dh == 0)
        t[i, s.idx("z_lo")], t[i, s.idx("z_hi")] = z_lo, z_hi
        if dl:
            t[i, s.idx("inv_lo")] = ff.inv_int(dl % ff.P)
        if dh:
            t[i, s.idx("inv_hi")] = ff.inv_int(dh % ff.P)
        t[i, s.idx("eq")] = z_lo & z_hi
        a_hi = a >> 16
        t[i, s.idx("a_h0")], t[i, s.idx("a_h1")] = a_hi & 0xFF, a_hi >> 8
        sink.u8pair(np.array([a_hi & 0xFF], dtype=np.uint32), np.array([a_hi >> 8], dtype=np.uint32))
        msb = a >> 31
        t[i, s.idx("msb_a")] = msb
        sink.msb(np.array([msb], dtype=np.uint32), np.array([a_hi >> 8], dtype=np.uint32))
        taken = int(_cond(op, a, bb))
        t[i, s.idx("is_taken")] = taken
        if taken and (e.next_pc + int(e.c)) >= (1 << 32):
            t[i, s.idx("wrap")] = 1


def _cond(op, a, bb):
    sa = a - (1 << 32) if a >> 31 else a
    if op == O.BEQ:
        return a == bb
    if op == O.BNE:
        return a != bb
    if op == O.BGEZ:
        return sa >= 0
    if op == O.BGTZ:
        return sa > 0
    if op == O.BLEZ:
        return sa <= 0
    return sa < 0
