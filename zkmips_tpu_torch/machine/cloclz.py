"""CloClz chip: count leading zeros / ones.

Analog of crates/core/machine/src/alu/clo_clz: a = clz(in) is verified by
requiring in << a to be wrap-free with its top bit set (in * 2^a in
[2^31, 2^32)); CLO runs on the complemented input; in == 0 yields 32.
"""

from __future__ import annotations

import numpy as np

from ..executor.opcodes import Opcode
from ..ops import field as ff
from ..stark.air import AirBuilder
from .gadgets import ByteSink, ColView, send_u16_check, send_u8_pair
from .instr_chip import InstrAir
from .shift import ShiftGadget

O = Opcode


class CloClzAir(InstrAir):
    name = "CloClz"
    OPCODES = [O.CLZ, O.CLO]
    EXTRA_COLS = (
        ["in_lo", "in_hi", "z", "zinv"] + [f"s{i}" for i in range(5)]
        + [f"ib{i}" for i in range(4)] + ["top"] + ShiftGadget("g").cols()
    )

    def __init__(self):
        super().__init__()
        self.gadget = ShiftGadget("g")

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_clz, is_clo = sels
        is_real = col("is_real")
        a, bw = col.word("a"), col.word("b")
        # input: b (CLZ) or ~b (CLO)
        b.when(is_real).assert_eq(col("in_lo"), bw.lo + is_clo * (65535 - 2 * bw.lo))
        b.when(is_real).assert_eq(col("in_hi"), bw.hi + is_clo * (65535 - 2 * bw.hi))
        inw = col.word("in")
        # zero flag (limbs u16 by induction)
        z, zinv = col("z"), col("zinv")
        b.assert_bool(z)
        b.assert_zero(z * (inw.lo + inw.hi))
        b.when(is_real).assert_zero(z + (inw.lo + inw.hi) * zinv - 1)
        # result: a = 32 when in == 0, else shift amount with top bit landing
        b.when(is_real).when(z).assert_eq(a.lo, 32)
        b.when(is_real).assert_zero(a.hi)
        sbits = [col(f"s{i}") for i in range(5)]
        for s_ in sbits:
            b.assert_bool(s_)
        s = sbits[0] + sbits[1] * 2 + sbits[2] * 4 + sbits[3] * 8 + sbits[4] * 16
        nz = is_real * (1 - z)
        b.when(nz).assert_eq(a.lo, s)
        ib = [col(f"ib{i}") for i in range(4)]
        b.when(is_real).assert_eq(inw.lo, ib[0] + ib[1] * 256)
        b.when(is_real).assert_eq(inw.hi, ib[2] + ib[3] * 256)
        send_u8_pair(b, ib[0], ib[1], is_real)
        send_u8_pair(b, ib[2], ib[3], is_real)
        out, wrap = self.gadget.constrain(b, col, ib, sbits, nz)
        b.when(nz).assert_zero(wrap)
        top = col("top")
        b.when(nz).assert_eq(top, out[3])
        # top byte in [128, 256): (top - 128) * 2 is a u8 when shifted in range
        send_u8_pair(b, (top - 128) * 2, 0, nz)

    def fill_op(self, t, i, e, op, sink: ByteSink):
        s = self.schema
        bb = int(e.b)
        inv = ((~bb) & 0xFFFFFFFF) if op == O.CLO else bb
        t[i, s.idx("in_lo")] = inv & 0xFFFF
        t[i, s.idx("in_hi")] = inv >> 16
        if inv == 0:
            t[i, s.idx("z")] = 1
        else:
            t[i, s.idx("zinv")] = ff.inv_int(((inv & 0xFFFF) + (inv >> 16)) % ff.P)
        for j in range(4):
            t[i, s.idx(f"ib{j}")] = (inv >> (8 * j)) & 0xFF
        sink.u8pair(np.array([inv & 0xFF], dtype=np.uint32), np.array([(inv >> 8) & 0xFF], dtype=np.uint32))
        sink.u8pair(np.array([(inv >> 16) & 0xFF], dtype=np.uint32), np.array([(inv >> 24) & 0xFF], dtype=np.uint32))
        if inv != 0:
            sh = int(e.a)
            for j in range(5):
                t[i, s.idx(f"s{j}")] = (sh >> j) & 1
            self.gadget.fill(t, s, i, inv, sh, sink)
            v = (inv << sh) & 0xFFFFFFFF
            top = v >> 24
            t[i, s.idx("top")] = top
            sink.u8pair(np.array([(top - 128) * 2], dtype=np.uint32), np.array([0], dtype=np.uint32))
