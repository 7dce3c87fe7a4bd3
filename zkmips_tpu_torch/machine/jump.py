"""Jump chip: Jump (JR/JALR), Jumpi (J/JAL), JumpDirect (BAL).

Analog of crates/core/machine/src/control_flow/jump.rs: the link register
value is next_pc + 4 (written via the CPU's op_a access), and next_next_pc
equals the target (register value, immediate, or next_pc-relative offset
with u32 wraparound).
"""

from __future__ import annotations

import numpy as np

from ..executor.opcodes import Opcode
from ..ops import field as ff
from ..stark.air import AirBuilder
from .gadgets import ByteSink, ColView
from .instr_chip import InstrAir

O = Opcode
TWO32 = (1 << 32) % ff.P


class JumpAir(InstrAir):
    name = "Jump"
    OPCODES = [O.Jump, O.Jumpi, O.JumpDirect]
    EXTRA_COLS = ["wrap"]

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_jump, is_jumpi, is_jdirect = sels
        is_real = col("is_real")
        a, bw = col.word("a"), col.word("b")
        next_pc, nnpc = col("next_pc"), col("next_next_pc")
        # link value
        b.when(is_real).assert_eq(a.value_expr(), next_pc + 4)
        # target
        wrap = col("wrap")
        b.assert_bool(wrap)
        b.when(is_jump + is_jumpi).assert_eq(nnpc, bw.value_expr())
        b.when(is_jdirect).assert_eq(nnpc + wrap * TWO32, next_pc + bw.value_expr())

    def fill_vec(self, t, events, ops, sink: ByteSink) -> bool:
        s = self.schema
        bb = t[:, s.idx("b_lo")].astype(np.uint64) | (
            t[:, s.idx("b_hi")].astype(np.uint64) << np.uint64(16)
        )
        wrap = (ops.array == int(O.JumpDirect)) & (
            t[:, s.idx("next_pc")].astype(np.uint64) + bb >= (1 << 32)
        )
        t[:, s.idx("wrap")] = wrap
        return True
