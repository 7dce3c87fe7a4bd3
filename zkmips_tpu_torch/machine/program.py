"""Program chip: preprocessed instruction table + fetch multiplicities.

Analog of the reference's program chip (crates/core/machine/src/program/
mod.rs:223): the CPU sends one Program lookup per cycle; this chip receives
it with the per-pc execution count, against the preprocessed decoded-program
table.
"""

from __future__ import annotations

import numpy as np

from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .lookups import program_msg
from .words import split_u32

_PRE = ["pc", "opcode", "op_a", "b_lo", "b_hi", "c_lo", "c_hi", "imm_b", "imm_c"]


class ProgramAir(BaseAir):
    name = "Program"
    preprocessed_width = len(_PRE)
    main_width = 1

    def eval(self, b: AirBuilder):
        pre = {n: b.preprocessed(i) for i, n in enumerate(_PRE)}
        msg = program_msg(
            pre["pc"], pre["opcode"], pre["op_a"],
            (pre["b_lo"], pre["b_hi"]), (pre["c_lo"], pre["c_hi"]),
            pre["imm_b"], pre["imm_c"],
        )
        b.receive(LookupKind.Program, msg, b.main(0))

    def generate_preprocessed(self, program):
        n = len(program.instructions)
        t = np.zeros((n, len(_PRE)), dtype=np.uint32)
        for i, ins in enumerate(program.instructions):
            b_lo, b_hi = split_u32(ins.op_b)
            c_lo, c_hi = split_u32(ins.op_c)
            t[i] = (
                program.pc_base + 4 * i,
                int(ins.opcode), ins.op_a, b_lo, b_hi, c_lo, c_hi,
                int(ins.imm_b), int(ins.imm_c),
            )
        return t

    def generate_trace(self, record, output):
        program = record.program
        n = len(program.instructions)
        t = np.zeros((n, 1), dtype=np.uint32)
        if record.cpu_events:
            from ..executor.columnar import cpu_struct

            pcs = cpu_struct(record)["pc"]
            rows = (pcs - program.pc_base) >> 2
            counts = np.bincount(rows.astype(np.int64), minlength=n)
            t[:, 0] = counts[:n]
        return t
