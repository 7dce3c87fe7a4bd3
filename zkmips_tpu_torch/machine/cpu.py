"""CPU chip: one row per cycle — fetch, operands, clk/pc chaining, register
file accesses.  Opcode semantics live in the per-class instruction chips,
reached through the Instruction dispatch lookup.

Modeled on the reference CPU chip (crates/core/machine/src/cpu/): program
fetch send, register access gadgets with (shard, clk) ordering, clk limbs
range-checked to 24 bits, pc chaining against public values, is_real
monotonicity.  Layout differences (16-bit limb words, always-sent shard/clk,
written-HI word in the dispatch message) are this implementation's protocol
(see machine/lookups.py).
"""

from __future__ import annotations

import numpy as np

from ..utils.pool import zeros_mt

from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from ..executor.opcodes import POS_A, POS_B, POS_C, POS_HI, Opcode, Register, SyscallCode
from .gadgets import ByteSink, ColView, Schema, eval_memory_access, populate_access, send_u16_check, send_u8_pair
from .lookups import instr_msg, program_msg
from .pv import PV_EXIT_CODE, PV_NEXT_PC, PV_SHARD, PV_START_PC
from .words import WordExpr, split_u32

WRITES_HI = {
    Opcode.MULT, Opcode.MULTU, Opcode.DIV, Opcode.DIVU,
    Opcode.MADD, Opcode.MADDU, Opcode.MSUB, Opcode.MSUBU,
}
PA_IS_PREV_A = set()  # filled below
from ..executor.opcodes import LOAD_OPS, STORE_OPS, BRANCH_OPS, MOVCOND_OPS

PA_IS_PREV_A = LOAD_OPS | STORE_OPS | MOVCOND_OPS | {Opcode.INS, Opcode.SYSCALL, Opcode.MADD, Opcode.MADDU, Opcode.MSUB, Opcode.MSUBU}
IMMUTABLE_A = BRANCH_OPS | {Opcode.TEQ} | (STORE_OPS - {Opcode.SC})
NON_SEQUENTIAL = BRANCH_OPS | {Opcode.Jump, Opcode.Jumpi, Opcode.JumpDirect}


def _schema() -> Schema:
    names = [
        "shard", "clk16", "clk8", "pc", "next_pc", "next_next_pc",
        "i_opcode", "i_op_a", "i_b_lo", "i_b_hi", "i_c_lo", "i_c_hi", "i_imm_b", "i_imm_c",
        "a_lo", "a_hi", "b_lo", "b_hi", "c_lo", "c_hi",
        "pa_lo", "pa_hi", "hiw_lo", "hiw_hi", "aw_lo", "aw_hi",
        "a_eq_zero", "a_eq_zero_inv",
        "num_extra", "is_write_hi", "is_pa_prev_a", "is_halt", "is_sequential",
        "op_a_immutable", "is_real",
    ]
    s = Schema(names)
    for p in ("aacc", "bacc", "cacc", "hacc"):
        s.names.extend(s.access_cols(p))
    return Schema(s.names)


SCHEMA = _schema()


class CpuAir(BaseAir):
    name = "Cpu"
    main_width = SCHEMA.width

    def included(self, record) -> bool:
        # deferred precompile shards carry no CPU rows; the chip's first-row
        # is_real constraint forbids an all-padding trace (reference
        # cpu/mod.rs included: !shard.cpu_events.is_empty())
        return bool(record.cpu_events)

    def eval(self, b: AirBuilder):
        col = ColView(b, SCHEMA)
        is_real = col("is_real")
        shard = col("shard")
        clk = col("clk16") + col("clk8") * 65536
        pc, next_pc, nnpc = col("pc"), col("next_pc"), col("next_next_pc")
        a = col.word("a")
        bw = col.word("b")
        cw = col.word("c")
        pa = col.word("pa")
        hiw = col.word("hiw")
        aw = col.word("aw")
        imm_b, imm_c = col("i_imm_b"), col("i_imm_c")
        is_halt = col("is_halt")

        # --- is_real structure --------------------------------------------
        b.assert_bool(is_real)
        b.when_first_row().assert_one(is_real)
        b.when_transition().when_not(is_real).assert_zero(col("is_real", 1))
        b.when_transition().when(is_halt).assert_zero(col("is_real", 1))

        # --- clk / shard ---------------------------------------------------
        b.when_first_row().assert_zero(clk)
        next_clk = col("clk16", 1) + col("clk8", 1) * 65536
        t = b.when_transition().when(col("is_real", 1))
        t.assert_eq(next_clk, clk + 5 + col("num_extra"))
        t.assert_eq(col("shard", 1), shard)
        send_u16_check(b, col("clk16"), is_real)
        send_u8_pair(b, col("clk8"), 0, is_real)
        send_u16_check(b, shard, is_real)
        b.when(is_real).assert_eq(b.public_value(PV_SHARD), shard)

        # --- pc chaining ---------------------------------------------------
        b.when_first_row().assert_eq(b.public_value(PV_START_PC), pc)
        b.when_first_row().when_not(is_halt).assert_eq(next_pc, pc + 4)
        t = b.when_transition().when(col("is_real", 1))
        t.assert_eq(next_pc, col("pc", 1))
        t.when_not(col("is_halt", 1)).assert_eq(nnpc, col("next_pc", 1))
        b.when(is_real).when(col("is_sequential")).assert_eq(nnpc, next_pc + 4)
        b.when_transition().when(is_real - col("is_real", 1)).assert_eq(
            b.public_value(PV_NEXT_PC), next_pc
        )
        b.when_last_row().when(is_real).assert_eq(b.public_value(PV_NEXT_PC), next_pc)

        # --- program fetch -------------------------------------------------
        b.send(
            LookupKind.Program,
            program_msg(pc, col("i_opcode"), col("i_op_a"), col.word("i_b"), col.word("i_c"), imm_b, imm_c),
            is_real,
        )

        # --- operand b/c ---------------------------------------------------
        b.when(is_real).when(imm_b).assert_eq(bw.lo, col("i_b_lo"))
        b.when(is_real).when(imm_b).assert_eq(bw.hi, col("i_b_hi"))
        mult_b = is_real * (1 - imm_b)
        eval_memory_access(b, col, "bacc", shard, clk + POS_B, col("i_b_lo"), bw, mult_b)
        b.when(mult_b).assert_eq(bw.lo, col("bacc_prev_lo"))
        b.when(mult_b).assert_eq(bw.hi, col("bacc_prev_hi"))

        b.when(is_real).when(imm_c).assert_eq(cw.lo, col("i_c_lo"))
        b.when(is_real).when(imm_c).assert_eq(cw.hi, col("i_c_hi"))
        mult_c = is_real * (1 - imm_c)
        eval_memory_access(b, col, "cacc", shard, clk + POS_C, col("i_c_lo"), cw, mult_c)
        b.when(mult_c).assert_eq(cw.lo, col("cacc_prev_lo"))
        b.when(mult_c).assert_eq(cw.hi, col("cacc_prev_hi"))

        # --- operand a (read-modify-write every real row) ------------------
        az, azi = col("a_eq_zero"), col("a_eq_zero_inv")
        b.assert_bool(az)
        b.assert_zero(az * col("i_op_a"))
        b.when(is_real).assert_zero(az + col("i_op_a") * azi - 1)
        # written value: 0 if writing to $zero, else the op_a value
        b.assert_eq(aw.lo, a.lo * (1 - az))
        b.assert_eq(aw.hi, a.hi * (1 - az))
        eval_memory_access(b, col, "aacc", shard, clk + POS_A, col("i_op_a"), aw, is_real)
        imm_a = col("op_a_immutable")
        b.when(is_real).when(imm_a).assert_eq(a.lo, col("aacc_prev_lo"))
        b.when(is_real).when(imm_a).assert_eq(a.hi, col("aacc_prev_hi"))
        ippa = col("is_pa_prev_a")
        b.when(is_real).when(ippa).assert_eq(pa.lo, col("aacc_prev_lo"))
        b.when(is_real).when(ippa).assert_eq(pa.hi, col("aacc_prev_hi"))

        # --- HI register write ---------------------------------------------
        mult_hi = is_real * col("is_write_hi")
        eval_memory_access(b, col, "hacc", shard, clk + POS_HI, int(Register.HI), hiw, mult_hi)

        # --- dispatch to instruction chips ---------------------------------
        b.send(
            LookupKind.Instruction,
            instr_msg(
                col("i_opcode"), shard, clk, pc, next_pc, nnpc,
                a, bw, cw, pa, hiw,
                (col("hacc_prev_lo"), col("hacc_prev_hi")), col("num_extra"),
                col("is_write_hi"), ippa, is_halt, col("is_sequential"), imm_a,
            ),
            is_real,
        )

        # halt rows expose the exit code (operand b = $a0)
        b.when(is_real).when(is_halt).assert_eq(b.public_value(PV_EXIT_CODE), bw.lo)
        b.when(is_real).when(is_halt).assert_zero(next_pc)

    # ------------------------------------------------------------- trace gen

    def generate_trace(self, record, output):
        from ..executor.columnar import cpu_struct

        events = record.cpu_events
        cs = cpu_struct(record)
        n = len(events)
        s = SCHEMA
        t = zeros_mt((n, s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        shard = record.shard

        def setw(prefix, vals_u32):
            lo, hi = split_u32(vals_u32)
            t[:, s.idx(prefix + "_lo")] = lo
            t[:, s.idx(prefix + "_hi")] = hi

        clk = cs["clk"]
        t[:, s.idx("shard")] = shard
        t[:, s.idx("clk16")] = clk & 0xFFFF
        t[:, s.idx("clk8")] = clk >> 16
        t[:, s.idx("pc")] = cs["pc"]
        t[:, s.idx("next_pc")] = cs["next_pc"]
        t[:, s.idx("next_next_pc")] = cs["nnpc"]
        opcodes = cs["opcode"].astype(np.int64)
        t[:, s.idx("i_opcode")] = opcodes
        op_a = cs["op_a"]
        t[:, s.idx("i_op_a")] = op_a
        setw("i_b", cs["op_b"])
        setw("i_c", cs["op_c"])
        imm_b = cs["imm_b"]
        imm_c = cs["imm_c"]
        t[:, s.idx("i_imm_b")] = imm_b
        t[:, s.idx("i_imm_c")] = imm_c
        a_vals = cs["a"]
        setw("a", a_vals)
        setw("b", cs["b"])
        setw("c", cs["c"])
        pa = cs["pa"]
        setw("pa", pa)
        hiw = cs["hiw"]
        setw("hiw", hiw)
        az = (op_a == 0).astype(np.uint32)
        t[:, s.idx("a_eq_zero")] = az
        inv = _field_inv_nonzero(op_a)
        t[:, s.idx("a_eq_zero_inv")] = inv
        aw = np.where(az == 1, 0, a_vals).astype(np.uint32)
        setw("aw", aw)

        # per-opcode flag tables (vectorized via a 256-entry LUT)
        lut = _flag_lut()
        fl = lut[opcodes]
        is_syscall = opcodes == int(Opcode.SYSCALL)
        is_halt = np.zeros(n, dtype=np.uint32)
        num_extra = np.zeros(n, dtype=np.uint32)
        if is_syscall.any():
            sc = cs["syscall"]
            lut = _extra_cycles_lut()
            is_halt[is_syscall & (sc == 0)] = 1
            # Linux exit_group halts exactly like HALT (executor dispatch)
            is_halt[is_syscall & (sc == int(SyscallCode.SYS_EXT_GROUP))] = 1
            num_extra = np.where(is_syscall, lut[sc & 0xFFFF], 0).astype(np.uint32)
        t[:, s.idx("num_extra")] = num_extra
        t[:, s.idx("is_write_hi")] = fl[:, 0]
        t[:, s.idx("is_pa_prev_a")] = fl[:, 1]
        t[:, s.idx("is_halt")] = is_halt
        t[:, s.idx("is_sequential")] = fl[:, 2] & (1 - is_halt)
        t[:, s.idx("op_a_immutable")] = fl[:, 3]
        flags = np.stack([num_extra, fl[:, 0], fl[:, 1], is_halt, fl[:, 2] & (1 - is_halt), fl[:, 3]], axis=1)
        t[:, s.idx("is_real")] = 1

        sink.u16(clk & 0xFFFF)
        sink.u8pair(clk >> 16, np.zeros(n, dtype=np.uint32))
        sink.u16(np.full(n, shard, dtype=np.uint32))

        all_rows = np.arange(n)
        self._populate_acc(t, s, sink, cs, "a", "aacc", all_rows, clk + POS_A, shard)
        b_rows = np.nonzero(imm_b == 0)[0]
        self._populate_acc(t, s, sink, cs, "b", "bacc", b_rows, clk + POS_B, shard)
        c_rows = np.nonzero(imm_c == 0)[0]
        self._populate_acc(t, s, sink, cs, "c", "cacc", c_rows, clk + POS_C, shard)
        hi_rows = np.nonzero(flags[:, 1] == 1)[0]
        if len(hi_rows):
            assert cs["hi_has"][hi_rows].all(), "missing hi access record"
        self._populate_acc(t, s, sink, cs, "hi", "hacc", hi_rows, clk + POS_HI, shard)
        return t

    def _populate_acc(self, t, s, sink, cs, field, prefix, rows, ts, shard):
        if len(rows) == 0:
            return
        prev_shard = cs[f"{field}_ps"][rows]
        prev_clk = cs[f"{field}_pt"][rows]
        prev_val = cs[f"{field}_pv"][rows]
        populate_access(t, s, rows, prefix, prev_shard, prev_clk, prev_val, shard, ts[rows], sink)


_FLAG_LUT = None


def _flag_lut():
    global _FLAG_LUT
    if _FLAG_LUT is None:
        lut = np.zeros((256, 4), dtype=np.uint32)
        for op in Opcode:
            lut[int(op), 0] = int(op in WRITES_HI)
            lut[int(op), 1] = int(op in PA_IS_PREV_A)
            lut[int(op), 2] = int(op not in NON_SEQUENTIAL)
            lut[int(op), 3] = int(op in IMMUTABLE_A)
        _FLAG_LUT = lut
    return _FLAG_LUT


_EXTRA_LUT = None


def _extra_cycles_lut():
    """num_extra_cycles by low-16 syscall id (codes are unique in the low
    half; the cpu event stores only those bits)."""
    global _EXTRA_LUT
    if _EXTRA_LUT is None:
        lut = np.zeros(1 << 16, dtype=np.uint32)
        for code in SyscallCode:
            lut[code.syscall_id] = code.num_extra_cycles
        _EXTRA_LUT = lut
    return _EXTRA_LUT


def _num_extra(e) -> int:
    try:
        return SyscallCode(_syscall_full_id(e)).num_extra_cycles
    except ValueError:
        return 0


def _syscall_full_id(e) -> int:
    # syscall_code column stores the low 16 bits; recover the full code
    for code in SyscallCode:
        if code.syscall_id == e.syscall_code:
            return int(code)
    return e.syscall_code


_INV_LUT = None


def _field_inv_nonzero(x: np.ndarray) -> np.ndarray:
    """Field inverse for nonzero entries, 0 where x == 0.

    Inputs are register indices (< 64): one gather through a tiny LUT."""
    from ..ops import field as f

    global _INV_LUT
    if _INV_LUT is None:
        _INV_LUT = np.array([0] + [f.inv_int(v) for v in range(1, 64)], dtype=np.uint32)
    return _INV_LUT[x]
