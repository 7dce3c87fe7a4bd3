"""Lookup message schemas shared by all MIPS chips.

Every chip pair that communicates agrees on one of these value layouts; the
schemas here are this implementation's protocol (same *kinds* as the
reference, crates/stark/src/lookup/lookup.rs:25-57, with our own field
layouts adapted to 16-bit limb words).

  Program     [pc, opcode, op_a, b_lo, b_hi, c_lo, c_hi, imm_b, imm_c]
  Instruction [opcode, shard, clk, pc, next_pc, next_next_pc,
               a_lo, a_hi, b_lo, b_hi, c_lo, c_hi, pa_lo, pa_hi,
               num_extra, is_write_hi, is_pa_prev_a, is_halt, is_sequential,
               op_a_immutable]
  Memory      [shard, clk, addr, v_lo, v_hi]
  Byte        [byte_opcode, a, b, c]
  Syscall     [shard, clk, syscall_id, arg1, arg2]
  Global      [m0..m6, is_send, is_receive, kind]

The CPU sends one Instruction message per cycle; opcode-specific chips
receive it.  Chips that need helper ALU operations (branch comparisons,
memory address arithmetic) send *nested* Instruction messages with zeroed
control fields (NESTED_* helpers), received by the ALU chips exactly like
CPU-originated ones.
"""

from __future__ import annotations

from enum import IntEnum

from ..stark.air import LookupKind


class ByteOpcode(IntEnum):
    AND = 0
    OR = 1
    XOR = 2
    U16Range = 3
    U8Pair = 4
    MSB = 5
    LTU = 6
    NOR = 7
    POW2 = 8


INSTR_MSG_LEN = 24


def instr_msg(
    opcode,
    shard,
    clk,
    pc,
    next_pc,
    next_next_pc,
    a,
    b,
    c,
    pa,
    hi_w,
    hp,
    num_extra,
    is_write_hi,
    is_pa_prev_a,
    is_halt,
    is_sequential,
    op_a_immutable,
):
    """a/b/c/pa/hi_w are WordExpr (or (lo, hi) pairs)."""
    return [
        opcode, shard, clk, pc, next_pc, next_next_pc,
        *_limbs(a), *_limbs(b), *_limbs(c), *_limbs(pa), *_limbs(hi_w), *_limbs(hp),
        num_extra, is_write_hi, is_pa_prev_a, is_halt, is_sequential, op_a_immutable,
    ]


def nested_alu_msg(opcode, a, b, c, pa=(0, 0), hi_w=(0, 0), is_write_hi=0):
    """Helper-ALU request: zero control fields, sequential=1 (see module doc)."""
    z = 0
    return instr_msg(opcode, z, z, z, z, z, a, b, c, pa, hi_w, (z, z), z, is_write_hi, z, z, 1, z)


def _limbs(w):
    if hasattr(w, "lo"):
        return [w.lo, w.hi]
    lo, hi = w
    return [lo, hi]


def program_msg(pc, opcode, op_a, b, c, imm_b, imm_c):
    return [pc, opcode, op_a, *_limbs(b), *_limbs(c), imm_b, imm_c]


def memory_msg(shard, clk, addr, v):
    return [shard, clk, addr, *_limbs(v)]


def byte_msg(op, a, b, c):
    return [op, a, b, c]


def syscall_msg(shard, clk, id_lo, id_hi, arg1, arg2):
    """arg1/arg2 are WordExpr or (lo, hi) pairs."""
    return [shard, clk, id_lo, id_hi, *_limbs(arg1), *_limbs(arg2)]


def linux_syscall_msg(shard, clk, id_lo, id_hi, a0, a1, res):
    """Linux-o32 syscall bridge (SyscallInstrs -> SysLinux chip): the plain
    syscall fields plus the result word, binding the value the CPU wrote to
    $v0 to the SysLinux chip's per-syscall result constraints.  Linux ids
    (4000-4338) are disjoint from precompile ids, so the two Syscall-kind
    layouts can never be claimed by the wrong receiver."""
    return [shard, clk, id_lo, id_hi, *_limbs(a0), *_limbs(a1), *_limbs(res)]


def global_msg(m, is_send, is_receive, kind):
    assert len(m) == 7
    return [*m, is_send, is_receive, kind]


KIND = LookupKind
