"""Small helpers that assemble instructions for tests and fixture programs.

The reference's executor tests construct ``Instruction::new`` lists directly
(crates/core/executor/src/executor.rs tests); these helpers mirror that,
plus encoders to raw MIPS words so the decoder is exercised too.
"""

from __future__ import annotations

from .instruction import Instruction
from .opcodes import Opcode, Register
from .program import Program

O = Opcode


def prog(instructions, pc_start: int = 0x1000, image: dict | None = None) -> Program:
    return Program(list(instructions), pc_start, pc_start, image)


def alu(op: Opcode, rd: int, rb, rc, imm_b=False, imm_c=False) -> Instruction:
    return Instruction(op, rd, rb & 0xFFFFFFFF, rc & 0xFFFFFFFF, imm_b, imm_c)


def addi(rd: int, rs: int, imm: int) -> Instruction:
    return Instruction(O.ADD, rd, rs, imm & 0xFFFFFFFF, False, True)


def li(rd: int, value: int) -> list:
    """Load a 32-bit immediate: LUI + ORI (2 instructions)."""
    hi = (value >> 16) & 0xFFFF
    lo = value & 0xFFFF
    return [
        Instruction(O.SLL, rd, hi, 16, True, True),
        Instruction(O.OR, rd, rd, lo, False, True),
    ]


def lw(rt: int, rs: int, offset: int = 0) -> Instruction:
    return Instruction(O.LW, rt, rs, offset & 0xFFFFFFFF, False, True)


def sw(rt: int, rs: int, offset: int = 0) -> Instruction:
    return Instruction(O.SW, rt, rs, offset & 0xFFFFFFFF, False, True)


def mem_op(op: Opcode, rt: int, rs: int, offset: int = 0) -> Instruction:
    return Instruction(op, rt, rs, offset & 0xFFFFFFFF, False, True)


def branch(op: Opcode, ra: int, rb: int, byte_offset: int) -> Instruction:
    one_operand = op in (O.BGEZ, O.BLEZ, O.BGTZ, O.BLTZ)
    return Instruction(op, ra, 0 if one_operand else rb, byte_offset & 0xFFFFFFFF, one_operand, True)


def nop() -> Instruction:
    return Instruction(O.ADD, 0, 0, 0, True, True)


def syscall() -> Instruction:
    return Instruction(O.SYSCALL, 2, 4, 5, False, False)


def halt_sequence(exit_code: int = 0) -> list:
    """li v0, HALT; li a0, exit_code; syscall."""
    return [
        Instruction(O.ADD, Register.V0, 0, 0, True, True),  # v0 = 0 (HALT)
        Instruction(O.ADD, Register.A0, 0, exit_code, True, True),
        syscall(),
        nop(),  # fetched as HALT's "delay"? (never executed: next_pc = 0)
    ]
