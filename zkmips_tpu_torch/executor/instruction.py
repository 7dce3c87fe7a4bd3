"""MIPS32r2 instruction model + word decoder.

Faithful to the reference decoder (crates/core/executor/src/
instruction.rs:312-593): MIPS words are decoded into a normalized 3-operand
form (op_a destination/source-1, op_b, op_c with imm flags); pseudo-ops like
MFHI/MFLO become ADDs against the LO/HI register indices 32/33; LUI becomes
SLL with a 16 shift; branches carry the sign-extended, <<2 offset in op_c.
"""

from __future__ import annotations

from dataclasses import dataclass

from .opcodes import Opcode

MASK32 = 0xFFFFFFFF


def sign_extend(value: int, bits: int) -> int:
    """Sign-extend the low ``bits`` of value to u32."""
    value &= (1 << bits) - 1
    if value & (1 << (bits - 1)):
        value |= MASK32 ^ ((1 << bits) - 1)
    return value & MASK32


@dataclass(frozen=True)
class Instruction:
    opcode: Opcode
    op_a: int = 0
    op_b: int = 0
    op_c: int = 0
    imm_b: bool = False
    imm_c: bool = False
    raw: int | None = None

    def __repr__(self):
        b = f"{self.op_b}" if self.imm_b else f"r{self.op_b}"
        c = f"{self.op_c}" if self.imm_c else f"r{self.op_c}"
        return f"{self.opcode.name} r{self.op_a}, {b}, {c}"


def I(opcode, op_a, op_b, op_c, imm_b, imm_c, raw=None):  # noqa: E743
    return Instruction(opcode, op_a, op_b & MASK32, op_c & MASK32, imm_b, imm_c, raw)


def decode_instruction(insn: int) -> Instruction:
    op = (insn >> 26) & 0x3F
    func = insn & 0x3F
    rt = (insn >> 16) & 0x1F
    rs = (insn >> 21) & 0x1F
    rd = (insn >> 11) & 0x1F
    sa = (insn >> 6) & 0x1F
    offset = insn & 0xFFFF
    off16 = sign_extend(offset, 16)
    target = insn & 0x3FFFFFF
    target_ext = sign_extend(target, 26)
    O = Opcode

    if op == 0b000000:
        SPECIAL = {
            0b001010: lambda: I(O.MEQ, rd, rs, rt, False, False),  # MOVZ
            0b001011: lambda: I(O.MNE, rd, rs, rt, False, False),  # MOVN
            0b100000: lambda: I(O.ADD, rd, rs, rt, False, False),
            0b100001: lambda: I(O.ADD, rd, rs, rt, False, False),  # ADDU
            0b100010: lambda: I(O.SUB, rd, rs, rt, False, False),
            0b100011: lambda: I(O.SUB, rd, rs, rt, False, False),  # SUBU
            0b000000: lambda: I(O.SLL, rd, rt, sa, False, True),
            0b000010: lambda: I(O.ROR if rs == 1 else O.SRL, rd, rt, sa, False, True),
            0b000011: lambda: I(O.SRA, rd, rt, sa, False, True),
            0b000100: lambda: I(O.SLL, rd, rt, rs, False, False),  # SLLV
            0b000110: lambda: I(O.ROR if sa == 1 else O.SRL, rd, rt, rs, False, False),  # SRLV
            0b000111: lambda: I(O.SRA, rd, rt, rs, False, False),  # SRAV
            0b011000: lambda: I(O.MULT, 32, rt, rs, False, False),
            0b011001: lambda: I(O.MULTU, 32, rt, rs, False, False),
            0b011010: lambda: I(O.MOD, rd, rs, rt, False, False) if sa == 3 else I(O.DIV, 32, rs, rt, False, False),
            0b011011: lambda: I(O.MODU, rd, rs, rt, False, False) if sa == 3 else I(O.DIVU, 32, rs, rt, False, False),
            0b010000: lambda: I(O.ADD, rd, 33, 0, False, True),  # MFHI
            0b010001: lambda: I(O.ADD, 33, rs, 0, False, True),  # MTHI
            0b010010: lambda: I(O.ADD, rd, 32, 0, False, True),  # MFLO
            0b010011: lambda: I(O.ADD, 32, rs, 0, False, True),  # MTLO
            0b001111: lambda: I(O.ADD, 0, 0, 0, True, True),  # SYNC
            0b001000: lambda: I(O.Jump, 0, rs, 0, False, True),  # JR
            0b001001: lambda: I(O.Jump, rd, rs, 0, False, True),  # JALR
            0b101010: lambda: I(O.SLT, rd, rs, rt, False, False),
            0b101011: lambda: I(O.SLTU, rd, rs, rt, False, False),
            0b100100: lambda: I(O.AND, rd, rs, rt, False, False),
            0b100101: lambda: I(O.OR, rd, rs, rt, False, False),
            0b100110: lambda: I(O.XOR, rd, rs, rt, False, False),
            0b100111: lambda: I(O.NOR, rd, rs, rt, False, False),
            0b001100: lambda: I(O.SYSCALL, 2, 4, 5, False, False),
            0b110100: lambda: I(O.TEQ, rs, rt, 0, False, True),
        }
        fn = SPECIAL.get(func)
        return fn() if fn else I(O.UNIMPL, 0, 0, insn, True, True, insn)
    if op == 0b011100:  # SPECIAL2
        SPECIAL2 = {
            0b000010: lambda: I(O.MUL, rd, rt, rs, False, False),
            0b100000: lambda: I(O.CLZ, rd, rs, 0, False, True),
            0b100001: lambda: I(O.CLO, rd, rs, 0, False, True),
            0b000001: lambda: I(O.MADDU, 32, rt, rs, False, False),
            0b000101: lambda: I(O.MSUBU, 32, rt, rs, False, False),
            0b000000: lambda: I(O.MADD, 32, rt, rs, False, False),
            0b000100: lambda: I(O.MSUB, 32, rt, rs, False, False),
        }
        fn = SPECIAL2.get(func)
        return fn() if fn else I(O.UNIMPL, 0, 0, insn, True, True, insn)
    if op == 0b011111:  # SPECIAL3
        if func == 0b100000:
            if sa == 0b010000:
                return I(O.SEXT, rd, rt, 0, False, True)  # SEB
            if sa == 0b011000:
                return I(O.SEXT, rd, rt, 1, False, True)  # SEH
            if sa == 0b000010:
                return I(O.WSBH, rd, rt, 0, False, True)
            return I(O.UNIMPL, 0, 0, insn, True, True, insn)
        if func == 0b000000:
            return I(O.EXT, rt, rs, (rd << 5) | sa, False, True)
        if func == 0b000100:
            return I(O.INS, rt, rs, (rd << 5) | sa, False, True)
        return I(O.UNIMPL, 0, 0, insn, True, True, insn)
    if op == 0x01:  # REGIMM
        if rt == 1:
            return I(O.BGEZ, rs, 0, (off16 << 2) & MASK32, True, True)
        if rt == 0:
            return I(O.BLTZ, rs, 0, (off16 << 2) & MASK32, True, True)
        if rt == 0x11 and rs == 0:
            return I(O.JumpDirect, 31, (off16 << 2) & MASK32, 0, True, True)  # BAL
        if rt == 0x1F:
            return I(O.ADD, 0, 0, 0, True, True)  # SYNCI
        return I(O.UNIMPL, 0, 0, insn, True, True, insn)

    OPCODES = {
        0x02: lambda: I(O.Jumpi, 0, (target_ext << 2) & MASK32, 0, True, True),  # J
        0x03: lambda: I(O.Jumpi, 31, (target_ext << 2) & MASK32, 0, True, True),  # JAL
        0x04: lambda: I(O.BEQ, rs, rt, (off16 << 2) & MASK32, False, True),
        0x05: lambda: I(O.BNE, rs, rt, (off16 << 2) & MASK32, False, True),
        0x06: lambda: I(O.BLEZ, rs, 0, (off16 << 2) & MASK32, True, True),
        0x07: lambda: I(O.BGTZ, rs, 0, (off16 << 2) & MASK32, True, True),
        0b100000: lambda: I(O.LB, rt, rs, off16, False, True),
        0b100001: lambda: I(O.LH, rt, rs, off16, False, True),
        0b100010: lambda: I(O.LWL, rt, rs, off16, False, True),
        0b100011: lambda: I(O.LW, rt, rs, off16, False, True),
        0b100100: lambda: I(O.LBU, rt, rs, off16, False, True),
        0b100101: lambda: I(O.LHU, rt, rs, off16, False, True),
        0b100110: lambda: I(O.LWR, rt, rs, off16, False, True),
        0b110000: lambda: I(O.LL, rt, rs, off16, False, True),
        0b101000: lambda: I(O.SB, rt, rs, off16, False, True),
        0b101001: lambda: I(O.SH, rt, rs, off16, False, True),
        0b101010: lambda: I(O.SWL, rt, rs, off16, False, True),
        0b101011: lambda: I(O.SW, rt, rs, off16, False, True),
        0b101110: lambda: I(O.SWR, rt, rs, off16, False, True),
        0b111000: lambda: I(O.SC, rt, rs, off16, False, True),
        0b001000: lambda: I(O.ADD, rt, rs, off16, False, True),  # ADDI
        0b001001: lambda: I(O.ADD, rt, rs, off16, False, True),  # ADDIU
        0b001010: lambda: I(O.SLT, rt, rs, off16, False, True),  # SLTI
        0b001011: lambda: I(O.SLTU, rt, rs, off16, False, True),  # SLTIU
        0b001111: lambda: I(O.SLL, rt, off16, 16, True, True),  # LUI
        0b001100: lambda: I(O.AND, rt, rs, offset, False, True),  # ANDI
        0b001101: lambda: I(O.OR, rt, rs, offset, False, True),  # ORI
        0b001110: lambda: I(O.XOR, rt, rs, offset, False, True),  # XORI
        0b110011: lambda: I(O.ADD, 0, 0, 0, True, True),  # PREF
    }
    fn = OPCODES.get(op)
    return fn() if fn else I(O.UNIMPL, 0, 0, insn, True, True, insn)
