"""Guest-side tooling: MIPS instruction encoder + ELF writer.

The reference ships the guest half of the zkVM as Rust/Go crates
(crates/zkvm/entrypoint, go-runtime/) plus build tooling (cargo-ziren).
This package is the port's analog for a Python-first stack:

* ``encode_instruction`` -- the exact inverse of the executor's MIPS word
  decoder (executor/instruction.py) for the instructions ``executor.asm`` makes:
  programs written with ``executor.asm`` encode to real MIPS32r2 words that
  decode back to semantically identical instructions;
* ``write_elf`` -- emits a loadable ELF32 mipsel ET_EXEC image (the inverse
  of Program.from_elf), so asm guests become on-disk ELF fixtures exercising
  the same loader path as compiled guests;
* ``corpus`` -- the fixture guests (sha2, keccak, secp256k1, uint256, io
  hints + commit, a paged-memory sweep).

The C guest runtime for cross-compiled guests (zkm.h syscall stubs, crt0.S,
zkm.ld) is source for a mipsel toolchain, not Python, and is not copied.
"""

from __future__ import annotations

import struct

from ..executor.instruction import Instruction, sign_extend
from ..executor.opcodes import Opcode

O = Opcode
MASK32 = 0xFFFFFFFF


class EncodeError(Exception):
    pass


def _s16(v: int) -> int:
    """32-bit (possibly sign-extended) value -> 16-bit immediate field."""
    v &= MASK32
    if sign_extend(v & 0xFFFF, 16) != v:
        raise EncodeError(f"immediate {v:#x} does not fit in a sign-extended s16")
    return v & 0xFFFF


def _u16(v: int) -> int:
    if v & MASK32 > 0xFFFF:
        raise EncodeError(f"immediate {v:#x} does not fit in u16")
    return v & 0xFFFF


def _r(op, rs, rt, rd, sa, func):
    return (op << 26) | (rs << 21) | (rt << 16) | (rd << 11) | (sa << 6) | func


def _i(op, rs, rt, imm):
    return (op << 26) | (rs << 21) | (rt << 16) | (imm & 0xFFFF)


_ALU_FUNC = {
    O.SLT: 0b101010, O.SLTU: 0b101011, O.AND: 0b100100, O.OR: 0b100101,
    O.XOR: 0b100110, O.NOR: 0b100111,
}
_ALU_IMM = {O.SLT: 0b001010, O.SLTU: 0b001011}
_ALU_IMM_ZEXT = {O.AND: 0b001100, O.OR: 0b001101, O.XOR: 0b001110}
_MEM_OPS = {
    O.LB: 0b100000, O.LH: 0b100001, O.LWL: 0b100010, O.LW: 0b100011,
    O.LBU: 0b100100, O.LHU: 0b100101, O.LWR: 0b100110, O.LL: 0b110000,
    O.SB: 0b101000, O.SH: 0b101001, O.SWL: 0b101010, O.SW: 0b101011,
    O.SWR: 0b101110, O.SC: 0b111000,
}
_SHIFT_FUNC = {O.SLL: 0b000000, O.SRL: 0b000010, O.SRA: 0b000011}
_SHIFT_V = {O.SLL: 0b000100, O.SRL: 0b000110, O.SRA: 0b000111}


def encode_instruction(ins: Instruction) -> int:
    """Instruction -> real MIPS32r2 word; decode(encode(i)) executes
    identically to i (and is structurally equal except where the program
    used an immediate-zero operand for the $zero register)."""
    op, a, b, c = ins.opcode, ins.op_a, ins.op_b & MASK32, ins.op_c & MASK32
    ib, ic = ins.imm_b, ins.imm_c

    if op == O.SYSCALL:
        return 0x0000000C
    if op == O.ADD and ib and ic:
        if (a, b, c) == (0, 0, 0):
            return _r(0, 0, 0, 0, 0, 0b001111)  # SYNC (canonical nop)
        # ADD rd, imm0, imm == ADDIU rd, $zero, imm (register 0 reads 0)
        if b != 0:
            raise EncodeError("ADD with nonzero immediate b operand")
        return _i(0b001001, 0, a, _s16(c))
    if op in (O.ADD, O.SUB) and not ib and not ic:
        func = 0b100001 if op == O.ADD else 0b100011
        return _r(0, b, c, a, 0, func)
    if op == O.ADD and not ib and ic:
        return _i(0b001001, b, a, _s16(c))  # ADDIU
    if op == O.SLL and ib and ic and c == 16:
        return _i(0b001111, 0, a, _u16(b))  # LUI
    if op in _SHIFT_FUNC or op == O.ROR:
        if ic:  # shift-by-sa
            sa = c & 0x1F
            if op == O.ROR:
                return _r(0, 1, b, a, sa, 0b000010)
            return _r(0, 0, b, a, sa, _SHIFT_FUNC[op])
        if op == O.ROR:
            return _r(0, c, b, a, 1, 0b000110)
        return _r(0, c, b, a, 0, _SHIFT_V[op])
    if op in _ALU_FUNC and not ic:
        return _r(0, b, c, a, 0, _ALU_FUNC[op])
    if op in _ALU_IMM and ic:
        return _i(_ALU_IMM[op], b, a, _s16(c))
    if op in _ALU_IMM_ZEXT and ic:
        return _i(_ALU_IMM_ZEXT[op], b, a, _u16(c))
    if op == O.NOR and ic:
        raise EncodeError("NOR has no immediate form")
    if op == O.MUL:
        return _r(0b011100, c, b, a, 0, 0b000010)  # SPECIAL2 MUL (rs=c, rt=b)
    if op in (O.MULT, O.MULTU) and a == 32:
        func = 0b011000 if op == O.MULT else 0b011001
        return _r(0, c, b, 0, 0, func)
    if op in (O.DIV, O.DIVU) and a == 32:
        func = 0b011010 if op == O.DIV else 0b011011
        return _r(0, b, c, 0, 0, func)
    if op in (O.MOD, O.MODU):
        func = 0b011010 if op == O.MOD else 0b011011
        return _r(0, b, c, a, 3, func)
    if op in (O.CLZ, O.CLO):
        func = 0b100000 if op == O.CLZ else 0b100001
        return _r(0b011100, b, 0, a, 0, func)
    if op == O.TEQ:
        return _r(0, a, b, 0, 0, 0b110100)
    if op in _MEM_OPS:
        return _i(_MEM_OPS[op], b, a, _s16(c))
    if op in (O.BEQ, O.BNE):
        imm = _s16(((c if c < 0x80000000 else c - (1 << 32)) >> 2) & MASK32)
        return _i(0x04 if op == O.BEQ else 0x05, a, b, imm)
    if op in (O.BLEZ, O.BGTZ):
        imm = _s16(((c if c < 0x80000000 else c - (1 << 32)) >> 2) & MASK32)
        return _i(0x06 if op == O.BLEZ else 0x07, a, 0, imm)
    if op in (O.BGEZ, O.BLTZ):
        imm = _s16(((c if c < 0x80000000 else c - (1 << 32)) >> 2) & MASK32)
        return _i(0x01, a, 1 if op == O.BGEZ else 0, imm)
    if op == O.Jumpi:
        target = ((b if b < 0x80000000 else b - (1 << 32)) >> 2) & 0x3FFFFFF
        return (0x03 if a == 31 else 0x02) << 26 | target
    if op == O.JumpDirect and a == 31:
        imm = _s16(((b if b < 0x80000000 else b - (1 << 32)) >> 2) & MASK32)
        return _i(0x01, 0, 0x11, imm)  # BAL
    if op == O.Jump:
        if a == 0:
            return _r(0, b, 0, 0, 0, 0b001000)  # JR
        return _r(0, b, 0, a, 0, 0b001001)  # JALR
    raise EncodeError(f"no encoding for {ins!r}")


# ---------------------------------------------------------------------------
# ELF writer (inverse of Program.from_elf, executor/program.py)
# ---------------------------------------------------------------------------


def write_elf(program) -> bytes:
    """Program -> loadable ELF32 mipsel ET_EXEC bytes.

    One R|X PT_LOAD carries the encoded code words at pc_base; contiguous
    data-image ranges (addresses >= 0x1000 outside the code range) become
    R|W PT_LOADs.  Register/stack image slots are regenerated by the loader
    (program.py _patch_stack) and are not emitted."""
    code = [encode_instruction(i) for i in program.instructions]
    code_lo = program.pc_base
    code_hi = code_lo + 4 * len(code)

    # gather contiguous data ranges
    data_addrs = sorted(
        a for a in (program.image or {})
        if a >= 0x1000 and not (code_lo <= a < code_hi)
    )
    ranges = []
    for a in data_addrs:
        if ranges and a == ranges[-1][1]:
            ranges[-1][1] = a + 4
        else:
            ranges.append([a, a + 4])

    segs = [(code_lo, b"".join(struct.pack("<I", w) for w in code), 5)]  # R|X
    for lo, hi in ranges:
        data = b"".join(
            struct.pack("<I", program.image.get(addr, 0)) for addr in range(lo, hi, 4)
        )
        segs.append((lo, data, 6))  # R|W

    ehsize, phentsize = 52, 32
    e_phoff = ehsize
    off = ehsize + phentsize * len(segs)
    off = (off + 3) & ~3
    phdrs, blobs = b"", b""
    for vaddr, data, flags in segs:
        phdrs += struct.pack(
            "<IIIIIIII", 1, off + len(blobs), vaddr, vaddr,
            len(data), len(data), flags, 4,
        )
        blobs += data

    ehdr = struct.pack(
        "<4sBBBBB7xHHIIIIIHHHHHH",
        b"\x7fELF", 1, 1, 1, 0, 0,  # 32-bit LE, current version
        2, 8, 1,  # ET_EXEC, EM_MIPS, EV_CURRENT
        program.pc_start, e_phoff, 0, 0,
        ehsize, phentsize, len(segs), 0, 0, 0,
    )
    return ehdr + phdrs + blobs


def roundtrip(program):
    """write_elf -> Program.from_elf (handy for fixture generation/tests)."""
    from ..executor.program import Program

    return Program.from_elf(write_elf(program))
