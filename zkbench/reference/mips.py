"""A plain MIPS32 interpreter for the benchmark's guests: the reference outcome.

It reads the ELF image itself, runs it one instruction at a time with
branch delay slots, and returns what a job must produce: the cycles (one
an executed instruction, the halting syscall included), the exit code, the
public-values stream and the eight committed digest words.  It knows the
instructions and syscalls the benchmark's guests use and raises on any
other, so a guest that strays from them is refused rather than misjudged.
Precompile syscalls are modules of ``syscalls/``, each with its ``CODE``
and a plain ``run(mem, a0, a1)``, found by scanning the directory: a guest
that needs another precompile brings a file of its own.  Nothing here
imports the program under test.
"""

from __future__ import annotations

import importlib
import struct
from pathlib import Path

M32 = 0xFFFFFFFF

SYS_HALT, SYS_WRITE, SYS_COMMIT = 0x00, 0x02, 0x10
SYS_HINT_LEN, SYS_HINT_READ = 0xF0, 0xF1
FD_PUBLIC_VALUES = 3

# decoded kinds
(ADDU, OR, SLL, SYSCALL, ADDIU, ORI, LUI, LW, SW, BGTZ, BNE, BEQ,
 SUBU, AND, XOR, NOR, SLT, SLTU, SRL, SRA, SLLV, SRLV, SRAV, ANDI, XORI, SLTI, SLTIU,
 LB, LBU, LH, LHU, SB, SH, BLEZ, BLTZ, BGEZ, J, JAL, JR, JALR, MUL) = range(41)
R_TYPE = {0x21: ADDU, 0x20: ADDU, 0x23: SUBU, 0x22: SUBU, 0x24: AND, 0x25: OR, 0x26: XOR,
          0x27: NOR, 0x2A: SLT, 0x2B: SLTU, 0x04: SLLV, 0x06: SRLV, 0x07: SRAV}
I_SIGNED = {0x09: ADDIU, 0x08: ADDIU, 0x0A: SLTI, 0x0B: SLTIU}
I_ZERO = {0x0D: ORI, 0x0C: ANDI, 0x0E: XORI}
MEM = {0x23: LW, 0x2B: SW, 0x20: LB, 0x24: LBU, 0x21: LH, 0x25: LHU, 0x28: SB, 0x29: SH}
BRANCH = {0x04: BEQ, 0x05: BNE, 0x06: BLEZ, 0x07: BGTZ}


class GuestError(Exception):
    pass


def _precompiles() -> dict:
    out = {}
    for path in sorted((Path(__file__).parent / "syscalls").glob("[!_]*.py")):
        mod = importlib.import_module(f"{__package__}.syscalls.{path.stem}")
        out[mod.CODE] = mod.run
    return out


PRECOMPILES = _precompiles()


def load_elf(elf: bytes):
    """(entry, {word address: word}) of a little-endian ELF32 executable."""
    if elf[:4] != b"\x7fELF" or elf[4] != 1 or elf[5] != 1:
        raise GuestError("not a little-endian ELF32 image")
    (_t, _m, _v, entry, phoff, _sh, _fl, _eh, phentsize, phnum) = struct.unpack_from(
        "<HHIIIIIHHH", elf, 16)
    mem = {}
    for k in range(phnum):
        (ptype, off, vaddr, _pa, filesz, memsz, _flags, _al) = struct.unpack_from(
            "<IIIIIIII", elf, phoff + k * phentsize)
        if ptype != 1:
            continue
        for o in range(0, memsz, 4):
            chunk = elf[off + o:off + min(o + 4, filesz)] if o < filesz else b""
            mem[vaddr + o] = int.from_bytes(chunk.ljust(4, b"\0"), "little")
    return entry, mem


def _sx(v: int, bits: int) -> int:
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _decode(w: int):
    """(kind, a, b, c): a the register written (or tested), b and c the
    operands; shifts, immediates and branch offsets already in place."""
    op, rs, rt = w >> 26, (w >> 21) & 31, (w >> 16) & 31
    rd, sa, funct, imm = (w >> 11) & 31, (w >> 6) & 31, w & 63, w & 0xFFFF
    simm = _sx(imm, 16)
    if op == 0:
        if funct in R_TYPE:
            kind = R_TYPE[funct]
            return (kind, rd, rt, rs) if kind in (SLLV, SRLV, SRAV) else (kind, rd, rs, rt)
        if funct in (0x00, 0x03) or (funct == 0x02 and rs == 0):
            return ({0x00: SLL, 0x02: SRL, 0x03: SRA}[funct], rd, rt, sa)
        if funct == 0x0C:
            return (SYSCALL, 0, 0, 0)
        if funct == 0x08:
            return (JR, 0, rs, 0)
        if funct == 0x09:
            return (JALR, rd, rs, 0)
    elif op in I_SIGNED:
        return (I_SIGNED[op], rt, rs, simm & M32)
    elif op in I_ZERO:
        return (I_ZERO[op], rt, rs, imm)
    elif op == 0x0F:
        return (LUI, rt, 0, imm << 16)
    elif op in MEM:
        return (MEM[op], rt, rs, simm)
    elif op in BRANCH and (op < 0x06 or rt == 0):
        return (BRANCH[op], rs, rt, simm * 4)
    elif op == 0x01 and rt in (0, 1):
        return (BGEZ if rt else BLTZ, rs, 0, simm * 4)
    elif op in (0x02, 0x03):  # Ziren: the 26-bit field, sign extended, times 4
        return (JAL if op == 0x03 else J, 31 if op == 0x03 else 0, 0, (_sx(w & 0x3FFFFFF, 26) * 4) & M32)
    elif op == 0x1C and funct == 0x02:
        return (MUL, rd, rs, rt)
    raise GuestError(f"instruction {w:#010x} is outside the reference's set")


def _s32(v: int) -> int:
    return v - (1 << 32) if v & 0x80000000 else v


def run(elf: bytes, stdin=(), max_cycles: int = 1 << 32) -> dict:
    """Run the guest on its stdin buffers to its halt: {cycles, exit_code,
    public_values, digest}."""
    entry, mem = load_elf(elf)
    hints = list(stdin)
    code = {}
    regs = [0] * 32
    pv = bytearray()
    digest = [0] * 8
    pc, npc, cycles = entry, entry + 4, 0
    while True:
        ins = code.get(pc)
        if ins is None:
            if pc not in mem:
                raise GuestError(f"fetch outside the image at {pc:#x}")
            ins = code[pc] = _decode(mem[pc])
        kind, a, b, c = ins
        nnpc = npc + 4
        cycles += 1
        if kind == ADDU:
            v = (regs[b] + regs[c]) & M32
        elif kind == ADDIU:
            v = (regs[b] + c) & M32
        elif kind == BGTZ:
            if 0 < regs[a] < 0x80000000:
                nnpc = (npc + c) & M32
            v = None
        elif kind == SLL:
            v = (regs[b] << c) & M32
        elif kind == OR:
            v = regs[b] | regs[c]
        elif kind == ORI:
            v = regs[b] | c
        elif kind == LUI:
            v = c
        elif kind == LW:
            addr = (regs[b] + c) & M32
            if addr & 3:
                raise GuestError(f"unaligned load at {addr:#x}")
            v = mem.get(addr, 0)
        elif kind == SW:
            addr = (regs[b] + c) & M32
            if addr & 3:
                raise GuestError(f"unaligned store at {addr:#x}")
            mem[addr] = regs[a]
            v = None
        elif kind == BNE or kind == BEQ:
            if (regs[a] != regs[b]) == (kind == BNE):
                nnpc = (npc + c) & M32
            v = None
        elif kind != SYSCALL:
            v, nnpc = _other(kind, a, b, c, regs, mem, pc, npc, nnpc)
        else:  # SYSCALL
            sid, x, y = regs[2], regs[4], regs[5]
            if sid == SYS_HALT:
                return {"cycles": cycles, "exit_code": x, "public_values": bytes(pv),
                        "digest": digest}
            if sid == SYS_WRITE:
                n = regs[6]
                data = bytes((mem.get((y + i) & ~3, 0) >> (8 * ((y + i) & 3))) & 0xFF
                             for i in range(n))
                if x == FD_PUBLIC_VALUES:
                    pv += data
            elif sid == SYS_COMMIT:
                if x >= 8:
                    raise GuestError(f"commit word {x} out of range")
                digest[x] = y
            elif sid in PRECOMPILES:
                try:
                    PRECOMPILES[sid](mem, x, y)
                except ValueError as e:
                    raise GuestError(str(e)) from e
            elif sid == SYS_HINT_LEN:
                if not hints:
                    raise GuestError("input length asked of an empty stdin")
                regs[2] = len(hints[0])
                pc, npc = npc, nnpc
                continue
            elif sid == SYS_HINT_READ:
                _hint_read(mem, hints, x, y)
            else:
                raise GuestError(f"syscall {sid:#x} is outside the reference's set")
            a, v = 2, sid
        if v is not None and a:
            regs[a] = v
        pc, npc = npc, nnpc
        if cycles >= max_cycles:
            raise GuestError(f"no halt within {max_cycles} cycles")


def _other(kind, a, b, c, regs, mem, pc, npc, nnpc):
    """The instructions the benchmark's guests use rarely: (value, next next pc)."""
    x, y = regs[b], regs[c] if kind in R_TYPE.values() or kind == MUL else c
    if kind == SUBU:
        return (x - y) & M32, nnpc
    if kind == AND or kind == ANDI:
        return x & y, nnpc
    if kind == XOR or kind == XORI:
        return x ^ y, nnpc
    if kind == NOR:
        return ~(x | y) & M32, nnpc
    if kind == SLT or kind == SLTI:
        return int(_s32(x) < _s32(y)), nnpc
    if kind == SLTU or kind == SLTIU:
        return int(x < y), nnpc
    if kind in (SRL, SRLV):
        return x >> (y & 31), nnpc
    if kind in (SRA, SRAV):
        return (_s32(x) >> (y & 31)) & M32, nnpc
    if kind == SLLV:
        return (x << (y & 31)) & M32, nnpc
    if kind == MUL:
        return (x * y) & M32, nnpc
    if kind in (LB, LBU, LH, LHU, SB, SH):
        addr = (x + c) & M32
        size = 1 if kind in (LB, LBU, SB) else 2
        if addr % size:
            raise GuestError(f"unaligned access at {addr:#x}")
        shift, mask = 8 * (addr & 3), (1 << (8 * size)) - 1
        word = mem.get(addr & ~3, 0)
        if kind in (SB, SH):
            mem[addr & ~3] = (word & ~(mask << shift) & M32) | ((regs[a] & mask) << shift)
            return None, nnpc
        v = (word >> shift) & mask
        return (_sx(v, 8 * size) & M32 if kind in (LB, LH) else v), nnpc
    if kind in (BLEZ, BLTZ, BGEZ):
        s = _s32(regs[a])
        taken = s <= 0 if kind == BLEZ else (s < 0 if kind == BLTZ else s >= 0)
        return None, ((npc + c) & M32 if taken else nnpc)
    if kind in (J, JAL):
        return (npc + 4) & M32 if kind == JAL else None, c
    if kind in (JR, JALR):
        return (npc + 4) & M32 if kind == JALR else None, x
    raise GuestError(f"instruction kind {kind} has no semantics")


def _hint_read(mem: dict, hints: list, ptr: int, length: int):
    """The next stdin buffer into memory that the image leaves unset."""
    if not hints:
        raise GuestError("input read from an empty stdin")
    data = hints.pop(0)
    if len(data) != length or ptr & 3:
        raise GuestError(f"bad input read: {length} bytes at {ptr:#x}, {len(data)} given")
    for i in range(0, length, 4):
        if ptr + i in mem:
            raise GuestError(f"input read over set memory at {ptr + i:#x}")
        mem[ptr + i] = int.from_bytes(data[i:i + 4].ljust(4, b"\0"), "little")
