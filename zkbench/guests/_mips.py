"""MIPS32 words and ELF images for the benchmark's guests.

The guests are written here as MIPS32 machine words (the encodings of the
MIPS32 architecture manual) and packed into a little-endian ELF32 executable
that the program loads through its public ``Program.from_elf``, as it loads
any compiled guest.  Nothing here imports the program, so a change to the
program's assembler or loader cannot move the traffic.
"""

from __future__ import annotations

import struct

# registers (o32 names)
ZERO, V0, A0, A1, A2 = 0, 2, 4, 5, 6
T0, T1, T2, T3 = 8, 9, 10, 11
S0, S1, S2 = 16, 17, 18

# syscall codes (Ziren's zkm-zkvm: crates/core/executor/src/syscalls/code.rs)
SYS_HALT = 0x00_00_00_00
SYS_WRITE = 0x00_00_00_02
SYS_COMMIT = 0x00_00_00_10
SYS_KECCAK_SPONGE = 0x01_01_00_09
SYS_HINT_LEN = 0x00_00_00_F0
SYS_HINT_READ = 0x00_00_00_F1
FD_PUBLIC_VALUES = 3

TEXT_BASE = 0x1000
DATA_BASE = 0x0010_0000
HINT_BASE = 0x0020_0000  # fresh memory the input is read into


def _r(funct: int, rd: int = 0, rs: int = 0, rt: int = 0, sa: int = 0) -> int:
    return (rs << 21) | (rt << 16) | (rd << 11) | (sa << 6) | funct


def _i(op: int, rt: int, rs: int, imm: int) -> int:
    return (op << 26) | (rs << 21) | (rt << 16) | (imm & 0xFFFF)


def addu(rd, rs, rt):
    return _r(0x21, rd, rs, rt)


def or_(rd, rs, rt):
    return _r(0x25, rd, rs, rt)


def nop():
    return 0  # sll $0, $0, 0


def syscall():
    return _r(0x0C)


def addiu(rt, rs, imm):
    return _i(0x09, rt, rs, imm)


def ori(rt, rs, imm):
    return _i(0x0D, rt, rs, imm)


def lui(rt, imm):
    return _i(0x0F, rt, 0, imm)


def lw(rt, rs, off):
    return _i(0x23, rt, rs, off)


def sw(rt, rs, off):
    return _i(0x2B, rt, rs, off)


def bgtz(rs, word_offset):
    """Branch to (address of the delay slot) + 4 * word_offset."""
    return _i(0x07, 0, rs, word_offset)


def li(rt, value: int) -> list:
    """lui + ori: any 32-bit value in two instructions."""
    value &= 0xFFFFFFFF
    return [lui(rt, value >> 16), ori(rt, rt, value & 0xFFFF)]


def call(code: int, a0_src: int | None = None, a1_src: int | None = None) -> list:
    """$v0 = code; $a0, $a1 copied from registers (None leaves them); syscall."""
    words = li(V0, code)
    if a0_src is not None:
        words.append(or_(A0, a0_src, ZERO))
    if a1_src is not None:
        words.append(or_(A1, a1_src, ZERO))
    return words + [syscall()]


def read_input(ptr: int) -> list:
    """Read the next stdin buffer into fresh memory at ``ptr``, as
    zkm_zkvm::io::read_vec does: its length by SYSHINTLEN, then SYSHINTREAD."""
    return call(SYS_HINT_LEN) + [or_(A1, V0, ZERO)] + li(A0, ptr) + call(SYS_HINT_READ)


def halt() -> list:
    return [ori(V0, ZERO, SYS_HALT), ori(A0, ZERO, 0), syscall()]


def elf(text: list, data: list | None = None) -> bytes:
    """A little-endian ELF32 MIPS executable: ``text`` (words) at TEXT_BASE,
    read and execute, entry at its first word; ``data`` (words) at
    DATA_BASE, read and write."""
    segs = [(TEXT_BASE, b"".join(struct.pack("<I", w & 0xFFFFFFFF) for w in text), 5)]
    if data:
        segs.append((DATA_BASE, b"".join(struct.pack("<I", w & 0xFFFFFFFF) for w in data), 6))
    ehsize, phsize = 52, 32
    off = ehsize + phsize * len(segs)
    head = b"\x7fELF" + bytes([1, 1, 1, 0]) + bytes(8)
    head += struct.pack("<HHIIIIIHHHHHH", 2, 8, 1, TEXT_BASE, ehsize, 0, 0,
                        ehsize, phsize, len(segs), 40, 0, 0)
    phdrs, body = b"", b""
    for vaddr, blob, flags in segs:
        phdrs += struct.pack("<IIIIIIII", 1, off + len(body), vaddr, vaddr,
                             len(blob), len(blob), flags, 4)
        body += blob
    return head + phdrs + body
