"""Program: decoded instructions + initial memory image; ELF32 MIPS loader.

Faithful to the reference loader (crates/core/executor/src/program.rs:52-167):
little-endian ELF32 EM_MIPS ET_EXEC, PT_LOAD segments copied word-wise into
the image, executable segments decoded into instructions, stack initialized
at INIT_SP with argc/argv/auxv, and $brk/$heap seeded at register-index image
slots (registers live at image addresses 0..35).
"""

from __future__ import annotations

import io
import struct

from .instruction import Instruction, decode_instruction
from .opcodes import Register

MAX_MEMORY = 0x7F000000
MAX_CODE_MEMORY = 0x3F000000
INIT_SP = MAX_MEMORY - 0x4000
WORD_SIZE = 4

PT_LOAD = 1
PF_X = 1
EM_MIPS = 8
ET_EXEC = 2


class Program:
    def __init__(self, instructions: list[Instruction], pc_start: int, pc_base: int, image: dict | None = None):
        self.instructions = instructions
        self.pc_start = pc_start
        self.pc_base = pc_base
        self.next_pc = pc_start + 4
        self.image: dict[int, int] = image if image is not None else {}

    def fetch(self, pc: int) -> Instruction:
        return self.instructions[(pc - self.pc_base) >> 2]

    @staticmethod
    def from_elf(elf_bytes: bytes) -> "Program":
        b = elf_bytes
        if b[:4] != b"\x7fELF":
            raise ValueError("not an ELF file")
        if b[4] != 1 or b[5] != 1:
            raise ValueError("not a 32-bit little-endian ELF")
        (e_type, e_machine, _ver, e_entry, e_phoff, _shoff, _flags, _ehsize, _phentsize, e_phnum) = struct.unpack_from(
            "<HHIIIIIHHH", b, 16
        )
        if e_machine != EM_MIPS:
            raise ValueError("not a MIPS ELF")
        if e_type != ET_EXEC:
            raise ValueError("not an executable ELF")
        entry = e_entry & 0xFFFFFFFF
        if entry >= MAX_CODE_MEMORY or entry % 4 != 0:
            raise ValueError("invalid entrypoint")

        image: dict[int, int] = {}
        code_words: list[int] = []
        base_address = 0xFFFFFFFF
        hiaddr = 0
        for i in range(e_phnum):
            (p_type, p_offset, p_vaddr, _paddr, p_filesz, p_memsz, p_flags, _align) = struct.unpack_from(
                "<IIIIIIII", b, e_phoff + i * 32
            )
            if p_type != PT_LOAD:
                continue
            if p_vaddr % 4 != 0:
                raise ValueError(f"unaligned segment vaddr {p_vaddr:#x}")
            executable = (p_flags & PF_X) != 0
            if executable and p_vaddr < base_address:
                base_address = p_vaddr
            for off in range(0, p_memsz, WORD_SIZE):
                addr = p_vaddr + off
                if addr >= MAX_CODE_MEMORY:
                    raise ValueError(f"segment address {addr:#x} out of range")
                if off >= p_filesz:
                    word = 0
                else:
                    chunk = b[p_offset + off : p_offset + off + min(4, p_filesz - off)]
                    word = int.from_bytes(chunk.ljust(4, b"\x00"), "little")
                image[addr] = word
                if off < p_filesz and executable:
                    code_words.append(word)
                hiaddr = max(hiaddr, addr)

        image[int(Register.BRK)] = hiaddr
        image[int(Register.HEAP)] = 0x20000000
        _patch_stack(image)

        instructions = [decode_instruction(w) for w in code_words]
        return Program(instructions, entry, base_address, image)


def _patch_stack(image: dict):
    """Init argc/argv/envp/auxv at INIT_SP (program.rs:271-320)."""
    sp = INIT_SP
    image[int(Register.SP)] = sp
    image[sp] = 0  # argc = 0
    cur = sp + 4
    image[cur] = 0  # argv terminator
    cur += 4
    image[cur] = 0  # envp terminator
    cur += 4
    for key, val in [(6, 0x1000), (0x0B, 0x3E8), (0x0C, 0x3E8), (0x0D, 0x3E8), (0x0E, 0x3E8), (0x10, 0), (0x11, 0x64), (0x17, 0)]:
        image[cur] = key
        image[cur + 4] = val
        cur += 8
    # AT_RANDOM pointer + 16 bytes of (deterministic) randomness
    image[cur] = 0x19
    image[cur + 4] = cur + 12
    cur += 8
    image[cur] = 0  # auxv terminator (AT_NULL)
    image[cur + 4] = 0
    image[cur + 8] = 0x5A5A5A5A
    image[cur + 12] = 0x5A5A5A5A
    image[cur + 16] = 0x5A5A5A5A
    image[cur + 20] = 0x5A5A5A5A
