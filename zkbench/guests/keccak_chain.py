"""The sha3-chain guest: Ziren's "sha3-chain with keccak precompile" pattern.

The program reads a 32-byte message from stdin and runs digest =
keccak256(digest) ``iterations`` times, one KECCAK_SPONGE syscall an
iteration: the message's padding lies in the ELF's data segment, and after
each sponge call the guest copies the 32-byte digest back over the message.
The final digest is written to the public-values stream and committed as
the eight digest words.  The precompile sends the guest to the program's
interpreter.  Each job draws its message from its generator; the program is
the same for every job of a mix.
"""

from __future__ import annotations

from . import _mips as m

BLOCK_WORDS = 36  # one 136-byte rate block and 2 words of the sponge's u64 lanes
OUT_OFFSET = 0x100  # the sponge's 16 output words; the input length word at +64


def program(params: dict) -> bytes:
    n = int(params["iterations"])
    block = [0] * BLOCK_WORDS
    block[8] = 0x01  # keccak padding of a 32-byte message: byte 32 = 0x01 ...
    block[33] = 0x80000000  # ... and byte 135 = 0x80
    data = block + [0] * (OUT_OFFSET // 4 - BLOCK_WORDS) + [0] * 16 + [BLOCK_WORDS]
    text = m.read_input(m.HINT_BASE) + m.li(m.S1, m.DATA_BASE) + m.li(m.S2, m.HINT_BASE)
    for i in range(8):
        text += [m.lw(m.T0, m.S2, 4 * i), m.sw(m.T0, m.S1, 4 * i)]
    text += [m.addiu(m.S2, m.S1, OUT_OFFSET)] + m.li(m.S0, n)
    loop = m.call(m.SYS_KECCAK_SPONGE, a0_src=m.S1, a1_src=m.S2)
    for i in range(8):
        loop += [m.lw(m.T0, m.S2, 4 * i), m.sw(m.T0, m.S1, 4 * i)]
    loop += [m.addiu(m.S0, m.S0, -1)]
    loop += [m.bgtz(m.S0, -(len(loop) + 1)), m.nop()]
    text += loop
    text += m.li(m.A2, 32) + m.li(m.A0, m.FD_PUBLIC_VALUES) + m.call(m.SYS_WRITE, a1_src=m.S1)
    for i in range(8):
        text += [m.lw(m.T0, m.S1, 4 * i)] + m.li(m.A0, i) + m.call(m.SYS_COMMIT, a1_src=m.T0)
    text += m.halt()
    return m.elf(text, data)


def stdin(params: dict, rng) -> list:
    """The 32-byte message."""
    return [rng.integers(0, 1 << 32, size=8, dtype="uint64").astype("<u4").tobytes()]
