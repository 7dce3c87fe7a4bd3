"""The fib guest: Ziren's fibonacci benchmark pattern, six cycles an iteration.

The program reads a start pair (a, b) from stdin, runs (a, b) = (b, a + b)
modulo 2^32 ``iterations`` times, writes the last two values to the
public-values stream and commits them as digest words 0 and 1.  Plain ALU
work on a long program, with no precompile, so the native executor runs it.
Each job draws its start pair from its generator; the program is the same
for every job of a mix.
"""

from __future__ import annotations

from . import _mips as m


def program(params: dict) -> bytes:
    n = int(params["iterations"])
    text = m.read_input(m.HINT_BASE) + m.li(m.S0, m.HINT_BASE)
    text += [m.lw(m.T0, m.S0, 0), m.lw(m.T1, m.S0, 4)] + m.li(m.T2, n)
    text += [
        m.addu(m.T3, m.T0, m.T1),  # loop:
        m.addu(m.T0, m.T1, m.ZERO),
        m.addu(m.T1, m.T3, m.ZERO),
        m.addiu(m.T2, m.T2, -1),
        m.bgtz(m.T2, -5),
        m.nop(),
    ]
    text += m.li(m.S0, m.DATA_BASE) + [m.sw(m.T1, m.S0, 0), m.sw(m.T0, m.S0, 4)]
    text += m.li(m.A2, 8) + m.li(m.A0, m.FD_PUBLIC_VALUES) + m.call(m.SYS_WRITE, a1_src=m.S0)
    text += m.li(m.A0, 0) + m.call(m.SYS_COMMIT, a1_src=m.T1)
    text += m.li(m.A0, 1) + m.call(m.SYS_COMMIT, a1_src=m.T0)
    text += m.halt()
    return m.elf(text)


def stdin(params: dict, rng) -> list:
    """The start pair, two little-endian 32-bit words."""
    return [rng.integers(0, 1 << 32, size=2, dtype="uint64").astype("<u4").tobytes()]
