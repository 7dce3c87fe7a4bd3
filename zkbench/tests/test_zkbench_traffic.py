"""The traffic: the same seed gives the same jobs, another seed other ones,
and the plain reference's outcome is the program's executor's."""

import numpy as np
import pytest

from zkbench import harness, spec
from zkbench.reference import keccak, mips

MIXES = ["fib2", "sha3chain460"]
SMALL = {"fib": {"guest": "fib", "iterations": 100},
         "keccak_chain": {"guest": "keccak_chain", "iterations": 3}}
BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_jobs_other_seed_other_jobs(mix):
    traffic = spec.traffic(mix)
    guest = spec.guest(traffic["guest"])
    assert guest.program(traffic) == guest.program(traffic)
    a = harness.job_stdin(guest, traffic, BIG_SEED, 1)
    assert a == harness.job_stdin(guest, traffic, BIG_SEED, 1)
    assert a != harness.job_stdin(guest, traffic, BIG_SEED + 1, 1)
    assert a != harness.job_stdin(guest, traffic, BIG_SEED, 2)


def test_fib_reference_is_the_recurrence():
    t = SMALL["fib"]
    bufs = spec.guest("fib").stdin(t, np.random.default_rng([BIG_SEED, 0]))
    a, b = (int(x) for x in np.frombuffer(bufs[0], "<u4"))
    for _ in range(t["iterations"]):
        a, b = b, (a + b) & 0xFFFFFFFF
    out = mips.run(spec.guest("fib").program(t), bufs)
    assert out["digest"][:2] == [b, a] and out["exit_code"] == 0
    assert out["public_values"] == np.array([b, a], "<u4").tobytes()


def test_keccak_chain_reference_is_the_chain():
    t = SMALL["keccak_chain"]
    bufs = spec.guest("keccak_chain").stdin(t, np.random.default_rng([BIG_SEED, 0]))
    d = bufs[0]
    for _ in range(t["iterations"]):
        d = keccak.keccak256(d)
    out = mips.run(spec.guest("keccak_chain").program(t), bufs)
    assert out["public_values"] == d
    assert out["digest"] == list(np.frombuffer(d, "<u4"))


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_reference_outcome_is_the_executors(kind):
    from zkmips_tpu_torch.executor import Program, execute_for_proving

    t = SMALL[kind]
    guest = spec.guest(kind)
    elf = guest.program(t)
    bufs = guest.stdin(t, np.random.default_rng([BIG_SEED, 3]))
    want = mips.run(elf, bufs)
    _records, info = execute_for_proving(Program.from_elf(elf), stdin_bufs=bufs, shard_size=1 << 20)
    assert info["executor"] == ("native" if kind == "fib" else "interpreter")
    assert (info["global_clk"], info["exit_code"], info["public_values"], list(info["digest"])) == \
        (want["cycles"], want["exit_code"], want["public_values"], want["digest"])


def test_reference_refuses_what_it_does_not_know():
    from zkbench.guests import _mips as m

    with pytest.raises(mips.GuestError):
        mips.run(m.elf([0x70000002]))  # MUL: outside the reference's set


def _every_instruction_guest() -> tuple:
    """A guest that runs every instruction the reference knows and writes
    each result to the public values."""
    from zkbench.guests import _mips as m

    def r(funct, rd, rs, rt, sa=0):
        return m._r(funct, rd, rs, rt, sa)

    def i(op, rt, rs, imm):
        return m._i(op, rt, rs, imm)

    T4, T5, T6, S3, RA = 12, 13, 14, 19, 31
    buf, out = m.DATA_BASE, []
    text = m.li(m.T0, 0x8765_4321) + m.li(m.T1, 0x0000_0013) + m.li(m.S0, buf)

    def keep(reg):  # store reg at the next output word
        text.append(m.sw(reg, m.S0, 4 * len(out)))
        out.append(reg)

    for funct in (0x21, 0x23, 0x24, 0x25, 0x26, 0x27, 0x2A, 0x2B):  # addu subu and or xor nor slt sltu
        text.append(r(funct, m.T2, m.T0, m.T1)); keep(m.T2)
        text.append(r(funct, m.T2, m.T1, m.T0)); keep(m.T2)
    for funct in (0x04, 0x06, 0x07):  # sllv srlv srav
        text.append(r(funct, m.T2, m.T1, m.T0)); keep(m.T2)
    for funct in (0x00, 0x02, 0x03):  # sll srl sra
        text.append(r(funct, m.T2, 0, m.T0, 7)); keep(m.T2)
    for op in (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x0E):  # addiu slti sltiu andi ori xori
        text.append(i(op, m.T2, m.T0, 0x8001)); keep(m.T2)
        text.append(i(op, m.T2, m.T1, 0x0005)); keep(m.T2)
    text.append(m._i(0x1C, 0, m.T0, 0) | (m.T1 << 16) | (m.T2 << 11) | 0x02); keep(m.T2)  # mul
    text += m.li(S3, buf + 0x200) + [m.sw(m.T0, S3, 0)]
    for op, off in ((0x20, 1), (0x24, 3), (0x21, 2), (0x25, 0), (0x20, 0), (0x21, 0)):  # lb lbu lh lhu
        text.append(i(op, m.T2, S3, off)); keep(m.T2)
    text += [i(0x28, m.T1, S3, 2), i(0x29, m.T1, S3, 4), m.lw(m.T2, S3, 0)]; keep(m.T2)  # sb sh
    text.append(m.lw(m.T2, S3, 4)); keep(m.T2)
    # branches: taken and not, each adds to T4 in its delay slot and skips a poison add
    text += m.li(T4, 0) + m.li(T5, 1) + m.li(T6, 0xFFFFFFFF)
    for op, rs, rt in ((0x04, T5, T5), (0x05, T5, T6), (0x06, T6, 0), (0x07, T5, 0),
                       (0x01, T6, 0), (0x01, T5, 1), (0x06, T5, 0), (0x04, T5, T6)):
        text += [i(op, rt, rs, 2), m.addiu(T4, T4, 1), m.addiu(T4, T4, 100)]
    keep(T4)
    # jumps: jal to F, which adds 10 and returns by jalr (linking T3) to the add of 1 after
    # the jal; a j over the body of F to the end; the poison add is never run
    base = m.TEXT_BASE + 4 * len(text)
    text += [(0x03 << 26) | ((base + 20) >> 2), m.nop(), m.addiu(T4, T4, 1),
             (0x02 << 26) | ((base + 36) >> 2), m.nop(),
             m.addiu(T4, T4, 10), r(0x09, m.T3, RA, 0), m.nop(), m.addiu(T4, T4, 5000)]
    keep(T4)
    keep(m.T3)
    text += m.li(m.A2, 4 * len(out)) + m.li(m.A0, m.FD_PUBLIC_VALUES) + m.call(m.SYS_WRITE, a1_src=m.S0)
    return m.elf(text + m.halt()), len(out)


def test_every_reference_instruction_is_the_executors():
    from zkmips_tpu_torch.executor import Program, execute_for_proving

    elf, n = _every_instruction_guest()
    want = mips.run(elf, [])
    _records, info = execute_for_proving(Program.from_elf(elf), shard_size=1 << 20)
    assert len(want["public_values"]) == 4 * n
    assert (info["global_clk"], info["public_values"]) == (want["cycles"], want["public_values"])
