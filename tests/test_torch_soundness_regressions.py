"""The port's twin of ``tests/test_soundness_regressions.py``: the same five
malicious-prover tamperings, mounted on the same exit_group guest's real
traces built by the port (``executor``, ``machine.mips_machine``,
``stark.chip.pad_to_power_of_two``), must each be rejected by the port's
constraint system (``stark.debug.debug_constraints``):

1. exit_group halt suppression: is_extgroup_sc = is_halt_sc = 0 on the
   exit_group row of SyscallInstrs violates the biconditional
   inverse-witness constraint,
2. the same with an adversarial inverse witness,
3. a SysLinux fake padding row (is_real = 0, is_mmap = 1: a free HEAP
   read-modify-write) violates the unconditional flag one-hot,
4. a SyscallInstrs fake padding row with is_linux_sc = 1 (a free linux
   bridge send) violates the unconditional flag sum,
5. the same with is_shaext_sc = 1 (a free sha-extend send).

Each case first checks the untampered trace (a control: a check that
rejects everything cannot pass) and that it equals the reference's trace
of the same chip, bit for bit.
"""

import numpy as np
import pytest

from zkmips_tpu.executor import Executor as JExecutor
from zkmips_tpu.executor import asm as jasm
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.stark.machine import StarkConfig as JStarkConfig

from zkmips_tpu_torch.executor import Executor, Register, asm
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.stark import debug
from zkmips_tpu_torch.stark.chip import pad_to_power_of_two
from zkmips_tpu_torch.stark.machine import StarkConfig

R = Register


def _exit_group_record(asm_, executor, machine, config):
    body = [*asm_.li(R.V0, 4246), *asm_.li(R.A0, 7), asm_.syscall(), asm_.nop()]
    m = machine(config.test())
    rec = executor(asm_.prog(body)).run()[0]
    m.generate_dependencies(rec)
    return m, rec


@pytest.fixture(scope="module")
def port():
    return _exit_group_record(asm, Executor, mips_machine, StarkConfig)


@pytest.fixture(scope="module")
def reference():
    return _exit_group_record(jasm, JExecutor, j_mips_machine, JStarkConfig)


def _trace(m, rec, name):
    chip = {c.name: c for c in m.machine.chips}[name]
    return chip, pad_to_power_of_two(chip.air.generate_trace(rec, None).astype(np.uint32))


def _exit_group_row(t, s):
    rows = np.nonzero(t[:, s.idx("is_extgroup_sc")])[0]
    assert rows.size, "guest must produce an exit_group row"
    return rows[0]


def _padding_row(t, s):
    pad = np.nonzero(t[:, s.idx("is_real")] == 0)[0]
    assert pad.size, "trace must have padding rows"
    return pad[0]


def _halt_suppressed(t, s):
    # malicious prover: drop the halt flag, keep the row a linux syscall
    r = _exit_group_row(t, s)
    t[r, s.idx("is_extgroup_sc")] = 0
    t[r, s.idx("is_halt_sc")] = 0
    yield t


def _halt_suppressed_with_inverse(t, s):
    # even an adversarially-chosen inverse witness cannot satisfy the
    # biconditional when pa.lo == SYS_EXT_GROUP
    r = _exit_group_row(t, s)
    t[r, s.idx("is_extgroup_sc")] = 0
    for witness in (0, 1, 0x12345, 0x7EFFFFFF):
        t[r, s.idx("extgroup_inv")] = witness
        yield t


def _fake_mmap_padding_row(t, s):
    # fake mmap row on padding: would bump HEAP with no incoming message
    r = _padding_row(t, s)
    for col in ("is_mmap", "immap_a00", "ia00", "a0hi_z", "a0l0_z", "po_z"):
        t[r, s.idx(col)] = 1
    yield t


def _fake_linux_padding_row(t, s):
    # fake linux bridge send on padding: prover-chosen shard/clk/args
    t[_padding_row(t, s), s.idx("is_linux_sc")] = 1
    yield t


def _fake_precompile_padding_row(t, s):
    # fake sha-extend send on padding (pre_mult exposure)
    r = _padding_row(t, s)
    t[r, s.idx("is_shaext_sc")] = 1
    t[r, s.idx("pa_lo")] = 0x30 & 0xFFFF
    yield t


CASES = {
    "exit_group_halt_suppression": ("SyscallInstrs", _halt_suppressed),
    "exit_group_halt_suppression_with_inverse": ("SyscallInstrs", _halt_suppressed_with_inverse),
    "sys_linux_fake_padding_row": ("SysLinux", _fake_mmap_padding_row),
    "syscall_instr_fake_linux_padding_row": ("SyscallInstrs", _fake_linux_padding_row),
    "syscall_instr_fake_precompile_padding_row": ("SyscallInstrs", _fake_precompile_padding_row),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tampered_trace_rejected(port, reference, case):
    name, tamper = CASES[case]
    m, rec = port
    chip, t = _trace(m, rec, name)
    assert np.array_equal(t, _trace(*reference, name)[1]), "the port's trace differs from the reference's"
    pv = m.shard_public_values(rec)
    assert debug.debug_constraints(chip, t, None, publics=pv)  # the untampered control
    tampered = 0
    for bad in tamper(t.copy(), chip.air.schema):
        with pytest.raises(AssertionError, match=f"chip {name}: constraint"):
            debug.debug_constraints(chip, bad, None, publics=pv)
        tampered += 1
    assert tampered >= 1
