"""The port's simple-mode native executor (``executor/native.run_native``,
``csrc/executor.c``) against the reference package's bridge and the port's
Python interpreter: equal final registers, cycles, digest, public values
and stdout (tolerance 0)."""

import struct

import numpy as np
import pytest

from zkmips_tpu.executor.native import NativeUnsupported as JNativeUnsupported
from zkmips_tpu.executor.native import run_native as j_run_native

from zkmips_tpu_torch.executor import Executor, NativeUnsupported, asm, guests, native
from zkmips_tpu_torch.executor import Opcode as O, Register as R, SyscallCode as C
from zkmips_tpu_torch.guest import corpus

from test_torch_interpreter import ref_program


def _keccak_body():
    return guests.keccak_message_program(b"zkmips-tpu keccak differential test vector!") \
        .instructions[:-len(asm.halt_sequence())]


def _fib(n):
    return [*asm.li(R.T0, 0), *asm.li(R.T1, 1), *asm.li(R.T2, n),
            asm.alu(O.ADD, R.T3, R.T0, R.T1), asm.addi(R.T0, R.T1, 0), asm.addi(R.T1, R.T3, 0),
            asm.addi(R.T2, R.T2, -1 & 0xFFFFFFFF), asm.branch(O.BGTZ, R.T2, 0, -20), asm.nop()]


def _commit_body():
    body = guests.store(0x2000, [i * 7 + 3 for i in range(16)])
    body += guests.call(C.SHA_EXTEND, 0x2000, 0)
    body += guests.call(C.COMMIT, 1, 0xBEEF)
    body += [*asm.li(R.A2, 4), *guests.call(C.WRITE, 3, 0x2000), *asm.li(R.A2, 8),
             *guests.call(C.WRITE, 1, 0x2010)]
    return body


PROGRAMS = {
    "all_ops": lambda: (guests.program(guests.all_ops_body()), []),
    "fib": lambda: (guests.program(_fib(1_500)), []),
    "sha_commit_write": lambda: (guests.program(_commit_body()), []),
    "keccak": lambda: (guests.program(_keccak_body()), []),
    "io_hints": lambda: corpus.corpus()["io_hints_commit"],
    "sha256_chain": lambda: corpus.corpus()["sha256_chain"],
}


def _same(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert np.array_equal(got[k], ref[k]), k
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_outputs_equal_the_reference_and_the_interpreter(name):
    tp, stdin = PROGRAMS[name]()
    got = native.run_native(tp, stdin=stdin)
    _same(got, j_run_native(ref_program(tp), stdin=stdin))
    ex = Executor(tp)
    for buf in stdin:
        ex.write_stdin(buf)
    ex.run()
    assert [ex.register(r) for r in range(36)] == got["regs"].tolist()
    assert (ex.global_clk, ex.exit_code) == (got["global_clk"], got["exit_code"])
    assert list(ex.committed_value_digest) == got["digest"]
    assert (bytes(ex.public_values_stream), bytes(ex.stdout)) == (got["public_values"], got["stdout"])
    assert not got["hit_max_cycles"]


def test_the_guests_reach_the_outputs():
    got = native.run_native(PROGRAMS["sha_commit_write"]()[0])
    assert got["digest"][1] == 0xBEEF and len(got["public_values"]) == 4 and len(got["stdout"]) == 8
    tp, stdin = PROGRAMS["io_hints"]()
    a, b = (struct.unpack("<I", s)[0] for s in stdin)
    total = sum(a + (i + 1) * b for i in range(16)) & 0xFFFFFFFF
    assert native.run_native(tp, stdin=stdin)["digest"][0] == total


def test_max_cycles_stops_the_guest():
    tp, _ = PROGRAMS["fib"]()
    got = native.run_native(tp, max_cycles=1000)
    _same(got, j_run_native(ref_program(tp), max_cycles=1000))
    assert got["hit_max_cycles"] and got["global_clk"] == 1000


def test_unsupported_syscall_raises_in_both():
    # the EC precompiles run only in the interpreter
    tp = guests.program(guests.wei_body(*next(iter(guests.WEI_CURVES.values()))))
    with pytest.raises(NativeUnsupported):
        native.run_native(tp)
    with pytest.raises(JNativeUnsupported):
        j_run_native(ref_program(tp))


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken_executor.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(Exception) as err:
        native.run_native(guests.program(_fib(3)))
    assert not isinstance(err.value, NativeUnsupported)
