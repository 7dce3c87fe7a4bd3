"""The port's native trace executor against the reference package's.

The same guest, assembled with each package's own mini-assembler, runs through
the port's ``run_trace``, the reference's ``run_trace`` and the reference's
Python ``Executor``.  Everything is integer data and is compared exactly
(tolerance 0): the CPU columns, the local memory chains, the init/finalize
events and the public values.
"""

import os

import numpy as np
import pytest

from zkmips_tpu.executor import Executor as JExecutor
from zkmips_tpu.executor import Instruction as JInstruction
from zkmips_tpu.executor import Opcode as JOpcode
from zkmips_tpu.executor import Register as JRegister
from zkmips_tpu.executor import asm as jasm
from zkmips_tpu.executor import native_trace as jnative
from zkmips_tpu.executor.columnar import cpu_struct as jcpu_struct

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import (
    ExecutionError, Instruction, NativeUnsupported, Opcode, Register, asm, execute_for_proving,
    native_trace,
)
from zkmips_tpu_torch.executor.columnar import CPU_DTYPE, cpu_struct
from zkmips_tpu_torch.utils import cbuild

pytestmark = pytest.mark.skipif(not native_trace.available(), reason="no C toolchain")

JAX_SIDE = (jasm, JInstruction, JRegister, JOpcode)
PORT_SIDE = (asm, Instruction, Register, Opcode)


def fib_body(side, n=50):
    """The headline fib guest's loop (bench.py), ``n`` iterations."""
    a, I, R, O = side
    return [
        *a.li(R.T0, 0), *a.li(R.T1, 1), *a.li(R.T2, n),
        a.alu(O.ADD, R.T3, R.T0, R.T1),
        I(O.ADD, R.T0, R.T1, 0, False, True),
        I(O.ADD, R.T1, R.T3, 0, False, True),
        a.addi(R.T2, R.T2, -1 & 0xFFFFFFFF),
        a.branch(O.BGTZ, R.T2, 0, -20),
        a.nop(),
    ]


def minimal_ops_body(side):
    """Every opcode the minimal machine has a chip for, branches taken and
    not taken, the three jumps, and a COMMIT syscall before the HALT."""
    a, I, R, O = side
    start = 0x1000
    body = [
        *a.li(R.T0, 0x12345678), *a.li(R.T1, 0xFFFF0000), *a.li(R.T5, 7),
        a.alu(O.ADD, R.T2, R.T0, R.T1), a.alu(O.SUB, R.T3, R.T0, R.T1),
        a.alu(O.AND, R.T4, R.T0, R.T1), a.alu(O.OR, R.T4, R.T0, R.T1),
        a.alu(O.XOR, R.T6, R.T0, R.T1), a.alu(O.NOR, R.T7, R.T0, R.T1),
        a.alu(O.SLT, R.T2, R.T0, R.T1), a.alu(O.SLT, R.T2, R.T1, R.T0),
        a.alu(O.SLTU, R.T2, R.T1, R.T0), a.alu(O.SLTU, R.T2, R.T0, R.T1),
        a.alu(O.SLL, R.T3, R.T0, 7, imm_c=True), a.alu(O.SLL, R.T3, R.T0, R.T5),
        a.alu(O.SRL, R.T3, R.T0, 9, imm_c=True), a.alu(O.SRA, R.T3, R.T1, 5, imm_c=True),
        a.alu(O.SRA, R.T3, R.T0, 31, imm_c=True), a.alu(O.ROR, R.T3, R.T0, 13, imm_c=True),
        a.alu(O.SRL, R.T3, R.T0, 0, imm_c=True),
        a.branch(O.BEQ, R.T0, R.T0, 8), a.nop(), a.nop(),
        a.branch(O.BEQ, R.T0, R.T1, 8), a.nop(), a.nop(),
        a.branch(O.BNE, R.T0, R.T1, 8), a.nop(), a.nop(),
        a.branch(O.BNE, R.T0, R.T0, 8), a.nop(), a.nop(),
        a.branch(O.BGEZ, R.T0, 0, 8), a.nop(), a.nop(),
        a.branch(O.BGEZ, R.T1, 0, 8), a.nop(), a.nop(),
        a.branch(O.BGTZ, R.T0, 0, 8), a.nop(), a.nop(),
        a.branch(O.BGTZ, 0, 0, 8), a.nop(), a.nop(),
        a.branch(O.BLEZ, 0, 0, 8), a.nop(), a.nop(),
        a.branch(O.BLEZ, R.T0, 0, 8), a.nop(), a.nop(),
        a.branch(O.BLTZ, R.T1, 0, 8), a.nop(), a.nop(),
        a.branch(O.BLTZ, R.T0, 0, 8), a.nop(), a.nop(),
        I(O.JumpDirect, R.RA, 8, 0, True, True), a.nop(), a.nop(),
    ]
    at = start + 4 * len(body)
    body += [I(O.Jumpi, 31, at + 12, 0, True, True), a.addi(R.T2, 0, 1), a.addi(R.T2, 0, 2),
             a.addi(R.T3, 0, 1)]
    at = start + 4 * len(body)
    body += [*a.li(R.T0, at + 20), I(O.Jump, R.T9, R.T0, 0, False, True), a.addi(R.T2, 0, 3),
             a.addi(R.T2, 0, 4), a.addi(R.T3, 0, 2)]
    # COMMIT word 3 of the public-value digest
    body += [*a.li(R.V0, 0x10), *a.li(R.A0, 3), *a.li(R.A1, 0xCAFEF00D), a.syscall()]
    return body


GUESTS = {
    "fib": (fib_body, 1 << 20),
    "fib_sharded": (fib_body, 64),
    "minimal_ops": (minimal_ops_body, 1 << 20),
    "minimal_ops_sharded": (minimal_ops_body, 32),
}


def _programs(body_fn):
    jp = jasm.prog(body_fn(JAX_SIDE) + jasm.halt_sequence())
    tp = asm.prog(body_fn(PORT_SIDE) + asm.halt_sequence())
    return jp, tp


def _mem(r):
    return (r.value, r.shard, r.timestamp)


def _local(rec):
    return {a: (e.addr, _mem(e.initial), _mem(e.final)) for a, e in rec.local_memory_access.items()}


def _init_final(events):
    return [(e.addr, e.value, e.shard, e.timestamp, e.used) for e in events]


PV_FIELDS = ("committed_value_digest", "deferred_proofs_digest", "shard", "execution_shard",
             "start_pc", "next_pc", "exit_code", "prev_init_addr", "last_init_addr",
             "prev_finalize_addr", "last_finalize_addr")


def _assert_records_equal(port_rec, ref_rec, ref_cols):
    assert port_rec.shard == ref_rec.shard
    cols = cpu_struct(port_rec)
    assert len(port_rec.cpu_events) == len(ref_rec.cpu_events)
    for name in CPU_DTYPE.names:
        assert np.array_equal(cols[name], ref_cols[name]), f"column {name}, shard {ref_rec.shard}"
    assert _local(port_rec) == _local(ref_rec)
    assert _init_final(port_rec.global_memory_initialize_events) == \
        _init_final(ref_rec.global_memory_initialize_events)
    assert _init_final(port_rec.global_memory_finalize_events) == \
        _init_final(ref_rec.global_memory_finalize_events)
    for name in PV_FIELDS:
        assert getattr(port_rec.public_values, name) == getattr(ref_rec.public_values, name), name


def test_program_and_assembler_match():
    jp, tp = _programs(minimal_ops_body)
    assert (tp.pc_start, tp.pc_base, tp.image) == (jp.pc_start, jp.pc_base, jp.image)
    assert len(tp.instructions) == len(jp.instructions)
    for a, b in zip(tp.instructions, jp.instructions):
        assert (int(a.opcode), a.op_a, a.op_b, a.op_c, a.imm_b, a.imm_c) == \
            (int(b.opcode), b.op_a, b.op_b, b.op_c, b.imm_b, b.imm_c)
    conv = convert.program_to_port(jp)
    assert [repr(i) for i in conv.instructions] == [repr(i) for i in tp.instructions]
    assert {int(o) for o in Opcode} == {int(o) for o in JOpcode}


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_run_trace_matches_reference_native(guest):
    body_fn, shard_size = GUESTS[guest]
    jp, tp = _programs(body_fn)
    ref_records, ref_info = jnative.run_trace(jp, shard_size=shard_size)
    records, info = native_trace.run_trace(tp, shard_size=shard_size)
    assert len(records) == len(ref_records)
    assert info == ref_info
    for rec, ref in zip(records, ref_records):
        _assert_records_equal(rec, ref, ref._cpu_struct)


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_run_trace_matches_reference_interpreter(guest):
    body_fn, shard_size = GUESTS[guest]
    jp, tp = _programs(body_fn)
    ex = JExecutor(jp, shard_size=shard_size)
    ref_records = ex.run()
    records, info = execute_for_proving(tp, shard_size=shard_size)
    assert len(records) == len(ref_records)
    assert info["global_clk"] == ex.global_clk
    assert info["exit_code"] == ex.exit_code
    assert info["digest"] == list(ex.committed_value_digest)
    assert info["public_values"] == bytes(ex.public_values_stream)
    assert info["stdout"] == bytes(ex.stdout)
    for rec, ref in zip(records, ref_records):
        _assert_records_equal(rec, ref, jcpu_struct(ref))


@pytest.mark.parametrize("source", ["native", "interpreter"])
def test_record_to_port_carries_everything(source):
    jp, tp = _programs(minimal_ops_body)
    if source == "native":
        ref_records, _ = jnative.run_trace(jp, shard_size=32)
    else:
        ref_records = JExecutor(jp, shard_size=32).run()
    assert len(ref_records) > 2
    for ref in ref_records:
        had_cache = getattr(ref, "_cpu_struct", None) is not None
        rec = convert.record_to_port(ref, tp)
        assert (getattr(ref, "_cpu_struct", None) is not None) == had_cache
        _assert_records_equal(rec, ref, jcpu_struct(ref))
        assert rec.program is tp
        # the array-backed event views agree with the reference's events
        for e, r in zip(rec.cpu_events, ref.cpu_events):
            assert (e.clk, e.pc, e.next_pc, e.a, e.b, e.c) == (r.clk, r.pc, r.next_pc, r.a, r.b, r.c)


def test_commit_reaches_the_public_values():
    _, tp = _programs(minimal_ops_body)
    records, info = execute_for_proving(tp)
    assert info["digest"][3] == 0xCAFEF00D
    assert records[-1].public_values.committed_value_digest[3] == 0xCAFEF00D


def test_unsupported_guest_raises_and_names_the_missing_interpreter():
    """The native executor refuses a precompile guest and names the Python
    interpreter; ``execute_for_proving`` then runs that interpreter, and so
    it does for a deferred-proof stream."""
    a, _, R, _ = PORT_SIDE
    # SHA_EXTEND precompile: the native machine does not run it
    body = [*a.li(R.V0, 0x30010005), *a.li(R.A0, 0x2000), *a.li(R.A1, 0), a.syscall()]
    program = asm.prog(body + asm.halt_sequence())
    with pytest.raises(NativeUnsupported, match="Python trace executor"):
        native_trace.run_trace(program)
    records, info = execute_for_proving(program)
    assert info["executor"] == "interpreter"
    assert len(records[0].precompile_events["sha_extend"]) == 1
    _, info = execute_for_proving(asm.prog(fib_body(PORT_SIDE, 3) + asm.halt_sequence()),
                                  proof_stream=[object()])
    assert info["executor"] == "interpreter"


def test_max_cycles_raises():
    _, tp = _programs(fib_body)
    with pytest.raises(ExecutionError, match="max_cycles"):
        execute_for_proving(tp, max_cycles=20)


def test_library_is_built_under_build_not_beside_the_source():
    lib = native_trace.library()
    assert os.path.dirname(lib) == str(cbuild.BUILD_DIR)
    assert cbuild.BUILD_DIR.parts[-2:] == ("build", "native")
    assert os.path.basename(os.path.dirname(native_trace._SRC)) == "csrc"
    assert native_trace.library() == lib and os.path.exists(lib)  # content-hashed: no rebuild


def test_threads_that_build_one_library_together_all_get_it(monkeypatch, tmp_path):
    """The first use of a native library may come from several threads at
    once (the recursion prover lifts shards in a pool): every thread gets
    the built library, and no temporary file is left behind."""
    from concurrent.futures import ThreadPoolExecutor

    src = tmp_path / "tiny.c"
    src.write_text("int zkm_tiny(int x) { return x + 1; }\n")
    monkeypatch.setattr(cbuild, "BUILD_DIR", tmp_path / "native")
    with ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(lambda _: cbuild.build(str(src)), range(8)))
    assert len(set(paths)) == 1 and os.path.exists(paths[0])
    assert os.listdir(tmp_path / "native") == [os.path.basename(paths[0])]
