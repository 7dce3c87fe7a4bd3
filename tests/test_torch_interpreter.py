"""The port's Python interpreter, syscalls, hooks and ELF loader against the
reference package's.

The same program runs through each package's own ``Executor``: the port's
program is built with the port's mini-assembler and handed to the reference
as its own ``Program`` with the same instructions and image.  Records,
stdout, exit codes, public values and the syscall counts are integer data
and are compared exactly (tolerance 0): every field of every event, the
precompile events included, normalised to plain Python values.
"""

import dataclasses
import enum
import os

import numpy as np
import pytest

from zkmips_tpu.executor import Executor as JExecutor
from zkmips_tpu.executor import Instruction as JInstruction
from zkmips_tpu.executor import Opcode as JOpcode
from zkmips_tpu.executor import cost as jcost
from zkmips_tpu.executor import hooks as jhooks
from zkmips_tpu.executor.program import Program as JProgram

from zkmips_tpu_torch.executor import (
    ExecutionError, Executor, NativeUnsupported, Program, asm, cost, curves as cv,
    execute_for_proving, guests, hooks, native_trace,
)
from zkmips_tpu_torch.executor.opcodes import Register as R, SyscallCode as C

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "guests")
ELF_NAMES = sorted(n[:-4] for n in os.listdir(FIXTURES) if n.endswith(".elf"))
IO_STDIN = [(0x12345678).to_bytes(4, "little"), (0x0F0F0F0F).to_bytes(4, "little")]


def ref_program(tp):
    """The port's ``Program`` as the reference's: the same instructions and image."""
    return JProgram(
        [JInstruction(JOpcode(int(i.opcode)), i.op_a, i.op_b, i.op_c, i.imm_b, i.imm_c, i.raw)
         for i in tp.instructions],
        tp.pc_start, tp.pc_base, dict(tp.image),
    )


def elf_bytes(name: str) -> bytes:
    with open(os.path.join(FIXTURES, f"{name}.elf"), "rb") as fh:
        return fh.read()


def norm(x):
    """Plain Python values of a record or an event of either package."""
    if isinstance(x, enum.Enum):
        return int(x.value)
    if x is None or isinstance(x, (bool, int, str, float)):
        return x
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, [(f.name, norm(getattr(x, f.name)))
                                   for f in dataclasses.fields(x) if f.name != "program"])
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    raise TypeError(type(x))


def run_both(tp, stdin=(), shard_size=1 << 20):
    jex = JExecutor(ref_program(tp), shard_size=shard_size)
    tex = Executor(tp, shard_size=shard_size)
    for buf in stdin:
        jex.write_stdin(buf)
        tex.write_stdin(buf)
    return jex, jex.run(), tex, tex.run()


def assert_runs_equal(jex, jrecs, tex, trecs):
    assert len(trecs) == len(jrecs)
    for t, j in zip(trecs, jrecs):
        nt, nj = norm(t), norm(j)
        for (name, tv), (jname, jv) in zip(nt[1], nj[1]):
            assert name == jname and tv == jv, f"record field {name}, shard {j.shard}"
    for name in ("global_clk", "exit_code", "committed_value_digest", "deferred_proofs_digest",
                 "cycle_tracker"):
        assert getattr(tex, name) == getattr(jex, name), name
    assert bytes(tex.stdout) == bytes(jex.stdout)
    assert bytes(tex.public_values_stream) == bytes(jex.public_values_stream)
    assert norm(tex.report_syscall_counts) == norm(jex.report_syscall_counts)
    assert norm(tex.report_opcode_counts) == norm(jex.report_opcode_counts)


def io_body():
    """Two hints read from stdin, a stdout write, public values through the
    public-values fd, and a COMMIT."""
    body = []
    for addr in (0x3000, 0x3100):
        body += [*asm.li(R.V0, int(C.SYSHINTLEN)), asm.syscall()]
        body += guests.call(C.SYSHINTREAD, addr, 4)
    body += guests.store(0x3200, [int.from_bytes(b"hi!\n", "little")])
    body += [*asm.li(R.A2, 4), *guests.call(C.WRITE, 1, 0x3200)]
    body += [*asm.li(R.A2, 8), *guests.call(C.WRITE, 3, 0x3000)]
    body += guests.call(C.COMMIT, 2, 0xCAFEF00D)
    return body


def hook_body():
    """An ecrecover request written to the hook fd, then its three response
    vectors read back through the hint syscalls."""
    r, p = guests.K1_GX, cv.SECP256K1.p
    alpha = (r * r * r + 7) % p
    req = bytes([1 | 0x80]) + r.to_bytes(32, "big") + alpha.to_bytes(32, "big") + bytes(3)
    body = guests.store(0x2000, [int.from_bytes(req[i:i + 4], "little") for i in range(0, len(req), 4)])
    body += [*asm.li(R.A2, 65), *guests.call(C.WRITE, hooks.FD_ECRECOVER_HOOK, 0x2000)]
    body += [*asm.li(R.V0, int(C.SYSHINTLEN)), asm.syscall()]
    for ptr, n in ((0x3000, 1), (0x3100, 32), (0x3200, 32)):
        body += guests.call(C.SYSHINTREAD, ptr, n)
    return body


def uint256_body():
    x, y, m256 = (1 << 255) - 19, 0xDEADBEEF << 200, (1 << 251) - 9
    body = guests.store(0x4000, cv.int_to_words(x, 8))
    body += guests.store(0x4100, cv.int_to_words(y, 8) + cv.int_to_words(m256, 8))
    body += guests.call(C.UINT256_MUL, 0x4000, 0x4100)
    return body + guests.u256x2048_body()


GUESTS = {
    "all_ops": (guests.all_ops_body, ()),
    "sha": (guests.sha_body, ()),
    "keccak": (guests.keccak_body, ()),
    "poseidon2": (guests.poseidon2_body, ()),
    "secp256k1": (lambda: guests.wei_body(*guests.WEI_CURVES["secp256k1"]), ()),
    "uint256": (uint256_body, ()),
    "io": (io_body, IO_STDIN),
    "hook": (hook_body, ()),
    "linux": (guests.linux_body, ()),
}


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_interpreter_records_equal_the_reference(guest):
    body_fn, stdin = GUESTS[guest]
    assert_runs_equal(*run_both(guests.program(body_fn()), stdin))


@pytest.mark.parametrize("shard_size", [32, 256])
def test_shard_splits_equal_the_reference(shard_size):
    jex, jrecs, tex, trecs = run_both(guests.every_chip_program(), shard_size=shard_size)
    assert len(trecs) > 2
    assert_runs_equal(jex, jrecs, tex, trecs)


def test_every_chip_guest_records_equal_the_reference():
    jex, jrecs, tex, trecs = run_both(guests.every_chip_program())
    assert_runs_equal(jex, jrecs, tex, trecs)
    families = {k for r in trecs for k, v in r.precompile_events.items() if v}
    assert {"sha_extend", "sha_compress", "keccak_sponge", "poseidon2", "sys_linux"} <= families


def test_hook_guest_reads_the_recovered_point():
    _, _, tex, _ = run_both(guests.program(hook_body()))
    assert tex.word(0x3000) & 0xFF == 1  # status: recovered
    y = int.from_bytes(b"".join(tex.word(0x3100 + 4 * i).to_bytes(4, "little") for i in range(8)), "big")
    r, p = guests.K1_GX, cv.SECP256K1.p
    assert y * y % p == (r ** 3 + 7) % p


@pytest.mark.parametrize("name", ELF_NAMES)
def test_fixture_elf_loads_and_runs_as_in_the_reference(name):
    data = elf_bytes(name)
    tp, jp = Program.from_elf(data), JProgram.from_elf(data)
    assert (tp.pc_start, tp.pc_base, tp.image) == (jp.pc_start, jp.pc_base, jp.image)
    assert [(int(a.opcode), a.op_a, a.op_b, a.op_c, a.imm_b, a.imm_c, a.raw) for a in tp.instructions] == \
        [(int(b.opcode), b.op_a, b.op_b, b.op_c, b.imm_b, b.imm_c, b.raw) for b in jp.instructions]
    stdin = IO_STDIN if name == "io_hints_commit" else ()
    jex, jrecs, tex, trecs = run_both(tp, stdin)
    assert tex.global_clk > 40 and tex.exit_code == 0
    assert_runs_equal(jex, jrecs, tex, trecs)


def test_fixture_elfs_cover_the_precompile_families():
    seen = set()
    for name in ELF_NAMES:
        ex = Executor(Program.from_elf(elf_bytes(name)))
        for buf in IO_STDIN if name == "io_hints_commit" else ():
            ex.write_stdin(buf)
        ex.run()
        seen |= set(ex.report_syscall_counts)
    for fam in (C.SHA_EXTEND, C.SHA_COMPRESS, C.KECCAK_SPONGE, C.SECP256K1_ADD,
                C.SECP256K1_DOUBLE, C.UINT256_MUL, C.SYSHINTREAD, C.COMMIT):
        assert int(fam) in seen, fam


def test_chip_costs_equal_the_reference():
    assert cost.chip_costs(1) == jcost.chip_costs(1)
    assert len(cost.chip_costs(1)) == 49


@pytest.mark.parametrize("name", ["fp_sqrt", "fp_inverse", "bls12_381_sqrt", "bls12_381_inverse"])
def test_hooks_equal_the_reference(name):
    p_bn, p_bls = cv.BN254.p, cv.BLS12381.p
    x = 0x1234567890ABCDEF
    bufs = {
        "fp_sqrt": [(32).to_bytes(4, "big") + (x * x % p_bn).to_bytes(32, "big")
                    + p_bn.to_bytes(32, "big") + (5).to_bytes(32, "big")],
        "fp_inverse": [(32).to_bytes(4, "big") + x.to_bytes(32, "big") + p_bn.to_bytes(32, "big")],
        "bls12_381_sqrt": [(x * x % p_bls).to_bytes(48, "big"), (2 * x * x % p_bls).to_bytes(48, "big")],
        "bls12_381_inverse": [x.to_bytes(48, "big")],
    }[name]
    for buf in bufs:
        assert getattr(hooks, f"hook_{name}")(None, buf) == getattr(jhooks, f"hook_{name}")(None, buf)


native = pytest.mark.skipif(not native_trace.available(), reason="no C toolchain")


@native
def test_execute_for_proving_routes_precompile_guests_to_the_interpreter():
    tp = guests.program(guests.keccak_body() + guests.sha_body(0x8000, 0x9000))
    records, info = execute_for_proving(tp, shard_size=64)
    assert info["executor"] == "interpreter"
    jex = JExecutor(ref_program(tp), shard_size=64)
    jrecs = jex.run()
    assert len(records) == len(jrecs) > 1
    for t, j in zip(records, jrecs):
        assert norm(t) == norm(j)
    assert info["global_clk"] == jex.global_clk and info["digest"] == jex.committed_value_digest


@native
def test_execute_for_proving_runs_plain_guests_natively():
    from test_torch_executor import PORT_SIDE, fib_body

    tp = asm.prog(fib_body(PORT_SIDE, 30) + asm.halt_sequence())
    records, info = execute_for_proving(tp)
    assert info["executor"] == "native"
    (ref,) = JExecutor(ref_program(tp)).run()
    from zkmips_tpu.executor.columnar import cpu_struct as jcpu_struct
    from zkmips_tpu_torch.executor.columnar import CPU_DTYPE, cpu_struct

    cols, ref_cols = cpu_struct(records[0]), jcpu_struct(ref)
    assert all(np.array_equal(cols[n], ref_cols[n]) for n in CPU_DTYPE.names)
    # a non-empty proof stream goes to the interpreter
    _, info = execute_for_proving(tp, proof_stream=[("proof", "vk")])
    assert info["executor"] == "interpreter"


def test_only_native_unsupported_routes_to_the_interpreter(monkeypatch):
    tp = guests.program(guests.keccak_body())

    def unsupported(*a, **k):
        raise NativeUnsupported("guest needs the Python trace executor")

    def broken(*a, **k):
        raise OSError("cc failed")

    monkeypatch.setattr(native_trace, "run_trace", unsupported)
    assert execute_for_proving(tp)[1]["executor"] == "interpreter"
    monkeypatch.setattr(native_trace, "run_trace", broken)
    with pytest.raises(OSError, match="cc failed"):
        execute_for_proving(tp)


def test_interpreter_max_cycles_raises():
    tp = guests.keccak_chain_program(50)
    with pytest.raises(ExecutionError):
        Executor(tp).run(100)


def test_keccak_chain_program_is_the_benchmarks():
    """``guests.keccak_chain_program`` (the full-machine phase of
    ``chip_smoke.py``) is ``bench.py``'s keccak-chain guest, instruction for
    instruction."""
    from bench import _keccak_chain_program

    ref, port = _keccak_chain_program(9), guests.keccak_chain_program(9)
    assert [(int(i.opcode), i.op_a, i.op_b, i.op_c, i.imm_b, i.imm_c) for i in port.instructions] == \
        [(int(i.opcode), i.op_a, i.op_b, i.op_c, i.imm_b, i.imm_c) for i in ref.instructions]
    assert (port.pc_start, port.pc_base, port.image) == (ref.pc_start, ref.pc_base, ref.image)
