"""The port's example programs (``zkmips_tpu_torch/examples/``) against the
reference's (``examples/*.py``), on the CPU.

(a) Each guest function makes the reference's program (the same instruction
words, memory image and ``pc_start``), and each example's ``main`` hands
its prover the same program, stdin and options as the reference's ``main``
(both captured at the client or executor they call); (b) each example's
execution by the port equals the reference ``Executor``'s: ``global_clk``,
exit code, public values, committed digest, cycle tracker, registers and
the memory words the example reads.  Without a card and without ``--cpu``
every example raises.  The proofs of ``fibonacci`` and ``io`` are held
against the reference's in ``test_torch_examples_prove.py``; the other
examples prove on the CPU only under ``-m slow`` (on the card they run
through ``chip_smoke.py``).
"""

import importlib
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zkmips_tpu import guest as jguest
from zkmips_tpu.executor import Executor as JExecutor, execute_for_proving as j_execute_for_proving
from zkmips_tpu.executor.program import Program as JProgram
from zkmips_tpu.ops import field as jf

from zkmips_tpu_torch import guest
from zkmips_tpu_torch.examples import LADDER, QUICK
from zkmips_tpu_torch.executor import Executor, Program, execute_for_proving
from zkmips_tpu_torch.recursion.verifier import rolling_deferred_digest

from test_torch_interpreter import ref_program

ROOT = Path(__file__).resolve().parents[1]
FIXTURE_ELF = ROOT / "tests" / "fixtures" / "guests" / "memory_sweep.elf"
P = 0x7F000001


def ref_example(name: str):
    """The reference's ``examples/<name>.py`` as a module (its directory on
    the path while it loads, for its ``from _common import ...``)."""
    key = f"_reference_example_{name}"
    if key not in sys.modules:
        sys.path.insert(0, str(ROOT / "examples"))
        try:
            spec = importlib.util.spec_from_file_location(key, ROOT / "examples" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        finally:
            sys.path.remove(str(ROOT / "examples"))
        sys.modules[key] = mod
    return sys.modules[key]


def port_example(name: str):
    return importlib.import_module(f"zkmips_tpu_torch.examples.{name}")


def program_key(program, encode) -> tuple:
    """Instruction fields and words, ``pc_start``, ``pc_base`` and image."""
    fields = [(int(i.opcode), i.op_a, i.op_b, i.op_c, bool(i.imm_b), bool(i.imm_c)) for i in program.instructions]
    words = [encode(i) for i in program.instructions]
    return fields, words, program.pc_start, program.pc_base, dict(program.image)


def same_program(port_program, ref_program_):
    assert program_key(port_program, guest.encode_instruction) == \
        program_key(ref_program_, jguest.encode_instruction)


# --- (a) the guest functions --------------------------------------------------------------

def _guests(seed: int) -> dict:
    """name -> (port program, reference program), seeded inputs where a guest function takes any."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
    msg = rng.integers(0, 256, size=int(rng.integers(0, 56)), dtype=np.uint8).tobytes()
    vals = rng.integers(0, P, size=16).tolist()
    pairs = {
        "fibonacci": ("fibonacci", "fibonacci_guest", ()),
        "io": ("io", "adder_guest", ()),
        "is_prime": ("is_prime", "is_prime_guest", ()),
        "large_sum": ("large_sum", "large_sum_guest", ()),
        "sha256_precompile": ("sha256_precompile", "sha256_guest", (msg,)),
        "keccak_precompile": ("keccak_precompile", "keccak_guest", (data,)),
        "poseidon2_precompile": ("poseidon2_precompile", "poseidon2_guest", (vals,)),
        "uint256_mul": ("uint256_mul", "uint256_guest", ()),
        "cycle_tracking": ("cycle_tracking", "tracked_guest", ()),
    }
    return {k: (getattr(port_example(m), fn)(*a), getattr(ref_example(m), fn)(*a))
            for k, (m, fn, a) in pairs.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["fibonacci", "io", "is_prime", "large_sum", "sha256_precompile",
                                  "keccak_precompile", "poseidon2_precompile", "uint256_mul",
                                  "cycle_tracking"])
def test_guest_equals_the_reference(name, seed):
    port, ref = _guests(seed)[name]
    same_program(port, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keccak_cross_check_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
    assert port_example("keccak_precompile")._keccak256(data) == ref_example("keccak_precompile")._keccak256(data)


class _Stop(Exception):
    """Stops an example's ``main`` at the call that received its program."""


class _Client:
    """Stands for the example's ``ProverClient``: records the program,
    stdin and options of each call, and stops ``main`` at ``prove``."""

    def __init__(self):
        self.calls = []
        self.machine = None

    def execute(self, program, stdin=None, **_kw):
        self.calls.append(("execute", program, stdin, {}))
        return SimpleNamespace(total_instruction_count=0, syscall_counts={}, cycle_tracker={"busy-loop": 0})

    def setup(self, program):
        self.calls.append(("setup", program, None, {}))
        return None, None

    def prove(self, pk, program, stdin=None, **kw):
        self.calls.append(("prove", program, stdin, kw))
        raise _Stop


def _client_calls(mod, monkeypatch) -> list:
    client = _Client()
    monkeypatch.setattr(mod, "client_from_args",
                        lambda *a, **kw: (client, SimpleNamespace(sound=False, cpu=True, device="cpu")))
    if hasattr(mod, "timed"):
        monkeypatch.setattr(mod, "timed", lambda _label, fn, *a, **kw: fn(*a, **kw))
    try:
        mod.main() if mod.__name__.startswith("_reference") else mod.main([])
    except _Stop:
        pass
    return client.calls


def _bufs(stdin) -> list:
    return [bytes(b) for b in stdin.buffers] if stdin is not None else []


CLIENT_EXAMPLES = ["fibonacci", "io", "is_prime", "large_sum", "sha256_precompile", "keccak_precompile",
                   "poseidon2_precompile", "uint256_mul", "cycle_tracking", "compressed", "groth16", "plonk"]


@pytest.mark.parametrize("name", CLIENT_EXAMPLES)
def test_main_hands_its_client_the_reference_programs(name, monkeypatch):
    """What each example's ``main`` asks its client to run: the same calls,
    programs, stdin and options (shard size, mode) as the reference's."""
    port_calls = _client_calls(port_example(name), monkeypatch)
    ref_calls = _client_calls(ref_example(name), monkeypatch)
    assert [c[0] for c in port_calls] == [c[0] for c in ref_calls] and port_calls
    for (_, prog, stdin, kw), (_, jprog, jstdin, jkw) in zip(port_calls, ref_calls):
        same_program(prog, jprog)
        assert _bufs(stdin) == _bufs(jstdin) and kw == jkw


class _ExecutorStop:
    """Stands for an example's ``Executor`` (or ``write_elf``): records the
    program of each call; the ``stop_at``-th call stops ``main``."""

    def __init__(self, stop_at: int):
        self.programs, self.stop_at = [], stop_at

    def __call__(self, program, *_a, **_kw):
        self.programs.append(program)
        if len(self.programs) == self.stop_at:
            raise _Stop
        return SimpleNamespace(run=lambda: [], proof_stream=[], subproof_verifier=None)


def _executor_programs(mod, monkeypatch, attr: str, stop_at: int, machine=None, prover=None) -> list:
    args = SimpleNamespace(sound=False, cpu=True, device="cpu")
    monkeypatch.setattr(mod, "client_from_args", lambda *a, **kw: (SimpleNamespace(machine=machine), args))
    if prover is not None:
        monkeypatch.setattr(mod, "RecursionProver", prover)
        monkeypatch.setattr(mod, "timed", lambda _label, fn, *a, **kw: fn(*a, **kw))
    stop = _ExecutorStop(stop_at)
    monkeypatch.setattr(mod, attr, stop)
    with pytest.raises(_Stop):
        mod.main() if mod.__name__.startswith("_reference") else mod.main([])
    return stop.programs


@pytest.mark.parametrize("name,attr", [("unconstrained", "Executor"), ("elf_build", "write_elf")])
def test_inline_guests_equal_the_reference(name, attr, monkeypatch):
    """The guests the reference builds inside ``main``: the port's guest
    function makes the program the reference's ``main`` executes (or writes as an
    ELF), and its own ``main`` uses it."""
    make = {"unconstrained": "unconstrained_guest", "elf_build": "elf_build_guest"}[name]
    (ref,) = _executor_programs(ref_example(name), monkeypatch, attr, 1)
    (port,) = _executor_programs(port_example(name), monkeypatch, attr, 1)
    same_program(getattr(port_example(name), make)(), ref)
    same_program(port, ref)
    if name == "elf_build":
        assert guest.write_elf(port) == jguest.write_elf(ref)


def _aggregation_stubs(seed: int):
    """A machine and recursion prover that stand for the real ones in the
    aggregation example, with guest A's compressed proof made of seeded
    words: what guest B is built from."""
    rng = np.random.default_rng(seed)
    prep_root = jf.to_monty(rng.integers(0, P, size=8, dtype=np.uint32))
    public_values = rng.integers(0, P, size=int(rng.integers(8, 60))).tolist()

    class Prover:
        def __init__(self, _machine):
            pass

        def compress(self, *_a, **_kw):
            return SimpleNamespace(proof=SimpleNamespace(public_values=public_values))

        def _find_final_vk(self, _cp):
            return SimpleNamespace(prep_root=prep_root)

    machine = SimpleNamespace(setup=lambda *a, **kw: SimpleNamespace(vk=None), prove=lambda *a, **kw: [])
    return machine, Prover, prep_root, public_values


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregation_guests_equal_the_reference(seed, monkeypatch):
    """Guest A, and guest B as each ``main`` builds it from A's compressed
    proof (vk root, public values, deferred chain)."""
    machine, prover, prep_root, pv = _aggregation_stubs(seed)
    ref_a, ref_b = _executor_programs(ref_example("aggregation"), monkeypatch, "Executor", 2, machine, prover)
    port_a, port_b = _executor_programs(port_example("aggregation"), monkeypatch, "Executor", 2, machine, prover)
    same_program(port_a, ref_a)
    same_program(port_b, ref_b)
    mod = port_example("aggregation")
    same_program(mod.guest_a(), ref_a)
    vk_root = [int(x) for x in jf.from_monty(prep_root)]
    same_program(mod.guest_b(vk_root, pv, rolling_deferred_digest([0] * 8, vk_root, pv)), ref_b)


# --- (b) executions ------------------------------------------------------------------

def _stdin(*words) -> list:
    return [int(w).to_bytes(4, "little") for w in words]


def _executions() -> dict:
    """name -> (port program, reference program, stdin buffers, shard size,
    the memory words the example reads)."""
    b = _guests(0)
    mods = {n: port_example(n) for n in ("sha256_precompile", "keccak_precompile", "poseidon2_precompile")}
    specific = {
        "sha256_precompile": (mods["sha256_precompile"].sha256_guest(mods["sha256_precompile"].MSG),
                              ref_example("sha256_precompile").sha256_guest(b"zkMIPS on TPU")),
        "keccak_precompile": (mods["keccak_precompile"].keccak_guest(mods["keccak_precompile"].DATA),
                              ref_example("keccak_precompile").keccak_guest(
                                  b"The quick brown fox jumps over the lazy dog")),
        "poseidon2_precompile": (mods["poseidon2_precompile"].poseidon2_guest(mods["poseidon2_precompile"].VALS),
                                 ref_example("poseidon2_precompile").poseidon2_guest([i * 7 + 1 for i in range(16)])),
    }
    big = 1 << 20
    out = {
        "fibonacci": (*b["fibonacci"], _stdin(1000), big, []),
        "io": (*b["io"], _stdin(1000, 58), big, []),
        "is_prime_10007": (*b["is_prime"], _stdin(10007), big, []),
        "is_prime_10001": (*b["is_prime"], _stdin(10001), big, []),
        "large_sum": (*b["large_sum"], [], big, []),
        "sha256_precompile": (*specific["sha256_precompile"], [], big, [0x3000 + 4 * i for i in range(8)]),
        "keccak_precompile": (*specific["keccak_precompile"], [], big, [0x3000 + 4 * i for i in range(8)]),
        "poseidon2_precompile": (*specific["poseidon2_precompile"], [], big, [0x2000 + 4 * i for i in range(16)]),
        "uint256_mul": (*b["uint256_mul"], [], big, [0x2000 + 4 * i for i in range(8)]),
        "cycle_tracking": (*b["cycle_tracking"], [], big, []),
        "compressed": (*b["fibonacci"], _stdin(120), 1 << 9, []),
        "groth16_plonk": (*b["fibonacci"], _stdin(50), 1 << 11, []),
    }
    un, el = port_example("unconstrained").unconstrained_guest(), port_example("elf_build").elf_build_guest()
    out["unconstrained"] = (un, ref_program(un), [], big, [])
    elf = guest.write_elf(el)
    out["elf_build"] = (Program.from_elf(elf), JProgram.from_elf(jguest.write_elf(ref_program(el))), [], big, [])
    data = FIXTURE_ELF.read_bytes()
    out["real_guest_fixture"] = (Program.from_elf(data), JProgram.from_elf(data), [], big, [])
    a = port_example("aggregation").guest_a()
    out["aggregation_a"] = (a, ref_program(a), [], big, [])
    return out


EXECUTIONS = ["fibonacci", "io", "is_prime_10007", "is_prime_10001", "large_sum", "sha256_precompile",
              "keccak_precompile", "poseidon2_precompile", "uint256_mul", "cycle_tracking", "compressed",
              "groth16_plonk", "unconstrained", "elf_build", "real_guest_fixture", "aggregation_a",
              "aggregation_b"]


def _state(ex, words) -> dict:
    return {
        "global_clk": ex.global_clk, "exit_code": ex.exit_code,
        "public_values": bytes(ex.public_values_stream),
        "digest": [int(w) for w in ex.committed_value_digest],
        "cycle_tracker": dict(ex.cycle_tracker), "stdout": bytes(ex.stdout),
        "registers": [ex.register(r) for r in range(32)],
        "words": [ex.word(a) for a in words],
    }


def _run(cls, program, stdin, shard_size, proofs=()):
    ex = cls(program, shard_size=shard_size)
    for buf in stdin:
        ex.write_stdin(buf)
    if proofs:
        ex.proof_stream.extend(proofs)
        ex.subproof_verifier = lambda *_a: None
    records = ex.run()
    return ex, len(records)


@pytest.mark.parametrize("name", EXECUTIONS)
def test_execution_equals_the_reference(name):
    proofs = ()
    if name == "aggregation_b":
        _m, _p, prep_root, pv = _aggregation_stubs(3)
        vk_root = [int(x) for x in jf.from_monty(prep_root)]
        chain = rolling_deferred_digest([0] * 8, vk_root, pv)
        prog = port_example("aggregation").guest_b(vk_root, pv, chain)
        jprog, stdin, shard, words = ref_program(prog), [], 1 << 20, [0x2000 + 4 * i for i in range(8)]
        proofs = [("proof", "vk")]
    else:
        prog, jprog, stdin, shard, words = _executions()[name]
    ex, n = _run(Executor, prog, stdin, shard, proofs)
    jex, jn = _run(JExecutor, jprog, stdin, shard, proofs)
    assert _state(ex, words) == _state(jex, words) and n == jn
    if name == "cycle_tracking":
        assert ex.cycle_tracker["busy-loop"] > 100
    if name == "unconstrained":
        assert ex.register(16) == 42  # $s0, the unconstrained writes rolled back
    if name == "aggregation_b":
        assert ex.record.deferred_proof_digests == jex.record.deferred_proof_digests != []
    if not proofs:
        # the path the examples' provers take: the native executor where it can
        records, info = execute_for_proving(prog, stdin_bufs=stdin, shard_size=shard)
        jrecords, jinfo = j_execute_for_proving(jprog, stdin_bufs=stdin, shard_size=shard)
        assert len(records) == len(jrecords) == n
        for key in ("global_clk", "exit_code", "public_values", "digest"):
            assert info[key] == jinfo[key], key


# --- devices --------------------------------------------------------------------------

@pytest.mark.parametrize("name", QUICK + LADDER)
def test_example_raises_without_a_gpu_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_example(name).main([])


def test_chip_smoke_runs_every_example():
    spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.QUICK_EXAMPLES == QUICK
    assert chip_smoke.EXAMPLES == QUICK + LADDER


def test_examples_share_a_client_per_config_and_device():
    from zkmips_tpu_torch.examples import _common

    a, args = _common.client_from_args("", ["--cpu"])
    b, _ = _common.client_from_args("", ["--cpu"])
    c, _ = _common.client_from_args("", ["--cpu", "--sound"])
    assert a is b and a is not c and str(args.device) == "cpu"
    assert a.machine.machine.config.fri.num_queries < c.machine.machine.config.fri.num_queries


def test_real_guest_without_its_elf_has_nothing_to_do(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the default path is relative to a checkout of the upstream project
    mod = port_example("real_guest")
    assert mod.main(["--cpu"]) == {"elf": mod.ELF, "present": False}
    assert mod.main(["--cpu", "--elf", str(tmp_path / "none.elf")])["present"] is False
    assert "nothing to do" in capsys.readouterr().out


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in QUICK if n not in ("fibonacci", "io")]
                         + ["compressed", "aggregation", "groth16", "plonk"])
def test_example_runs_on_the_cpu(name):
    """Each example on the CPU with its own assertions (``real_guest`` on a
    fixture ELF).  ``plonk`` at the test config needs about 80 GiB of host
    memory."""
    argv = ["--cpu"] + (["--elf", str(FIXTURE_ELF)] if name == "real_guest" else [])
    out = port_example(name).main(argv)
    assert isinstance(out, dict) and out
