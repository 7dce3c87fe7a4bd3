"""The port's SDK client (``sdk/client.py``) against the reference's
``zkmips_tpu.sdk``, on the CPU: ``execute`` reports equal to the
reference's (a guest the native executor runs, and a guest whose
cycle-tracker prints send it to the interpreter), mock mode, core-mode
``ProofWithPublicValues`` bytes equal to the reference's on the same guest
(test config), and ``from_bytes`` round trips.  The whole MIPS -> Groth16
and -> PLONK ladders through ``ProverClient(..., device="cpu")`` are
``slow``: the outer circuit of a test-config wrap proof has millions of
constraints."""

import copy
import random

import pytest
import torch

from zkmips_tpu import sdk as jsdk
from zkmips_tpu.sdk import ProverClient as JProverClient, ZKMStdin as JZKMStdin
from zkmips_tpu.stark.machine import StarkConfig as JStarkConfig

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import Opcode, Register, asm
from zkmips_tpu_torch.sdk import ProofWithPublicValues, ProverClient, ZKMStdin
from zkmips_tpu_torch.sdk.client import ExecutionReport
from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError

from test_torch_interpreter import ref_program

R, O = Register, Opcode


def _commit_program():
    """Read a hinted word, add 1, commit it (the reference's SDK test guest)."""
    return asm.prog(
        [
            *asm.li(R.V0, 0xF0), asm.syscall(),  # hint len
            *asm.li(R.V0, 0xF1), *asm.li(R.A0, 0x3000), *asm.li(R.A1, 4), asm.syscall(),
            *asm.li(R.T1, 0x3000), asm.lw(R.T2, R.T1),
            asm.addi(R.T2, R.T2, 1),
            *asm.li(R.V0, 0x10), *asm.li(R.A0, 0),
            asm.alu(O.ADD, R.A1, R.T2, 0, imm_c=True), asm.syscall(),  # commit
        ]
        + asm.halt_sequence()
    )


def _write(text: bytes, at: int) -> list:
    """Store ``text`` at ``at`` and write it to stdout (fd 1)."""
    words = [int.from_bytes(text[i:i + 4].ljust(4, b"\x00"), "little") for i in range(0, len(text), 4)]
    body = [x for i, w in enumerate(words)
            for x in (*asm.li(R.T0, w), *asm.li(R.T1, at + 4 * i), asm.sw(R.T0, R.T1))]
    return body + [*asm.li(R.V0, 2), *asm.li(R.A0, 1), *asm.li(R.A1, at), *asm.li(R.A2, len(text)),
                   asm.syscall()]


def _tracker_program():
    """Prints a cycle-tracker span around a short loop, and a plain line."""
    loop = [*asm.li(R.T3, 7), asm.addi(R.T3, R.T3, -1), asm.branch(O.BNE, R.T3, R.ZERO, -8), asm.nop()]
    return asm.prog(_write(b"cycle-tracker-start: loop", 0x4000) + loop
                    + _write(b"cycle-tracker-end: loop", 0x4100) + _write(b"hello\n", 0x4200)
                    + asm.halt_sequence())


def _stdin(mod):
    s = mod()
    s.write_u32(41)
    return s


def _report_fields(rep) -> dict:
    out = {k: getattr(rep, k) for k in ("total_instruction_count", "exit_code", "stdout", "public_values",
                                        "cycle_tracker", "touched_memory_addresses")}
    out["opcode_counts"] = {getattr(k, "name", k): v for k, v in rep.opcode_counts.items()}
    out["syscall_counts"] = {getattr(k, "name", k): v for k, v in rep.syscall_counts.items()}
    return out


@pytest.mark.parametrize("guest", ["commit", "cycle_tracker"])
def test_execute_reports_equal_the_reference(guest):
    program = _commit_program() if guest == "commit" else _tracker_program()
    rep = ProverClient.mock(device="cpu").execute(program, _stdin(ZKMStdin))
    jrep = JProverClient.mock().execute(ref_program(program), _stdin(JZKMStdin))
    assert isinstance(rep, ExecutionReport)
    assert _report_fields(rep) == _report_fields(jrep)
    if guest == "cycle_tracker":
        assert rep.cycle_tracker["loop"] > 20 and rep.stdout == b"hello\n"
        assert rep.opcode_counts and rep.total_syscall_count() == 4  # three writes and the halt
    else:
        assert rep.opcode_counts == {} and rep.exit_code == 0


def test_mock_mode():
    client = ProverClient.mock(device="cpu")
    program = _commit_program()
    proof = client.prove(None, program, _stdin(ZKMStdin))
    jproof = JProverClient.mock().prove(None, ref_program(program), _stdin(JZKMStdin))
    assert proof.mode == jproof.mode == "mock" and proof.committed_value_digest[0] == 42
    assert client.verify(None, proof, program)
    assert proof.to_bytes() == jproof.to_bytes()
    assert ProofWithPublicValues.from_bytes(proof.to_bytes()).to_bytes() == proof.to_bytes()


@pytest.fixture(scope="module")
def core_proofs():
    """The commit guest proved in core mode at the test config by both
    packages' clients (the reference on its numpy path)."""
    program = _commit_program()
    client = ProverClient(config=StarkConfig.test(), device="cpu")
    pk, vk = client.setup(program)
    proof = client.prove(pk, program, _stdin(ZKMStdin))
    jclient = JProverClient(config=JStarkConfig.test())
    jprogram = ref_program(program)
    jpk, _jvk = jclient.setup(jprogram)
    jproof = jclient.prove(jpk, jprogram, _stdin(JZKMStdin))
    return client, program, vk, proof, jproof


def test_core_bytes_equal_the_reference(core_proofs):
    _client, _program, _vk, proof, jproof = core_proofs
    assert proof.committed_value_digest[0] == 42
    assert proof.config == jproof.config == "test"
    assert proof.to_bytes() == jproof.to_bytes()
    assert convert.proof_with_public_values_to_reference(proof, jsdk).to_bytes() == jproof.to_bytes()


def test_core_bytes_round_trip_and_verify(core_proofs, tmp_path):
    client, program, vk, proof, jproof = core_proofs
    assert client.verify(vk, proof, program)
    path = tmp_path / "proof.bin"
    proof.save(str(path))
    loaded = ProofWithPublicValues.load(str(path))
    assert loaded.to_bytes() == proof.to_bytes() and loaded.size_bytes() == len(proof.to_bytes())
    assert client.verify(vk, loaded, program)
    assert client.verify(vk, convert.proof_with_public_values_to_port(jproof), program)
    bad = bytearray(proof.to_bytes())
    bad[-40] ^= 1
    with pytest.raises(Exception):
        assert client.verify(vk, ProofWithPublicValues.from_bytes(bytes(bad)), program)


def _e2e_fib(iters: int):
    """The guest of the reference's MIPS -> SNARK test (tests/test_groth16_e2e.py)."""
    body = [
        asm.addi(R.A0, 0, iters), asm.addi(R.T0, 0, 0), asm.addi(R.T1, 0, 1),
        asm.alu(O.ADD, R.T2, R.T0, R.T1),
        asm.alu(O.ADD, R.T0, R.T1, R.ZERO),
        asm.alu(O.ADD, R.T1, R.T2, R.ZERO),
        asm.addi(R.A0, R.A0, -1),
        asm.branch(O.BNE, R.A0, R.ZERO, -5 * 4),
        asm.nop(),
    ]
    return asm.prog(body + asm.halt_sequence())


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["groth16", "plonk"])
def test_snark_modes_end_to_end(mode):
    """MIPS -> core -> compress -> shrink -> wrap -> Groth16 / PLONK on the
    CPU (two shards of 128 cycles): verified, through its container bytes,
    and a tampered wrap public value rejected by the record checks."""
    program = _e2e_fib(25)
    client = ProverClient(config=StarkConfig.test(), device="cpu")
    pk, vk = client.setup(program)
    gen = random.Random(7)
    proof = client.prove(pk, program, ZKMStdin(), shard_size=128, mode=mode, rng=lambda n: gen.randrange(n))
    assert proof.mode == mode and proof.proofs[0].num_shards == 2
    assert client.verify(vk, proof, program)
    back = ProofWithPublicValues.from_bytes(proof.to_bytes())
    assert back.to_bytes() == proof.to_bytes() and client.verify(vk, back, program)
    bad = copy.deepcopy(proof)
    bad.proofs[0].wrap_public_values[0] = (bad.proofs[0].wrap_public_values[0] + 1) % 0x7F000001
    with pytest.raises(VerificationError):
        client.verify(vk, bad, program)


@pytest.mark.gpu
def test_card_core_bytes_equal_the_cpus(core_proofs):
    """The client's default device (the card) gives the CPU's core bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _client, program, _vk, proof, _jproof = core_proofs
    client = ProverClient(config=StarkConfig.test())
    pk, _ = client.setup(program)
    assert client.prove(pk, program, _stdin(ZKMStdin)).to_bytes() == proof.to_bytes()
