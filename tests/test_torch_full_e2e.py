"""End to end on the full machine: guests that need the 49-chip machine and
the Python interpreter, proved by the port's ``MipsMachine`` on the CPU and
by the reference package's numpy prover.

Proofs are integer data and must be equal bit for bit (tolerance 0): every
field through ``convert.shard_proof_to_numpy``, the ``encode_core_proof``
bytes, and acceptance by the reference's own ``MipsMachine.verify``.  All at
``StarkConfig.test()``; each package runs its own interpreter.
"""

import copy
from pathlib import Path

import pytest

from zkmips_tpu.executor import Executor as JExecutor
from zkmips_tpu.executor.program import Program as JProgram
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.stark import machine as jmachine
from zkmips_tpu.stark import pcs as jpcs

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import Program as TProgram, execute_for_proving, guests
from zkmips_tpu_torch.machine import machine as tmachine
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError

from test_torch_interpreter import ref_program
from test_torch_stark import _assert_same

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "guests"

GUESTS = {
    # every opcode, and the sha and keccak precompiles: KeccakSponge (3475
    # columns), ShaExtend, ShaCompress, SyscallCore/Precompile, MemoryInstrs
    "ops_sha_keccak": lambda: guests.all_ops_body() + guests.sha_body(0x8000, 0x9000)
    + guests.keccak_body(0xA000, 0xB000),
}


CHIPS = {
    "ops_sha_keccak": {"KeccakSponge", "ShaExtend", "ShaCompress", "MemoryInstrs", "DivRem",
                       "MiscInstrs", "MovCond", "SyscallCore", "SyscallPrecompile"},
}


def prove_both(body):
    """The guest ``body`` executed and proved by both packages."""
    tp = guests.program(body)
    jp = ref_program(tp)
    jrecords = JExecutor(jp).run()
    trecords, info = execute_for_proving(tp)
    assert info["executor"] == "interpreter"
    jm = j_mips_machine(jmachine.StarkConfig.test())
    tm = mips_machine(StarkConfig.test())
    jpk = jm.setup(jp)
    tpk = tm.setup(tp, device="cpu")
    jproofs = jm.prove(jpk, jrecords, device=False, workers=1)
    tproofs = tm.prove(tpk, trecords, device="cpu")
    return {"jm": jm, "tm": tm, "jp": jp, "tp": tp, "jpk": jpk, "tpk": tpk,
            "jproofs": jproofs, "tproofs": tproofs}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = prove_both(GUESTS[name]())
        return cache[name]

    return get


def to_reference(proofs):
    return [convert.shard_proof_to_reference(p, jmachine, jpcs) for p in proofs]


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_proofs_equal_the_reference_field_by_field(runs, guest):
    r = runs(guest)
    assert len(r["tproofs"]) == len(r["jproofs"])
    for i, (got, ref) in enumerate(zip(to_reference(r["tproofs"]), r["jproofs"])):
        _assert_same(got, ref, f"proof[{i}]")


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_encoded_bytes_equal_the_reference(runs, guest):
    from zkmips_tpu.verifier import stark_codec

    r = runs(guest)
    assert stark_codec.encode_core_proof(to_reference(r["tproofs"])) == \
        stark_codec.encode_core_proof(r["jproofs"])


def test_reference_verifier_accepts_the_ports_proofs(runs):
    r = runs("ops_sha_keccak")
    assert r["jm"].verify(r["jpk"].vk, to_reference(r["tproofs"]), r["jp"])


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_port_verifier_accepts(runs, guest):
    r = runs(guest)
    assert r["tm"].verify(r["tpk"].vk, r["tproofs"], r["tp"])


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_the_guests_reach_the_wide_chips(runs, guest):
    chips = {n for p in runs(guest)["tproofs"] for n in p.chip_names}
    assert CHIPS[guest] <= chips


def test_tampered_keccak_opening_rejected(runs):
    r = runs("ops_sha_keccak")
    proofs = copy.deepcopy(r["tproofs"])
    (i,) = [k for k, p in enumerate(proofs) if "KeccakSponge" in p.chip_names]
    ov = proofs[i].opened[proofs[i].chip_names.index("KeccakSponge")]
    ov.main_local[0] ^= 1
    with pytest.raises(VerificationError):
        r["tm"].verify(r["tpk"].vk, proofs, r["tp"])


@pytest.mark.gpu
def test_card_proofs_equal_the_reference(runs):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    r = runs("ops_sha_keccak")
    records, _ = execute_for_proving(r["tp"])
    pk = r["tm"].setup(r["tp"])
    for got, ref in zip(to_reference(r["tm"].prove(pk, records)), r["jproofs"]):
        _assert_same(got, ref)


def test_prove_program_defaults_to_the_full_machine(monkeypatch):
    """``prove_program`` builds ``MipsMachine(config)``, the 49 chips, as the
    reference does; setup and prove are stubbed, so no proof is made."""
    seen = []
    monkeypatch.setattr(tmachine.MipsMachine, "setup", lambda self, program, device=None: seen.append(self))
    monkeypatch.setattr(tmachine.MipsMachine, "prove", lambda self, pk, records, device=None: [])
    tp = guests.program(guests.keccak_body())
    m, _pk, proofs, info = tmachine.prove_program(tp, config=StarkConfig.test(), device="cpu")
    assert seen == [m] and len(m.airs) == 49 and proofs == []
    assert info["executor"] == "interpreter"
    # the fourth value reads as the reference's Executor, whichever executor ran
    stdin = [(0x12345678).to_bytes(4, "little"), (0x0F0F0F0F).to_bytes(4, "little")]
    elf = (FIXTURES / "io_hints_commit.elf").read_bytes()
    for prog, ref, bufs, executor in ((tp, ref_program(tp), (), "interpreter"),
                                      (TProgram.from_elf(elf), JProgram.from_elf(elf), stdin, "native")):
        *_, info = tmachine.prove_program(prog, stdin=bufs, config=StarkConfig.test(), device="cpu")
        ex = JExecutor(ref)
        for buf in bufs:
            ex.write_stdin(buf)
        ex.run()
        assert info["executor"] == executor
        assert info.stdout == bytes(ex.stdout)
        assert info.public_values_stream == bytes(ex.public_values_stream)
        assert (info.exit_code, info.global_clk) == (ex.exit_code, ex.global_clk)
        assert info.committed_value_digest == list(ex.committed_value_digest)
    assert any(info.committed_value_digest)


def test_full_machine_entry_points_need_a_device_or_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = mips_machine(StarkConfig.test())
    tp = guests.program(guests.keccak_body())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.setup(tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.prove(None, [])
