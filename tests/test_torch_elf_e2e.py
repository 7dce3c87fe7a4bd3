"""A compiled guest end to end: ``tests/fixtures/guests/sha256_chain.elf``
loaded by each package's ``Program.from_elf``, run by its own interpreter,
proved on the full machine by the port on the CPU and by the reference's
numpy prover, at ``StarkConfig.test()``.

The proofs are integer data and must be equal bit for bit (tolerance 0),
field by field and in ``encode_core_proof`` bytes; each package's verifier
accepts both.
"""

import pytest

from zkmips_tpu.executor import Executor as JExecutor
from zkmips_tpu.executor.program import Program as JProgram
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.stark import machine as jmachine
from zkmips_tpu.stark import pcs as jpcs

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import Program, execute_for_proving
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.stark.machine import StarkConfig

from test_torch_interpreter import elf_bytes
from test_torch_stark import _assert_same


@pytest.fixture(scope="module")
def run():
    data = elf_bytes("sha256_chain")
    jp, tp = JProgram.from_elf(data), Program.from_elf(data)
    jrecords = JExecutor(jp).run()
    trecords, info = execute_for_proving(tp)
    jm = j_mips_machine(jmachine.StarkConfig.test())
    tm = mips_machine(StarkConfig.test())
    jpk, tpk = jm.setup(jp), tm.setup(tp, device="cpu")
    return {"jm": jm, "tm": tm, "jp": jp, "tp": tp, "jpk": jpk, "tpk": tpk, "info": info,
            "jproofs": jm.prove(jpk, jrecords, device=False, workers=1),
            "tproofs": tm.prove(tpk, trecords, device="cpu")}


def _to_reference(proofs):
    return [convert.shard_proof_to_reference(p, jmachine, jpcs) for p in proofs]


def test_sha256_chain_proofs_equal_the_reference(run):
    assert run["info"]["executor"] == "interpreter"
    assert len(run["tproofs"]) == len(run["jproofs"])
    chips = {n for p in run["tproofs"] for n in p.chip_names}
    assert {"ShaExtend", "ShaCompress", "MemoryInstrs"} <= chips
    for i, (got, ref) in enumerate(zip(_to_reference(run["tproofs"]), run["jproofs"])):
        _assert_same(got, ref, f"proof[{i}]")


def test_sha256_chain_encoded_bytes_equal_the_reference(run):
    from zkmips_tpu.verifier import stark_codec

    assert stark_codec.encode_core_proof(_to_reference(run["tproofs"])) == \
        stark_codec.encode_core_proof(run["jproofs"])


def test_sha256_chain_both_verifiers_accept(run):
    assert run["tm"].verify(run["tpk"].vk, run["tproofs"], run["tp"])
    assert run["jm"].verify(run["jpk"].vk, _to_reference(run["tproofs"]), run["jp"])
