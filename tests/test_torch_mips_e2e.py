"""End to end: the fib guest executed natively, proved by the port's
``MipsMachine`` on the CPU, and held against the reference package's numpy
prover.

Proofs are integer data and must be equal bit for bit (tolerance 0): every
field through ``convert.shard_proof_to_numpy`` (the global septic digest
included), the ``encode_core_proof`` bytes, and acceptance by the reference's
own ``MipsMachine.verify``.  All at ``StarkConfig.test()``.
"""

import copy

import numpy as np
import pytest
import torch

from zkmips_tpu.executor import execute_for_proving as j_execute_for_proving
from zkmips_tpu.executor import asm as jasm
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.stark import machine as jmachine
from zkmips_tpu.stark import pcs as jpcs

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import asm, execute_for_proving
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.machine.pv import PV_NEXT_PC, PV_START_PC
from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError

from test_torch_executor import JAX_SIDE, PORT_SIDE, fib_body
from test_torch_stark import _assert_same

# name -> (fib iterations, shard size, shards, prover threads of the port)
CASES = {
    "shard16": (2, 16, 2, 2),  # 22 cycles: two shards, proved two at a time
    "shard1k": (168, 1 << 10, 1, 1),  # 1018 cycles: one shard of 2^10 Cpu rows
}


def _prove_both(n_iters, shard_size, workers):
    jp = jasm.prog(fib_body(JAX_SIDE, n_iters) + jasm.halt_sequence())
    tp = asm.prog(fib_body(PORT_SIDE, n_iters) + asm.halt_sequence())
    jrecords, _ = j_execute_for_proving(jp, shard_size=shard_size)
    trecords, _ = execute_for_proving(tp, shard_size=shard_size)
    jm = j_mips_machine(jmachine.StarkConfig.test(), minimal=True)
    tm = mips_machine(StarkConfig.test(), minimal=True)
    jpk = jm.setup(jp)
    tpk = tm.setup(tp, device="cpu")
    jproofs = jm.prove(jpk, jrecords, device=False, workers=1)
    tproofs = tm.prove(tpk, trecords, device="cpu", workers=workers)
    return {"jm": jm, "tm": tm, "jp": jp, "tp": tp, "jpk": jpk, "tpk": tpk,
            "jproofs": jproofs, "tproofs": tproofs, "trecords": trecords}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            n_iters, shard_size, _shards, workers = CASES[name]
            cache[name] = _prove_both(n_iters, shard_size, workers)
        return cache[name]

    return get


def _to_reference(proofs):
    return [convert.shard_proof_to_reference(p, jmachine, jpcs) for p in proofs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_proofs_equal_the_reference_field_by_field(runs, case):
    r = runs(case)
    assert len(r["tproofs"]) == len(r["jproofs"]) == CASES[case][2]
    converted = _to_reference(r["tproofs"])
    for i, (got, ref) in enumerate(zip(converted, r["jproofs"])):
        assert "Global" in got.chip_names
        gs = got.opened[got.chip_names.index("Global")].global_sum
        assert gs is not None and gs.shape == (14,) and gs.dtype == np.uint32
        _assert_same(got, ref, f"proof[{i}]")


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoded_bytes_equal_the_reference(runs, case):
    from zkmips_tpu.verifier import stark_codec

    r = runs(case)
    assert stark_codec.encode_core_proof(_to_reference(r["tproofs"])) == \
        stark_codec.encode_core_proof(r["jproofs"])


def test_reference_verifier_accepts_the_ports_proofs(runs):
    r = runs("shard16")  # two shards: the chain and the digest sum are checked too
    assert r["jm"].verify(r["jpk"].vk, _to_reference(r["tproofs"]), r["jp"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_verifier_accepts(runs, case):
    r = runs(case)
    assert r["tm"].verify(r["tpk"].vk, r["tproofs"], r["tp"])


@pytest.mark.gpu
def test_card_proofs_equal_the_reference(runs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    r = runs("shard16")
    records, _ = execute_for_proving(r["tp"], shard_size=CASES["shard16"][1])
    pk = r["tm"].setup(r["tp"])
    proofs = r["tm"].prove(pk, records)
    assert proofs[0].main_root.device.type == "cpu"  # proofs come back on the host
    for got, ref in zip(_to_reference(proofs), r["jproofs"]):
        _assert_same(got, ref)


def test_heights(runs):
    cpu = lambda p: p.opened[p.chip_names.index("Cpu")].log_degree
    assert cpu(runs("shard1k")["tproofs"][0]) == 10
    # tiny chips are padded to 16 rows and proved like the rest
    first = runs("shard16")["tproofs"][0]
    assert cpu(first) == 4 and min(o.log_degree for o in first.opened) == 4
    assert max(o.log_degree for o in first.opened) == 16  # the Byte table


def test_tampered_global_digest_rejected(runs):
    r = runs("shard16")
    proofs = copy.deepcopy(r["tproofs"])
    ov = proofs[0].opened[proofs[0].chip_names.index("Global")]
    ov.global_sum[0] ^= 1
    with pytest.raises(VerificationError):
        r["tm"].verify(r["tpk"].vk, proofs, r["tp"])
    # the reference's verifier refuses the same proofs
    with pytest.raises(jmachine.VerificationError):
        r["jm"].verify(r["jpk"].vk, _to_reference(proofs), r["jp"])


def test_missing_global_sum_rejected(runs):
    r = runs("shard16")
    proofs = copy.deepcopy(r["tproofs"])
    proofs[0].opened[proofs[0].chip_names.index("Global")].global_sum = None
    with pytest.raises(VerificationError, match="missing global sum"):
        r["tm"].verify(r["tpk"].vk, proofs, r["tp"])


@pytest.mark.parametrize("index,value", [(PV_START_PC, 1234), (PV_NEXT_PC, 1234)])
def test_wrong_exit_pc_rejected(runs, index, value):
    r = runs("shard1k")
    proofs = copy.deepcopy(r["tproofs"])
    proofs[-1].public_values[index] = value  # claim another start / a non-halting next_pc
    with pytest.raises(VerificationError):
        r["tm"].verify(r["tpk"].vk, proofs, r["tp"])


def test_swapped_shards_rejected(runs):
    r = runs("shard16")
    proofs = list(r["tproofs"])
    proofs[0], proofs[1] = proofs[1], proofs[0]
    with pytest.raises(VerificationError, match="shard index"):
        r["tm"].verify(r["tpk"].vk, proofs, r["tp"])


def test_reproving_a_record_gives_the_same_proof(runs):
    """``generate_dependencies`` runs once per record and ``prove_record``
    resets the byte-lookup arrays, so a second prove sees the same traces."""
    r = runs("shard16")
    record = r["trecords"][1]
    n_lookups = len(record.global_lookup_events)
    again = r["tm"].prove_record(r["tpk"], record, device="cpu")
    assert len(record.global_lookup_events) == n_lookups
    _assert_same(convert.shard_proof_to_reference(again, jmachine, jpcs), r["jproofs"][1])
    assert torch.equal(again.main_root, r["tproofs"][1].main_root)
