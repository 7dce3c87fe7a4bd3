"""The lift program (``recursion.verifier.ShardVerifierCircuit``) of a real
core shard, built by the port and by the reference from equal proofs: the
program instruction for instruction, the witness, the records of the port's
C and Python interpreters and of the reference's, every chip's traces, and
the rec_pv record the program commits.  All at tolerance 0.

The guest is ``tests/test_recursion.py``'s one-shard guest on the minimal
machine at ``StarkConfig.test()``, proved by the port; the reference's
circuit reads the same proof through ``convert`` (the core proofs' equality
is ``test_torch_mips_e2e.py``'s).  Proving the lift on both sides is
``slow``, as the reference marks its own lift of a real shard.
"""

import copy

import numpy as np
import pytest
import torch

from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.recursion import native_runtime as j_native, rec_pv as j_rec_pv
from zkmips_tpu.recursion.compress import RecursionProver as JRecursionProver
from zkmips_tpu.stark import machine as jm, pcs as jpcs
from zkmips_tpu.verifier import stark_codec as jcodec

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import Register as R, asm, execute_for_proving
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.recursion import Builder, RecursionMachine, native_runtime, rec_pv
from zkmips_tpu_torch.recursion.compress import RecursionProver
from zkmips_tpu_torch.recursion.runtime import RecursionRuntime
from zkmips_tpu_torch.recursion.verifier import DigestShardVerifierCircuit, host_proof
from zkmips_tpu_torch.stark.machine import StarkConfig

from test_torch_interpreter import ref_program
from test_torch_recursion_vm import assert_programs_equal, assert_records_equal

torch.set_num_threads(2)


class _VK:
    """What the reference's lift circuit reads of a core proving key."""

    def __init__(self, vk):
        self.vk = vk


@pytest.fixture(scope="module")
def lift():
    tp = asm.prog([*asm.li(R.T0, 5)] + asm.halt_sequence())
    jp = ref_program(tp)
    trecords, _ = execute_for_proving(tp)
    jmach = j_mips_machine(jm.StarkConfig.test(), minimal=True)
    tmach = mips_machine(StarkConfig.test(), minimal=True)
    tpk = tmach.setup(tp, device="cpu")
    jpk = _VK(convert.verifying_key_to_reference(tpk.vk, jm))
    tproofs = tmach.prove(tpk, trecords, device="cpu", workers=1)
    jproofs = [convert.shard_proof_to_reference(p, jm, jpcs) for p in tproofs]
    jrp, trp = JRecursionProver(jmach), RecursionProver(tmach)
    jcirc, jrpk = jrp._lift_entry(jpk.vk, jproofs[0])
    tcirc, trpk = trp._lift_entry(tpk.vk, tproofs[0], "cpu")
    twit = tcirc.witness(tproofs[0])
    return dict(jp=jp, tp=tp, jmach=jmach, tmach=tmach, jpk=jpk, tpk=tpk, jproofs=jproofs,
                tproofs=tproofs, jrp=jrp, trp=trp, jcirc=jcirc, tcirc=tcirc, jrpk=jrpk, trpk=trpk,
                twit=twit, tnat=native_runtime.run(tcirc.program, twit),
                jnat=j_native.run(jcirc.program, jcirc.witness(jproofs[0])))


def test_reference_accepts_the_core_proof(lift):
    assert lift["jmach"].verify(lift["jpk"].vk, lift["jproofs"], lift["jp"])


def test_lift_program_equals_the_reference(lift):
    assert len(lift["tcirc"].program.instructions) > 10_000
    assert_programs_equal(lift["tcirc"].program, lift["jcirc"].program)
    assert lift["tcirc"].has_cpu and lift["jcirc"].has_cpu


def test_lift_witness_equals_the_reference(lift):
    assert lift["twit"] == lift["jcirc"].witness(lift["jproofs"][0])
    # the witness reads one host copy of the proof, canonical
    hp = host_proof(lift["tproofs"][0])
    assert hp.public_values == [int(x) for x in lift["jproofs"][0].public_values]


def test_lift_records_equal_c_python_and_reference(lift):
    assert_records_equal(lift["tnat"], lift["jnat"])
    assert_records_equal(RecursionRuntime(lift["tcirc"].program, lift["twit"]).run(), lift["jnat"])


def test_lift_chip_traces_equal(lift):
    for tair, jair in zip(lift["trp"].rec.airs, lift["jrp"].rec.airs):
        tp_, jp_ = tair.generate_preprocessed(lift["tcirc"].program), jair.generate_preprocessed(lift["jcirc"].program)
        assert np.array_equal(np.asarray(tp_, dtype=np.uint32), jp_), tair.name
        tt, jt = tair.generate_trace(lift["tnat"], None), jair.generate_trace(lift["jnat"], None)
        assert np.array_equal(np.asarray(tt, dtype=np.uint32), jt), tair.name
    assert np.array_equal(convert.to_numpy(lift["trpk"].vk.prep_root), lift["jrpk"].vk.prep_root)
    assert lift["trpk"].vk.prep_heights == lift["jrpk"].vk.prep_heights


def test_lift_commits_the_rec_pv_record(lift):
    proof = lift["tproofs"][0]
    gs = [int(x) for ov in proof.opened if ov.global_sum is not None for x in ov.global_sum.tolist()]
    expected = rec_pv.lift_record(lift["tpk"].vk, proof.public_values.tolist(), gs, has_cpu=True)
    assert lift["tnat"].public_values == expected == lift["tcirc"].expected_public_values(proof)
    jproof = lift["jproofs"][0]
    jgs = [int(x) for ov in jproof.opened if ov.global_sum is not None for x in ov.global_sum]
    assert expected == j_rec_pv.lift_record(lift["jpk"].vk, jproof.public_values, jgs, has_cpu=True)
    assert rec_pv.NUM_REC_PV == j_rec_pv.NUM_REC_PV
    assert rec_pv.get(expected, rec_pv.START_SHARD) == [1]


@pytest.mark.parametrize("what", ["public value", "main root", "opened value", "fri final poly"])
def test_lift_rejects_a_tampered_proof(lift, what):
    bad = copy.deepcopy(lift["tproofs"][0])
    if what == "public value":
        bad.public_values[0] += 1
    elif what == "main root":
        bad.main_root[0] ^= 1
    elif what == "opened value":
        bad.opened[0].main_local[0, 0] ^= 1
    else:
        bad.fri_proof.final_poly[0] ^= 1
    with pytest.raises(AssertionError):
        lift["trp"].rec.execute(lift["tcirc"].program, lift["tcirc"].witness(bad))


def _inner_proof():
    b0 = Builder()
    z = b0.mul(b0.felt(7), b0.felt(35))
    ps = b0.poseidon2([z] + [b0.const_felt(i) for i in range(15)])
    b0.commit_public_values(ps[8:16])
    p0 = b0.compile()
    m = RecursionMachine(StarkConfig.test())
    pk = m.setup(p0, device="cpu")
    return m, pk, m.prove(pk, m.execute(p0), device="cpu")


def test_digest_shard_verifier_circuit_accepts_and_rejects():
    m, pk, proof = _inner_proof()
    circ = DigestShardVerifierCircuit(m.machine, pk.vk, proof)
    rec = m.execute(circ.program, circ.witness(proof))
    assert rec.public_values == circ.expected_public_values(proof)
    bad = copy.deepcopy(proof)
    bad.public_values[0] += 1
    with pytest.raises(AssertionError):
        m.execute(circ.program, circ.witness(bad))
    bad = copy.deepcopy(proof)
    bad.opened[0].main_local[0, 0] ^= 1
    with pytest.raises(AssertionError):
        m.execute(circ.program, circ.witness(bad))


@pytest.mark.slow
def test_lift_proofs_equal_the_reference(lift):
    """The lift of a real shard proved on both sides (the reference marks its
    own ``slow``): equal bytes, and each verifier accepts the other's."""
    tproof, tvk = lift["trp"].lift(lift["tpk"].vk, lift["tproofs"][0], device="cpu")
    jproof, jvk = lift["jrp"].lift(lift["jpk"].vk, lift["jproofs"][0])
    converted = convert.shard_proof_to_reference(tproof, jm, jpcs)
    assert jcodec.encode_core_proof([converted]) == jcodec.encode_core_proof([jproof])
    assert lift["jrp"].rec.verify(jvk, converted)
    assert lift["trp"].rec.verify(tvk, convert.shard_proof_to_port(jproof))


@pytest.mark.gpu
def test_lift_on_the_card_equals_the_cpu(lift):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    trp = lift["trp"]
    cpu_proof, _ = trp.lift(lift["tpk"].vk, lift["tproofs"][0], device="cpu")
    card = RecursionProver(lift["tmach"])
    pk = lift["tmach"].setup(lift["tp"])
    proofs = lift["tmach"].prove(pk, execute_for_proving(lift["tp"])[0])
    card_proof, _ = card.lift(pk.vk, proofs[0])
    assert jcodec.encode_core_proof([convert.shard_proof_to_reference(card_proof, jm, jpcs)]) == \
        jcodec.encode_core_proof([convert.shard_proof_to_reference(cpu_proof, jm, jpcs)])
