"""The compress program, the vk map and the port's compressed-proof bytes.

* The compress-pair program (``recursion.verifier.CompressVerifierCircuit``)
  of ``tests/test_recursion.py``: two record-structured recursion proofs,
  proved once by the port and handed to both packages, give equal programs,
  witnesses and records (tolerance 0); the fold runs in-circuit and breaks
  on a broken pc or shard chain.
* The vk map (``export_vk_map``/``load_vk_map``) and its Merkle root equal
  the reference's.
* A deferred link of a recursion proof binds its chain values and
  round-trips through ``encode_deferred_proof``.
"""

import copy

import numpy as np
import pytest
import torch

from zkmips_tpu.machine.global_chip import START as J_START
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.ops import septic as jseptic
from zkmips_tpu.recursion import native_runtime as j_native, rec_pv as j_rec_pv
from zkmips_tpu.recursion.compress import RecursionProver as JRecursionProver
from zkmips_tpu.recursion.verifier import CompressVerifierCircuit as JCompressVerifierCircuit
from zkmips_tpu.recursion.vk_tree import map_entries_root as j_map_entries_root
from zkmips_tpu.stark import machine as jm, pcs as jpcs

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.recursion import Builder, RecursionMachine, native_runtime, rec_pv
from zkmips_tpu_torch.recursion.compress import CompressedProof, RecursionProver, root_key
from zkmips_tpu_torch.recursion.verifier import (
    CompressVerifierCircuit, compress_digest, rolling_deferred_digest,
)
from zkmips_tpu_torch.recursion.vk_tree import map_entries_root
from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError, VerifyingKey
from zkmips_tpu_torch.verifier import stark_codec as codec

from test_torch_recursion_vm import assert_programs_equal, assert_records_equal

torch.set_num_threads(2)


def _fake_record(shard: int, start_pc: int, next_pc: int, digest_seed: int):
    """A chain-rule-consistent rec_pv record with a real curve digest."""
    rec = [0] * rec_pv.NUM_REC_PV
    x, y, _off = jseptic.lift_x_int([digest_seed, 1, 2, 3, 4, 5, 6])
    start = ([int(c) for c in J_START[0]], [int(c) for c in J_START[1]])
    d = jseptic.curve_add_int(start, (list(x), list(y)))
    rec[rec_pv.GLOBAL_SUM[0] : rec_pv.GLOBAL_SUM[1]] = list(d[0]) + list(d[1])
    rec[rec_pv.START_PC[0]] = start_pc
    rec[rec_pv.NEXT_PC[0]] = next_pc
    rec[rec_pv.START_SHARD[0]] = shard
    rec[rec_pv.NEXT_SHARD[0]] = shard + 1
    rec[rec_pv.START_EXECUTION_SHARD[0]] = shard
    rec[rec_pv.NEXT_EXECUTION_SHARD[0]] = shard + 1
    rec[rec_pv.CONTAINS_EXECUTION_SHARD[0]] = 1
    rec[rec_pv.CORE_VK_DIGEST[0]] = 77  # same in both children
    return rec


@pytest.fixture(scope="module")
def pair():
    b0 = Builder()
    hints = [b0.hint_felt() for _ in range(rec_pv.NUM_REC_PV)]
    b0.poseidon2([hints[0]] + [b0.const_felt(i) for i in range(15)])  # a hash row
    b0.commit_public_values(hints)
    p0 = b0.compile()
    m = RecursionMachine(StarkConfig.test(), num_pv=rec_pv.NUM_REC_PV)
    pk = m.setup(p0, device="cpu")

    def prove_rec(vals):
        return m.prove(pk, m.execute(p0, [(v, 0, 0, 0) for v in vals]), device="cpu")

    recs = {"l": _fake_record(1, 0x1000, 0x2000, 9), "r": _fake_record(2, 0x2000, 0, 10),
            "bad_pc": _fake_record(2, 0x3000, 0, 10), "bad_shard": _fake_record(3, 0x2000, 0, 10)}
    proofs = {k: prove_rec(v) for k, v in recs.items()}
    circ = CompressVerifierCircuit(m.machine, pk.vk, pk.vk, proofs["l"], proofs["r"])
    jproofs = {k: convert.shard_proof_to_reference(p, jm, jpcs) for k, p in proofs.items()}
    jmach = JRecursionProver(j_mips_machine(jm.StarkConfig.test(), minimal=True)).rec
    jvk = convert.verifying_key_to_reference(pk.vk, jm)
    jcirc = JCompressVerifierCircuit(jmach.machine, jvk, jvk, jproofs["l"], jproofs["r"])
    return dict(m=m, pk=pk, recs=recs, proofs=proofs, jproofs=jproofs, circ=circ, jcirc=jcirc)


def test_compress_pair_program_and_witness_equal_the_reference(pair):
    assert_programs_equal(pair["circ"].program, pair["jcirc"].program)
    p, jp = pair["proofs"], pair["jproofs"]
    assert pair["circ"].witness((p["l"], p["r"])) == pair["jcirc"].witness((jp["l"], jp["r"]))


def test_compress_pair_record_folds_in_circuit(pair):
    p, jp = pair["proofs"], pair["jproofs"]
    rec = native_runtime.run(pair["circ"].program, pair["circ"].witness((p["l"], p["r"])))
    jrec = j_native.run(pair["jcirc"].program, pair["jcirc"].witness((jp["l"], jp["r"])))
    assert_records_equal(rec, jrec)
    folded = rec_pv.fold_records(pair["recs"]["l"], pair["recs"]["r"])
    assert folded == j_rec_pv.fold_records(pair["recs"]["l"], pair["recs"]["r"])
    assert rec.public_values == folded == pair["circ"].expected_public_values((p["l"], p["r"]))
    assert rec_pv.get(folded, rec_pv.START_SHARD) == [1]
    assert rec_pv.get(folded, rec_pv.NEXT_SHARD) == [3]
    assert rec_pv.get(folded, rec_pv.NEXT_PC) == [0]


@pytest.mark.parametrize("which", ["bad_pc", "bad_shard"])
def test_compress_pair_rejects_a_broken_chain(pair, which):
    p = pair["proofs"]
    with pytest.raises(AssertionError):
        pair["m"].execute(pair["circ"].program, pair["circ"].witness((p["l"], p[which])))


class _PK:
    def __init__(self, vk):
        self.vk = vk


def _prover_with_fake_vks():
    rp = RecursionProver(mips_machine(StarkConfig.test(), minimal=True))
    outer_root = np.empty(1, dtype=object)
    outer_root[0] = 123456789012345678901234567890
    rp._lift_cache["a"] = (None, _PK(VerifyingKey(torch.arange(8, dtype=torch.int32),
                                                  [("RecMemConst", 4)])))
    rp._compress_cache["b"] = (None, _PK(VerifyingKey(torch.arange(8, 16, dtype=torch.int32),
                                                      [("RecPoseidon2", 6)])))
    rp._shrink_cache["c"] = (None, _PK(VerifyingKey(outer_root, [("RecPoseidon2", 6)])))
    return rp, outer_root


def test_vk_map_round_trip_and_root_equal_the_reference(tmp_path):
    rp, outer_root = _prover_with_fake_vks()
    exported = rp.export_vk_map()
    root = tuple(int(x) for x in exported["merkle_root"])
    assert root == map_entries_root(exported["vks"]) == j_map_entries_root(exported["vks"])
    rp2 = RecursionProver(rp.core)
    rp2.load_vk_map(exported, expected_root=root)
    vk = rp2._find_final_vk(CompressedProof(None, tuple(range(8)), 1))
    assert vk.prep_heights == [("RecMemConst", 4)] and vk.prep_root.tolist() == list(range(8))
    vko = rp2._find_final_vk(CompressedProof(None, (int(outer_root[0]),), 1, stage="wrap"))
    assert int(vko.prep_root[0]) == int(outer_root[0])
    path = tmp_path / "vk_map.json"
    rp.export_vk_map(str(path))
    rp3 = RecursionProver(rp.core)
    rp3.load_vk_map(str(path))
    assert rp3._find_final_vk(CompressedProof(None, tuple(range(8, 16)), 1)).prep_heights == \
        [("RecPoseidon2", 6)]


def test_vk_map_rejects_tampered_and_forged_maps():
    rp, _ = _prover_with_fake_vks()
    exported = rp.export_vk_map()
    root = tuple(int(x) for x in exported["merkle_root"])
    bad = copy.deepcopy(exported)
    bad["vks"][0]["heights"][0][1] = 9
    with pytest.raises(VerificationError, match="merkle root"):
        RecursionProver(rp.core).load_vk_map(bad)
    forged = copy.deepcopy(exported)
    forged["vks"].append({"root": [str(i) for i in range(100, 108)], "heights": []})
    forged["merkle_root"] = [str(x) for x in map_entries_root(forged["vks"])]
    with pytest.raises(VerificationError, match="pinned"):
        RecursionProver(rp.core).load_vk_map(forged, expected_root=root)
    with pytest.raises(VerificationError, match="vk map"):
        RecursionProver(rp.core)._find_final_vk(CompressedProof(None, (1,) * 8, 1))


def test_deferred_link_bytes_round_trip(pair):
    """A deferred link of a recursion proof (the pair's left child, its vk
    in the prover's caches): ``prove_deferred`` binds the chain values, and
    the link round-trips through ``encode_deferred_proof``."""
    rp = RecursionProver(mips_machine(StarkConfig.test(), minimal=True))
    rp._compress_cache["child"] = (None, pair["pk"])
    child = CompressedProof(pair["proofs"]["l"], root_key(pair["pk"].vk.prep_root), 1)
    prev = list(range(1, 9))
    dp, new_digest = rp.prove_deferred(child, prev, device="cpu")
    assert new_digest == dp.new_digest and dp.prev_digest == prev
    assert dp.new_digest == rolling_deferred_digest(prev, rec_pv.canonical_digest(pair["pk"].vk.prep_root),
                                                    pair["recs"]["l"])
    b = codec.encode_deferred_proof(dp, config="test")
    dp2, cfg = codec.decode_deferred_proof(b)
    assert cfg == "test" and codec.encode_deferred_proof(dp2, config=cfg) == b
    assert (dp2.prev_digest, dp2.new_digest, dp2.child_vk_root) == \
        (dp.prev_digest, dp.new_digest, dp.child_vk_root)
    assert rp.rec.verify(rp._find_final_vk(dp2), dp2.proof)
    assert dp2.proof.public_values.tolist()[:8] == compress_digest(prev, new_digest)
