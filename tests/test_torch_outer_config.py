"""The port's BN254 outer config (``ops/bn254``, ``ops/merkle_bn254``,
``stark/challenger_bn254``, ``FriConfig.outer``/``outer_test``) against the
reference's: the Poseidon2-BN254 golden vector, the sponge, the challenger's
transcript, the Merkle trees, and the toy machine of
``test_torch_stark.py`` proved at the outer configs -- bytes equal
(tolerance 0: every value is a field element), each verifier accepting the
other's proof and rejecting tampering."""

import numpy as np
import pytest
import torch

from zkmips_tpu.ops import bn254 as jbn, field as jf, merkle_bn254 as jmerkle
from zkmips_tpu.stark import machine as jm, pcs as jpcs
from zkmips_tpu.stark.challenger_bn254 import MultiField32Challenger as JChallenger
from zkmips_tpu.verifier import stark_codec as jcodec

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.ops import bn254, bn254_native, merkle_bn254
from zkmips_tpu_torch.stark import machine as tm, pcs as tpcs
from zkmips_tpu_torch.stark.challenger_bn254 import MultiField32Challenger
from zkmips_tpu_torch.verifier import stark_codec as codec

from test_torch_stark import PV, RECORD, _jax_machine, _port_machine, _to_reference_proof

torch.set_num_threads(2)


def test_permutation_golden_vector():
    """gnark-ffi/go/zkm/poseidon2/poseidon2_test.go:36-47 fixes permute([0,0,0])."""
    out = bn254.permute3([0, 0, 0])
    assert out == [
        0x2ED1DA00B14D635BD35B88AB49390D5C13C90DA7E9E3A5F1EA69CD87A0AA3E82,
        0x1E21E979CC3FD844B88C2016FD18F4DB07A698AA27DECA67CA509F5B0A4480D0,
        0x2C40D0115DA2C9B55553B231BE55295F411E628ED0CD0E187917066515F0A060,
    ]
    assert out == jbn.permute3([0, 0, 0])
    state = [3, 1 << 200, bn254.P - 1]
    assert bn254.permute3(state) == jbn.permute3(state)


def test_reduce_split_and_sponge_equal_the_reference():
    vals = [123456789, 2130706432, 1, 0, 7, 42, 99, 2**30]
    assert bn254.reduce_32(vals[:3]) == jbn.reduce_32(vals[:3]) == vals[0] + (vals[1] << 32) + (vals[2] << 64)
    packed = bn254.reduce_32(vals)
    assert bn254.split_32(packed, 3) == jbn.split_32(packed, 3)
    for n in (1, 8, 16, 17, 40):
        felts = list(range(1, n + 1))
        assert bn254.hash_felts(felts) == jbn.hash_felts(felts)
    felts = list(range(1, 17))
    state = [bn254.reduce_32(felts[:8]), bn254.reduce_32(felts[8:]), 0]
    assert bn254.hash_felts(felts) == bn254.permute3(state)[0]
    assert bn254.compress(5, 9) == jbn.compress(5, 9)


@pytest.mark.parametrize("width", [1, 8, 16, 23])
def test_batched_row_hashes_equal_the_python_sponge(width):
    rng = np.random.default_rng(width)
    rows = rng.integers(0, jf.P, size=(9, width)).astype(np.uint32)
    assert bn254.hash_felts_rows(rows) == [jbn.hash_felts(r) for r in rows]
    left = [int(x) for x in rng.integers(0, 1 << 62, size=5)]
    right = [bn254.P - 1 - v for v in left]
    assert bn254.compress_rows(left, right) == [jbn.compress(l, r) for l, r in zip(left, right)]
    packed = bn254_native.pack_fr(left)
    assert bn254_native.unpack_fr(packed) == left


def test_challenger_transcript_equals_the_reference():
    a, b = MultiField32Challenger(), JChallenger()
    rng = np.random.default_rng(3)
    for i, v in enumerate(int(x) for x in rng.integers(0, jf.P, size=29)):
        a.observe(v)
        b.observe(v)
        if i % 4 == 3:
            assert a.sample() == b.sample()
    digest = np.empty(1, dtype=object)
    digest[0] = 0x1234567890ABCDEF1234567890ABCDEF
    a.observe_digest(digest)
    b.observe_digest(digest)
    assert a.sample_ext().tolist() == [int(x) for x in b.sample_ext()]
    assert a.sample_bits(9) == b.sample_bits(9)
    assert a.clone().grind(6) == b.clone().grind(6)
    w = a.clone().grind(6)
    assert a.check_witness(6, w)


def test_challenger_determinism_and_divergence():
    a, b = MultiField32Challenger(), MultiField32Challenger()
    for ch in (a, b):
        ch.observe_slice(torch.arange(10, dtype=torch.int32))
    assert a.sample() == b.sample()
    b2 = MultiField32Challenger()
    b2.observe_slice(np.arange(1, 11, dtype=np.uint32))
    assert a.clone().sample() != b2.sample()


def test_merkle_tree_equals_the_reference_and_rejects_tampering():
    rng = np.random.default_rng(0)
    mats = [
        jf.to_monty(rng.integers(0, jf.P, size=(16, 5)).astype(np.uint32)),
        jf.to_monty(rng.integers(0, jf.P, size=(4, 3)).astype(np.uint32)),
    ]
    jtree = jmerkle.MerkleTree(mats)
    tree = merkle_bn254.MerkleTree([convert.to_torch(m) for m in mats])
    assert int(tree.root[0]) == int(jtree.root[0])
    idx = np.array([0, 5, 15])
    rows, sibs = tree.open_many(idx)
    jrows, jsibs = jtree.open_many(idx)
    assert all(np.array_equal(convert.to_numpy(r), jr) for r, jr in zip(rows, jrows))
    assert sibs.dtype == object and sibs.shape == jsibs.shape == (3, 4, 1)
    assert [int(v) for v in sibs.reshape(-1)] == [int(v) for v in jsibs.reshape(-1)]
    dims = [(16, 5), (4, 3)]
    assert merkle_bn254.verify_openings(tree.root, idx, dims, rows, sibs).all()
    bad = [rows[0].clone(), rows[1]]
    bad[0][1, 2] ^= 1
    assert not merkle_bn254.verify_openings(tree.root, idx, dims, bad, sibs).all()
    assert not jmerkle.verify_openings(jtree.root, idx, dims, [convert.to_numpy(r) for r in bad], jsibs).all()


@pytest.mark.parametrize("name", ["outer", "outer_test"])
def test_outer_config_values_equal_the_reference(name):
    got, ref = getattr(tpcs.FriConfig, name)(), getattr(jpcs.FriConfig, name)()
    assert (got.log_blowup, got.num_queries, got.proof_of_work_bits, got.hash_family) == \
        (ref.log_blowup, ref.num_queries, ref.proof_of_work_bits, ref.hash_family)
    cfg = tm.StarkConfig(got)
    assert isinstance(cfg.challenger(), MultiField32Challenger)
    z = cfg.zero_digest()
    assert z.dtype == object and z.shape == (1,) and int(z[0]) == 0
    assert tm.StarkConfig.outer().fri == tpcs.FriConfig.outer()


@pytest.fixture(scope="module", params=["outer_test", "outer"])
def proofs(request):
    jmach = _jax_machine(jm.StarkConfig(getattr(jpcs.FriConfig, request.param)()))
    jpk = jmach.setup(None)
    jproof = jmach.prove_shard(jpk, RECORD, PV)
    tmach = _port_machine(tm.StarkConfig(getattr(tpcs.FriConfig, request.param)()))
    tpk = tmach.setup(None, device="cpu")
    tproof = tmach.prove_shard(tpk, RECORD, PV, device="cpu")
    return request.param, jmach, jpk, jproof, tmach, tpk, tproof


def test_proof_bytes_equal_the_reference(proofs):
    name, _jmach, _jpk, jproof, _tmach, _tpk, tproof = proofs
    assert tproof.main_root.dtype == object and tproof.main_root.shape == (1,)
    assert len(tproof.fri_proof.query_proofs) == getattr(tpcs.FriConfig, name)().num_queries
    ref_bytes = jcodec.encode_core_proof([jproof])
    assert jcodec.encode_core_proof([_to_reference_proof(tproof)]) == ref_bytes
    # the port's codec writes the same bytes and reads its BN254 digests back
    assert codec.encode_core_proof([tproof]) == ref_bytes
    decoded, _cfg = codec.decode_core_proof(ref_bytes)
    assert codec.encode_core_proof(decoded) == ref_bytes


def test_each_verifier_accepts_the_others_proof(proofs):
    _name, jmach, jpk, jproof, tmach, tpk, tproof = proofs
    assert tmach.verify_shard(tpk.vk, tproof)
    assert jmach.verify_shard(jpk.vk, _to_reference_proof(tproof))
    assert tmach.verify_shard(convert.verifying_key_to_port(jpk.vk), convert.shard_proof_to_port(jproof))


def test_tampered_outer_proof_rejected(proofs):
    _name, jmach, jpk, _jproof, tmach, tpk, tproof = proofs
    bad = convert.shard_proof_to_port(_to_reference_proof(tproof))
    bad.opened[0].main_local[0, 0] ^= 1
    with pytest.raises(tm.VerificationError):
        tmach.verify_shard(tpk.vk, bad)
    with pytest.raises(jm.VerificationError):
        jmach.verify_shard(jpk.vk, _to_reference_proof(bad))
    bad = convert.shard_proof_to_port(_to_reference_proof(tproof))
    bad.main_root[0] += 1
    with pytest.raises(tm.VerificationError):
        tmach.verify_shard(tpk.vk, bad)


@pytest.mark.gpu
def test_card_proof_equals_cpu(proofs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    _name, _jmach, _jpk, _jproof, tmach, _tpk, tproof = proofs
    pk = tmach.setup(None)
    assert codec.encode_core_proof([tmach.prove_shard(pk, RECORD, PV)]) == codec.encode_core_proof([tproof])
