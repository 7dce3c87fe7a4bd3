"""The KoalaBear recursion FRI configs (``FriConfig.compressed`` and
``ultra_compressed``: log blowup 2 and 3) on the toy machine of
``test_torch_stark.py``: the port's proofs equal the reference's field by
field (tolerance 0), each package's verifier accepts them, and the
transcript comes from the config."""

import numpy as np
import pytest
import torch

from zkmips_tpu.stark import machine as jm, pcs as jpcs
from zkmips_tpu_torch.stark import machine as tm, pcs as tpcs
from zkmips_tpu_torch.stark.challenger import DuplexChallenger

from test_torch_stark import PV, RECORD, _assert_same, _jax_machine, _port_machine, _to_reference_proof

CONFIGS = ("core", "compressed", "ultra_compressed", "test")


@pytest.mark.parametrize("name", CONFIGS)
def test_fri_config_values_equal_the_reference(name):
    got = getattr(tpcs.FriConfig, name)()
    ref = getattr(jpcs.FriConfig, name)()
    assert (got.log_blowup, got.num_queries, got.proof_of_work_bits, got.hash_family) == \
        (ref.log_blowup, ref.num_queries, ref.proof_of_work_bits, ref.hash_family)


def test_bn254_hash_family_is_refused():
    with pytest.raises(NotImplementedError, match="7a"):
        tpcs.FriConfig(2, 4, 4, hash_family="bn254")
    with pytest.raises(ValueError):
        tpcs.FriConfig(hash_family="sha")


def _stark_config(name):
    return jm.StarkConfig(getattr(jpcs.FriConfig, name)()), tm.StarkConfig(getattr(tpcs.FriConfig, name)())


@pytest.fixture(scope="module", params=["compressed", "ultra_compressed"])
def proofs(request):
    jcfg, tcfg = _stark_config(request.param)
    jmach = _jax_machine(jcfg)
    jpk = jmach.setup(None)
    jproof = jmach.prove_shard(jpk, RECORD, PV)
    tmach = _port_machine(tcfg)
    tpk = tmach.setup(None, device="cpu")
    tproof = tmach.prove_shard(tpk, RECORD, PV, device="cpu")
    return request.param, jmach, jpk, jproof, tmach, tpk, tproof


def test_proof_equals_reference_field_by_field(proofs):
    name, _jmach, _jpk, jproof, _tmach, _tpk, tproof = proofs
    cfg = getattr(tpcs.FriConfig, name)()
    # the tallest matrix (Range, 2^6 rows) is extended to 2^(6 + log blowup)
    # and folded down to the blowup's height: six layers whatever the
    # blowup; the quotient's log degree (1 here) differs from the log blowup
    assert len(tproof.fri_proof.commit_roots) == 6
    assert len(tproof.fri_proof.query_proofs) == cfg.num_queries
    _assert_same(_to_reference_proof(tproof), jproof)


def test_both_verifiers_accept(proofs):
    _name, jmach, jpk, _jproof, tmach, tpk, tproof = proofs
    assert tmach.verify_shard(tpk.vk, tproof)
    assert jmach.verify_shard(jpk.vk, _to_reference_proof(tproof))


def test_tampered_proof_is_rejected(proofs):
    _name, jmach, jpk, _jproof, tmach, tpk, tproof = proofs
    saved = tproof.fri_proof.final_poly
    tproof.fri_proof.final_poly = saved.clone()
    tproof.fri_proof.final_poly[0] ^= 1
    try:
        with pytest.raises(tm.VerificationError):
            tmach.verify_shard(tpk.vk, tproof)
        with pytest.raises(jm.VerificationError):
            jmach.verify_shard(jpk.vk, _to_reference_proof(tproof))
    finally:
        tproof.fri_proof.final_poly = saved


def test_prove_and_verify_take_the_challenger_from_the_config(monkeypatch):
    calls = []

    class Spy(DuplexChallenger):
        def __init__(self):
            calls.append(1)
            super().__init__()

    cfg = tm.StarkConfig.test()
    monkeypatch.setattr(tm.StarkConfig, "challenger", lambda self: Spy())
    m = _port_machine(cfg)
    pk = m.setup(None, device="cpu")
    proof = m.prove_shard(pk, RECORD, PV, device="cpu")
    assert calls == [1]
    assert m.verify_shard(pk.vk, proof)
    assert calls == [1, 1]
    assert torch.equal(cfg.zero_digest(), torch.zeros(8, dtype=torch.int32))
    assert np.array_equal(jm.StarkConfig.test().zero_digest(), np.zeros(8, dtype=np.uint32))


@pytest.mark.gpu
def test_card_proofs_equal_the_cpu_at_the_recursion_configs(proofs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    name, _jmach, _jpk, _jproof, tmach, _tpk, tproof = proofs
    pk = tmach.setup(None)
    _assert_same(_to_reference_proof(tmach.prove_shard(pk, RECORD, PV)), _to_reference_proof(tproof))
