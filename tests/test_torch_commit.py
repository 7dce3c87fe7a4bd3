"""The port's NTT, Merkle MMCS and PCS commit/open against the reference's
numpy path, bit for bit."""

import numpy as np
import pytest
import torch

from zkmips_tpu.ops import field as jf, merkle as jmerkle, ntt as jntt
from zkmips_tpu.stark import pcs as jpcs
from zkmips_tpu.stark.challenger import DuplexChallenger as JChallenger
from zkmips_tpu.stark.domain import Domain as JDomain
from zkmips_tpu_torch import convert
from zkmips_tpu_torch.ops import merkle as tmerkle, ntt as tntt
from zkmips_tpu_torch.stark import pcs as tpcs
from zkmips_tpu_torch.stark.challenger import DuplexChallenger as TChallenger
from zkmips_tpu_torch.stark.domain import Domain as TDomain

torch.set_num_threads(2)

T, N = convert.to_torch, convert.to_numpy


def rand_fp(rng, shape):
    return rng.integers(0, jf.P, size=shape, dtype=np.int64).astype(np.uint32)


# w = 10 and 12: the widths XLA:TPU once miscompiled (zkmips_tpu/ops/ntt.py:74-78)
@pytest.mark.parametrize("log_n,w", [(0, 2), (1, 1), (4, 3), (8, 10), (8, 12), (10, 5), (11, 1)])
def test_ntt_intt_lde(log_n, w):
    rng = np.random.default_rng(log_n * 100 + w)
    x = rand_fp(rng, (1 << log_n, w))
    assert np.array_equal(N(tntt.ntt(T(x))), jntt.ntt(x))
    assert np.array_equal(N(tntt.ntt(T(x), inverse=True)), jntt.ntt(x, inverse=True))
    assert np.array_equal(N(tntt.ntt(tntt.ntt(T(x)), inverse=True)), x)
    for lb, shift in ((1, jf.GENERATOR), (2, 7)):
        assert np.array_equal(N(tntt.coset_lde_bitrev(T(x), lb, shift)),
                              jntt.coset_lde_bitrev(x, lb, shift))


def test_ntt_vector():
    x = rand_fp(np.random.default_rng(1), (64,))
    assert np.array_equal(N(tntt.ntt(T(x))), jntt.ntt(x))


def _mixed_batch(rng):
    return [rand_fp(rng, (32, 4)), rand_fp(rng, (8, 2)), rand_fp(rng, (32, 1)), rand_fp(rng, (4, 3))]


def test_merkle_layers_and_openings():
    rng = np.random.default_rng(2)
    mats = _mixed_batch(rng)
    jtree = jmerkle.MerkleTree(mats)
    ttree = tmerkle.MerkleTree([T(m) for m in mats])
    for jl, tl in zip(jtree.digest_layers, ttree.digest_layers):
        assert np.array_equal(N(tl), jl)
    assert np.array_equal(N(ttree.root), jtree.root)
    idx = rng.integers(0, 32, size=9)
    jrows, jsibs = jtree.open_many(idx)
    trows, tsibs = ttree.open_many(idx)
    for a, b in zip(trows, jrows):
        assert np.array_equal(N(a), b)
    assert np.array_equal(N(tsibs), jsibs)
    dims = [m.shape for m in mats]
    # the reference verifier accepts the port's openings, and vice versa
    assert jmerkle.verify_openings(N(ttree.root), idx, dims, [N(r) for r in trows], N(tsibs)).all()
    assert tmerkle.verify_openings(ttree.root, idx, dims, trows, tsibs).all()
    tsibs[0, 1, 0] ^= 1
    ok = tmerkle.verify_openings(ttree.root, idx, dims, trows, tsibs)
    assert not bool(ok[0]) and bool(ok[1:].all())


@pytest.mark.parametrize("heights", [(64, 64, 16, 2), (256, 32, 32, 1), (8,)])
def test_merkle_mixed_height_root(heights):
    """build_layers compresses each level in place and folds shorter
    matrices in where the layer reaches their height: every layer and the
    root equal the reference's."""
    rng = np.random.default_rng(sum(heights))
    mats = [rand_fp(rng, (h, 1 + i)) for i, h in enumerate(heights)]
    jlayers = jmerkle.build_layers(mats)
    tlayers = tmerkle.build_layers([T(m) for m in mats])
    assert len(jlayers) == len(tlayers)
    for jl, tl in zip(jlayers, tlayers):
        assert np.array_equal(N(tl), jl)
    assert np.array_equal(N(tmerkle.MerkleTree([T(m) for m in mats]).root), jmerkle.MerkleTree(mats).root)


@pytest.mark.gpu
@pytest.mark.parametrize("heights", [(64, 64, 16, 2), (256, 32, 32, 1), (8,)])
def test_merkle_mixed_height_root_kernel(heights):
    """The same tree on the card: one compress launch per level and one per
    folded-in height, none of them through a copy of the layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from zkmips_tpu_torch.ops import poseidon2_cuda

    rng = np.random.default_rng(sum(heights))
    mats = [rand_fp(rng, (h, 1 + i)) for i, h in enumerate(heights)]
    jlayers = jmerkle.build_layers(mats)
    poseidon2_cuda.reset_launches()
    tlayers = tmerkle.build_layers([T(m, torch.device("cuda")) for m in mats])
    levels = max(heights).bit_length() - 1
    folded = len({h for h in heights if h < max(heights)})
    assert poseidon2_cuda.LAUNCHES["poseidon2_compress"] == levels + folded
    for jl, tl in zip(jlayers, tlayers):
        assert np.array_equal(N(tl), jl)


def _commit_pair(specs, seed):
    rng = np.random.default_rng(seed)
    jdm, tdm = [], []
    for log_n, shift, w in specs:
        x = jf.to_monty(rand_fp(rng, (1 << log_n, w)))
        jdm.append((JDomain(log_n, shift), x))
        tdm.append((TDomain(log_n, shift), T(x)))
    cfg = jpcs.FriConfig.test()
    return jpcs.commit(cfg, jdm), tpcs.commit(tpcs.FriConfig.test(), tdm)


@pytest.mark.parametrize("specs", [
    [(4, 1, 3)],
    [(5, 1, 4), (3, 1, 2), (5, 1, 1)],
    # quotient-chunk batch on split cosets (tests/test_pcs.py:84-89)
    [(d.log_n, d.shift, 4) for d in JDomain(5, jf.GENERATOR).split_domains(4)],
])
def test_pcs_commit(specs):
    jd, td = _commit_pair(specs, 3)
    assert np.array_equal(N(td.root), jd.root)
    for a, b in zip(td.coeffs, jd.coeffs):
        assert np.array_equal(N(a), b)
    for a, b in zip(td.ldes, jd.ldes):
        assert np.array_equal(N(a), b)


def test_pcs_open_and_verify():
    """open_batches on two rounds (a trace batch and shifted quotient chunks)
    gives the reference's opened values and FRI proof, and both verifiers
    accept the port's proof."""
    qspecs = [(d.log_n, d.shift, 4) for d in JDomain(5, jf.GENERATOR).split_domains(4)]
    rounds = [_commit_pair([(4, 1, 3), (3, 1, 2)], 4), _commit_pair(qspecs, 5)]
    jch, tch = JChallenger(), TChallenger()
    for jd, td in rounds:
        jch.observe_digest(jd.root)
        tch.observe_digest(td.root)
    jz, tz = jch.sample_ext(), tch.sample_ext()
    assert np.array_equal(N(tz), jz)
    jrounds = [(jd, [[jz, d.next_point_ext(jz)] for d in jd.domains]) for jd, _ in rounds]
    trounds = [(td, [[tz, d.next_point_ext(tz)] for d in td.domains]) for _, td in rounds]
    jvals, jproof = jpcs.open_batches(jpcs.FriConfig.test(), jrounds, jch)
    tvals, tproof = tpcs.open_batches(tpcs.FriConfig.test(), trounds, tch)
    for jr, tr in zip(jvals, tvals):
        for jm, tm in zip(jr, tr):
            for a, b in zip(tm, jm):
                assert np.array_equal(N(a), np.asarray(b))
    got = convert.fri_proof_to_numpy(tproof)
    assert got["pow_witness"] == jproof.pow_witness
    assert np.array_equal(got["final_poly"], jproof.final_poly)
    for a, b in zip(got["commit_roots"], jproof.commit_roots):
        assert np.array_equal(a, b)
    for gq, jq in zip(got["query_proofs"], jproof.query_proofs):
        for (rows, sibs), (jrows, jsibs) in zip(gq["input_openings"], jq.input_openings):
            assert np.array_equal(sibs, jsibs) and all(np.array_equal(a, b) for a, b in zip(rows, jrows))
        for (sv, sibs), jco in zip(gq["commit_openings"], jq.commit_openings):
            assert np.array_equal(sv, jco.sibling_value) and np.array_equal(sibs, jco.siblings)

    def rounds_info(pairs, vals, z, conv):
        out = []
        for (pdata, pts), mvals in zip(pairs, vals):
            out.append((pdata.root, [(d, list(zip(p, [conv(v) for v in mv])))
                                     for d, p, mv in zip(pdata.domains, pts, mvals)]))
        return out

    v_t = TChallenger()
    for _, td in rounds:
        v_t.observe_digest(td.root)
    v_t.sample_ext()
    assert tpcs.verify_batches(tpcs.FriConfig.test(), rounds_info(trounds, tvals, tz, lambda v: v), tproof, v_t)
    v_j = JChallenger()
    for jd, _ in rounds:
        v_j.observe_digest(jd.root)
    v_j.sample_ext()
    jproof_from_port = jpcs.FriProof(
        got["commit_roots"], got["final_poly"], got["pow_witness"],
        [jpcs.QueryProof(q["input_openings"], [jpcs.CommitPhaseOpening(s, p) for s, p in q["commit_openings"]])
         for q in got["query_proofs"]],
    )
    assert jpcs.verify_batches(jpcs.FriConfig.test(), rounds_info(jrounds, tvals, jz, N), jproof_from_port, v_j)
