"""The port's BN254 curve, R1CS and native backend of the SNARK link
(``snark/bn254_curve``, ``snark/r1cs``, ``snark/native``, ``snark/groth16``)
against the reference's ``zkmips_tpu.snark``: the pairing and the MSM on
seeded scalars, the C backend's MSMs, fixed-base batches and Fr FFTs against
their plain Python versions, equal constraint systems from both packages'
builders, and Groth16 keys and proofs equal byte for byte under equal random
draws.  Every value is an integer: tolerance 0."""

import random
import secrets

import pytest
import torch

from zkmips_tpu import verifier as jverifier
from zkmips_tpu.snark import bn254_curve as jec, groth16 as jg16, r1cs as jr1cs

from zkmips_tpu_torch import convert, verifier
from zkmips_tpu_torch.snark import bn254_curve as ec, groth16, native, r1cs

R = ec.R


def seeded(seed: int):
    """A ``randbelow`` drawing from a seeded generator."""
    gen = random.Random(seed)
    return lambda n: gen.randrange(n)


def test_curve_constants_and_membership_equal_the_reference():
    assert (ec.P, ec.R, ec.G1_GEN, ec.G2_GEN) == (jec.P, jec.R, jec.G1_GEN, jec.G2_GEN)
    assert ec.g1_is_on_curve(ec.G1_GEN) and ec.g2_is_on_curve(ec.G2_GEN)
    assert ec.g1_add(ec.g1_mul(ec.G1_GEN, R - 1), ec.G1_GEN) is None
    assert ec.g2_add(ec.g2_mul(ec.G2_GEN, R - 1), ec.G2_GEN) is None


def test_pairing_bilinear_and_equal_to_the_reference():
    gen = random.Random(1)
    a, b = gen.randrange(1, R), gen.randrange(1, R)
    p, q = ec.g1_mul(ec.G1_GEN, a), ec.g2_mul(ec.G2_GEN, b)
    assert (p, q) == (jec.g1_mul(jec.G1_GEN, a), jec.g2_mul(jec.G2_GEN, b))
    e = ec.pairing(p, q)
    assert e == jec.pairing(p, q)
    assert e == ec.f12_pow(ec.pairing(ec.G1_GEN, ec.G2_GEN), a * b % R)
    assert ec.pairing_product_is_one([(p, q), (ec.g1_neg(ec.g1_mul(ec.G1_GEN, a * b % R)), ec.G2_GEN)])
    assert not ec.pairing_product_is_one([(p, q), (ec.g1_neg(p), ec.G2_GEN)])


def _points(n, seed, mul, gen):
    rng = random.Random(seed)
    return [mul(gen, rng.randrange(1, R)) for _ in range(n)] + [None]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_native_equals_the_python_versions(group):
    mul, gen = (ec.g1_mul, ec.G1_GEN) if group == "g1" else (ec.g2_mul, ec.G2_GEN)
    pts = _points(7, 2, mul, gen)
    rng = random.Random(3)
    scalars = [rng.randrange(R) for _ in pts[:-2]] + [0, R - 1]
    plain = getattr(ec, f"{group}_msm")(pts, scalars)
    assert plain == getattr(jec, f"{group}_msm")(pts, scalars)
    assert getattr(native, f"{group}_msm")(pts, scalars) == plain
    vec = (groth16.G1Vec if group == "g1" else groth16.G2Vec)(
        *getattr(native, f"_pack_{group}")(pts))
    assert vec.msm(scalars) == plain == vec.msm(native.pack_scalars(scalars))
    assert [vec[i] for i in range(len(pts))] == pts


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_batch_equals_the_python_version(group):
    mul, gen = (ec.g1_mul, ec.G1_GEN) if group == "g1" else (ec.g2_mul, ec.G2_GEN)
    rng = random.Random(4)
    scalars = [0, 1, R - 1] + [rng.randrange(R) for _ in range(9)]
    assert getattr(native, f"{group}_mul_batch")(gen, scalars) == [mul(gen, s) for s in scalars]


@pytest.mark.parametrize("log_n", [1, 3, 6])
def test_fr_fft_equals_the_python_version(log_n):
    n = 1 << log_n
    rng = random.Random(log_n)
    vals = [rng.randrange(R) for _ in range(n)]
    root = groth16._domain_root(log_n)
    for inverse in (False, True):
        want = groth16._fft(vals, root, inverse=inverse)
        assert native.unpack_fr(native.fr_fft(native.pack_fr(vals), root, inverse=inverse)) == want
        mont = native.fr_vec_mont(native.pack_fr(vals))
        got = native.fr_vec_mont(native.fr_fft_mont(mont, root, inverse=inverse), to=False)
        assert native.unpack_fr(got) == want
    g = 5
    assert native.unpack_fr(native.fr_scale_pows(native.pack_fr(vals), g)) == \
        [v * pow(g, i, R) % R for i, v in enumerate(vals)]


def test_fr_vector_ops_equal_the_python_versions():
    rng = random.Random(5)
    a = [rng.randrange(R) for _ in range(9)] + [0]
    b = [rng.randrange(R) for _ in range(10)]
    am, bm = (native.fr_vec_mont(native.pack_fr(v)) for v in (a, b))

    def back(m):
        return native.unpack_fr(native.fr_vec_mont(m.copy(), to=False))

    assert back(native.fr_vec_add(am, bm)) == [(x + y) % R for x, y in zip(a, b)]
    assert back(native.fr_vec_sub(am, bm)) == [(x - y) % R for x, y in zip(a, b)]
    assert back(native.fr_vec_mul(am, bm)) == [x * y % R for x, y in zip(a, b)]
    assert back(native.fr_vec_inv(am)) == [pow(x, R - 2, R) if x else 0 for x in a]
    assert native.unpack_fr(native.fr_mul_sub_scale(*(native.pack_fr(v) for v in (a, b, b)), 7)) == \
        [(x * y - y) * 7 % R for x, y in zip(a, b)]


def _gadget_cs(mod, x_val=3):
    """The reference's R1CS gadget shapes (tests/test_snark.py) in one system."""
    cs = mod.ConstraintSystem()
    y = cs.public(x_val**3 + x_val + 5)
    p = cs.public(11)
    x = cs.witness(x_val)
    t = cs.add(cs.add(cs.mul(cs.mul(x, x), x), x), 5)
    cs.assert_eq(t, y)
    a, b = cs.witness(7), cs.witness(4)
    cond = cs.is_zero(cs.sub(a, 7))
    s = cs.select(cond, cs.add(a, b), 0)
    cs.assert_eq(s, p)
    cs.from_bits(cs.to_bits(s, 4))
    cs.inverse(cs.witness(2))
    cs.div(a, b)
    cs.neg(b)
    cs.assert_bool(cond)
    return cs


def test_constraint_systems_equal_the_reference():
    cs, jcs = _gadget_cs(r1cs), _gadget_cs(jr1cs)
    assert cs.is_satisfied() and jcs.is_satisfied()
    assert (cs.values, cs.constraints, cs.num_public) == (jcs.values, jcs.constraints, jcs.num_public)
    cs.values[3] = (cs.values[3] + 1) % R
    assert not cs.is_satisfied()


@pytest.fixture(scope="module")
def groth16_pair():
    """The gadget system's Groth16 keys and proof from both packages: the
    reference's draws from a patched ``secrets.randbelow``, the port's from
    the same sequence through ``rng``."""
    mp = pytest.MonkeyPatch()
    mp.setattr(secrets, "randbelow", seeded(11))
    try:
        jcs = _gadget_cs(jr1cs)
        jpk, jvk = jg16.setup(jcs)
        jproof = jg16.prove(jpk, jcs)
    finally:
        mp.undo()
    rng = seeded(11)
    cs = _gadget_cs(r1cs)
    pk, vk = groth16.setup(cs, rng=rng)
    return cs, pk, vk, groth16.prove(pk, cs, rng=rng), jvk, jproof


def test_groth16_bytes_equal_the_reference_under_equal_draws(groth16_pair):
    _cs, _pk, vk, proof, jvk, jproof = groth16_pair
    assert verifier.encode_groth16_vk(vk) == jverifier.encode_groth16_vk(jvk)
    assert verifier.encode_groth16_proof(proof) == jverifier.encode_groth16_proof(jproof)
    assert convert.snark_to_reference("groth16_proof", proof, jverifier) == jproof
    assert convert.snark_to_port("groth16_vk", jvk) == vk


def test_groth16_cross_verification_and_rejection(groth16_pair):
    cs, _pk, vk, proof, jvk, jproof = groth16_pair
    publics = cs.values[1 : 1 + cs.num_public]
    assert groth16.verify(vk, jproof, publics) and jg16.verify(jvk, proof, publics)
    assert not groth16.verify(vk, proof, [publics[0] + 1] + publics[1:])
    assert not jg16.verify(jvk, proof, [publics[0] + 1] + publics[1:])


def test_groth16_draws_fresh_randomness_by_default():
    cs = _gadget_cs(r1cs)
    pk, vk = groth16.setup(cs)
    p1, p2 = groth16.prove(pk, cs), groth16.prove(pk, cs)
    assert p1 != p2
    publics = cs.values[1 : 1 + cs.num_public]
    assert groth16.verify(vk, p1, publics) and groth16.verify(vk, p2, publics)


def test_groth16_refuses_an_unsatisfied_witness(groth16_pair):
    _cs, pk, *_ = groth16_pair
    cs = _gadget_cs(r1cs)
    cs.values[3] = 4
    with pytest.raises(AssertionError):
        groth16.prove(pk, cs)


@pytest.mark.gpu
def test_groth16_beside_the_card(groth16_pair):
    """The SNARK is host code: a process that holds a CUDA context (as the
    prover's does) proves and verifies the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.zeros(1, device="cuda")
    cs, pk, vk, proof, _jvk, _jproof = groth16_pair
    rng = seeded(11)
    for _ in range(5):  # the setup's draws
        rng(R - 1)
    again = groth16.prove(pk, cs, rng=rng)
    assert verifier.encode_groth16_proof(again) == verifier.encode_groth16_proof(proof)
