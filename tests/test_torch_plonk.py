"""The port's PLONK (KZG over BN254, ``snark/plonk.py``) against the
reference's, on the small R1CS of the reference's ``tests/test_plonk.py``:
equal gate systems, keys and proofs equal byte for byte under equal random
draws (the reference's ``secrets.randbelow`` patched, the port given the
same sequence through ``rng``), each verifier accepting the other's proof,
tampering rejected, and the packed native pipeline equal to the int-list
one (its plain version).  Tolerance 0: every value is an integer."""

import dataclasses
import secrets

import pytest
import torch

from zkmips_tpu import verifier as jverifier
from zkmips_tpu.snark import plonk as jplonk, r1cs as jr1cs

from zkmips_tpu_torch import convert, verifier
from zkmips_tpu_torch.snark import plonk, r1cs

from test_torch_snark_curve import seeded

R = r1cs.R
FIELDS = ("ql", "qr", "qo", "qm", "qc", "wa", "wb", "wc", "values", "num_public")


def _circuit(mod, x_pub=3, y=5):
    """(x * y + 7 == out) with bits, an inverse and a select: the gate
    structure does not depend on the witness."""
    cs = mod.ConstraintSystem()
    x = cs.public(x_pub)
    out = cs.public(x_pub * y + 7)
    yv = cs.witness(y)
    z = cs.mul(x, yv)
    w = cs.add(z, 7)
    cs.assert_eq(w, out)
    cs.to_bits(w, 8)
    cs.inverse(yv)
    cs.select(cs.is_zero(cs.sub(x, x)), w, z)
    return cs


@pytest.fixture(scope="module")
def proved():
    """Setup and proof by both packages from the same draws."""
    mp = pytest.MonkeyPatch()
    mp.setattr(secrets, "randbelow", seeded(31))
    try:
        jg = jplonk.gates_from_r1cs(_circuit(jr1cs))
        jpk, jvk = jplonk.setup(jg)
        jproof = jplonk.prove(jpk, jg)
    finally:
        mp.undo()
    rng = seeded(31)
    g = plonk.gates_from_r1cs(_circuit(r1cs))
    pk, vk = plonk.setup(g, rng=rng)
    return {"g": g, "pk": pk, "vk": vk, "proof": plonk.prove(pk, g, rng=rng),
            "jg": jg, "jvk": jvk, "jproof": jproof}


def test_gate_systems_equal_the_reference(proved):
    g, jg = proved["g"], proved["jg"]
    assert g.is_satisfied()
    assert [getattr(g, f) for f in FIELDS] == [getattr(jg, f) for f in FIELDS]
    g2 = plonk.gates_from_r1cs(_circuit(r1cs))
    g2.values[2] = (g2.values[2] + 1) % R
    assert not g2.is_satisfied()


def test_keys_and_proofs_equal_the_reference(proved):
    assert verifier.encode_plonk_vk(proved["vk"]) == jverifier.encode_plonk_vk(proved["jvk"])
    assert verifier.encode_plonk_proof(proved["proof"]) == jverifier.encode_plonk_proof(proved["jproof"])
    assert convert.snark_to_reference("plonk_proof", proved["proof"], jverifier) == proved["jproof"]
    assert convert.snark_to_port("plonk_vk", proved["jvk"]) == proved["vk"]


def test_cross_verification(proved):
    vk, jvk = proved["vk"], proved["jvk"]
    assert plonk.verify(vk, proved["proof"], [3, 22]) and plonk.verify(vk, proved["jproof"], [3, 22])
    assert jplonk.verify(jvk, proved["proof"], [3, 22])
    assert not plonk.verify(vk, proved["proof"], [4, 22])
    assert not jplonk.verify(jvk, proved["proof"], [4, 22])
    assert not plonk.verify(vk, proved["proof"], [])


def test_tampered_proofs_rejected(proved):
    vk, proof = proved["vk"], proved["proof"]
    for name in ("a_bar", "b_bar", "c_bar", "s1_bar", "s2_bar", "zw_bar"):
        bad = dataclasses.replace(proof, **{name: (getattr(proof, name) + 1) % R})
        assert not plonk.verify(vk, bad, [3, 22]), name
    assert not plonk.verify(vk, dataclasses.replace(proof, a_c=proof.b_c, b_c=proof.a_c), [3, 22])


def test_one_setup_serves_another_witness(proved):
    g2 = plonk.gates_from_r1cs(_circuit(r1cs, 4, 6))
    assert [getattr(g2, f) for f in FIELDS[:8]] == [getattr(proved["g"], f) for f in FIELDS[:8]]
    p2 = plonk.prove(proved["pk"], g2)
    assert plonk.verify(proved["vk"], p2, [4, 31])
    assert not plonk.verify(proved["vk"], p2, [3, 22])


def test_native_pipeline_equals_the_python_one(proved):
    """The int-list pipeline (the plain version) from the same draws gives
    the same key and proof bytes as the packed native one."""
    rng = seeded(31)
    g = plonk.gates_from_r1cs(_circuit(r1cs))
    pk, vk = plonk.setup_python(g, rng=rng)
    assert isinstance(pk.ql, list)
    proof = plonk.prove(pk, g, rng=rng)
    assert verifier.encode_plonk_vk(vk) == verifier.encode_plonk_vk(proved["vk"])
    assert verifier.encode_plonk_proof(proof) == verifier.encode_plonk_proof(proved["proof"])


def test_four_gate_circuit_proves():
    """A circuit of four gates gets a domain of 8, where the quotient fits
    its coset; at the reference's domain of 4 its linearization check
    fails."""
    def tiny(mod):
        cs = mod.ConstraintSystem()
        a, b = cs.public(3), cs.public(5)
        cs.assert_eq(cs.mul(a, b), cs.witness(15))
        return cs

    g = plonk.gates_from_r1cs(tiny(r1cs))
    assert g.num_gates == 4
    pk, vk = plonk.setup(g)
    assert vk.n == 8
    assert plonk.verify(vk, plonk.prove(pk, g), [3, 5])
    jg = jplonk.gates_from_r1cs(tiny(jr1cs))
    jpk, _jvk = jplonk.setup(jg)
    with pytest.raises(AssertionError):
        jplonk.prove(jpk, jg)


@pytest.mark.gpu
def test_witness_from_a_card_tensor(proved):
    """Witness values read back from the card prove under the same setup."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x, y = torch.tensor([4, 6], device="cuda").tolist()
    g2 = plonk.gates_from_r1cs(_circuit(r1cs, x, y))
    assert plonk.verify(proved["vk"], plonk.prove(proved["pk"], g2), [x, x * y + 7])
