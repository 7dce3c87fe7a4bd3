"""The port's verifier byte APIs (``verifier/__init__``, ``verifier/gnark``,
``verifier/solidity``) against the reference's ``zkmips_tpu.verifier``:
every codec writes the reference's bytes and reads them back,
``Groth16Verifier`` and ``PlonkVerifier`` accept both packages' proofs,
gnark wire bytes (written here by a helper in the layout of the reference's
``verifier/gnark.py`` docstring) decode to equal points in both packages and
verify, and the Solidity verifier renders the same text.  Tolerance 0."""

import hashlib
import random
import re
import secrets

import pytest
import torch

from zkmips_tpu import verifier as jverifier
from zkmips_tpu.snark import groth16 as jg16, plonk as jplonk, r1cs as jr1cs
from zkmips_tpu.snark.outer_circuit import Groth16WrappedProof as JG16Wrapped
from zkmips_tpu.verifier import gnark as jgnark, solidity as jsolidity

from zkmips_tpu_torch import convert, verifier
from zkmips_tpu_torch.snark import bn254_curve as ec, groth16, plonk, r1cs
from zkmips_tpu_torch.snark.outer_circuit import Groth16WrappedProof, PlonkWrappedProof
from zkmips_tpu_torch.verifier import gnark, solidity

from test_torch_snark_curve import seeded

PV_BYTES = b"zkMIPS public values"
VKEY_HASH = hashlib.sha256(b"a guest's vkey").digest()
WRAP_PV = [5, 0x7F000000, 1, 2, 3, 4, 5, 6]


def _ziren_cs(mod):
    """A circuit whose two public inputs follow gnark's verifier: the vkey
    hash without its top byte, and sha256 of the public values masked."""
    cs = mod.ConstraintSystem()
    a = cs.public(int.from_bytes(VKEY_HASH[1:], "big"))
    d = bytearray(hashlib.sha256(PV_BYTES).digest())
    d[0] &= 0x1F
    b = cs.public(int.from_bytes(bytes(d), "big"))
    cs.assert_eq(cs.mul(a, b), cs.witness(cs.value(a) * cs.value(b)))
    cs.to_bits(cs.witness(5), 4)
    return cs


@pytest.fixture(scope="module")
def proofs():
    """A Groth16 and a PLONK proof from each package, from equal draws."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(secrets, "randbelow", seeded(41))
    try:
        jcs = _ziren_cs(jr1cs)
        jpk, out["jg_vk"] = jg16.setup(jcs)
        out["jg_proof"] = jg16.prove(jpk, jcs)
        jgates = jplonk.gates_from_r1cs(_ziren_cs(jr1cs))
        jppk, out["jp_vk"] = jplonk.setup(jgates)
        out["jp_proof"] = jplonk.prove(jppk, jgates)
    finally:
        mp.undo()
    rng = seeded(41)
    cs = _ziren_cs(r1cs)
    pk, out["g_vk"] = groth16.setup(cs, rng=rng)
    out["g_proof"] = groth16.prove(pk, cs, rng=rng)
    gates = plonk.gates_from_r1cs(_ziren_cs(r1cs))
    ppk, out["p_vk"] = plonk.setup(gates, rng=rng)
    out["p_proof"] = plonk.prove(ppk, gates, rng=rng)
    out["publics"] = cs.values[1:3]
    return out


@pytest.mark.parametrize("point", ["g1", "g2", "g1_inf", "g2_inf"])
def test_point_codecs_equal_the_reference(point):
    k = random.Random(point).randrange(1, ec.R)
    p = None if point.endswith("inf") else (ec.g1_mul(ec.G1_GEN, k) if point == "g1" else ec.g2_mul(ec.G2_GEN, k))
    enc, jenc = (verifier.encode_g1, jverifier.encode_g1) if point.startswith("g1") else \
        (verifier.encode_g2, jverifier.encode_g2)
    dec = verifier.decode_g1 if point.startswith("g1") else verifier.decode_g2
    assert enc(p) == jenc(p)
    assert dec(enc(p)) == p


@pytest.mark.parametrize("kind", ["groth16_vk", "groth16_proof", "plonk_vk", "plonk_proof"])
def test_key_and_proof_codecs_equal_the_reference(proofs, kind):
    obj = proofs[("g_" if kind.startswith("groth16") else "p_") + kind.split("_")[1]]
    jobj = proofs[("jg_" if kind.startswith("groth16") else "jp_") + kind.split("_")[1]]
    enc, dec = (f"encode_{kind}", f"decode_{kind}")
    b = getattr(verifier, enc)(obj)
    assert b == getattr(jverifier, enc)(jobj)
    assert getattr(verifier, dec)(b) == obj
    assert convert.snark_to_reference(kind, obj, jverifier) == jobj
    assert convert.snark_to_port(kind, jobj) == obj


def test_public_input_helpers_equal_the_reference(proofs):
    b = verifier.encode_public_inputs(proofs["publics"])
    assert b == jverifier.encode_public_inputs(proofs["publics"])
    assert verifier.decode_public_inputs(b) == proofs["publics"]
    assert verifier.hash_public_inputs(PV_BYTES) == jverifier.hash_public_inputs(PV_BYTES)
    assert verifier.bn254_public_values(VKEY_HASH, PV_BYTES) == \
        jverifier.bn254_public_values(VKEY_HASH, PV_BYTES) == proofs["publics"]
    assert gnark.hash_public_inputs(PV_BYTES) == jgnark.hash_public_inputs(PV_BYTES)
    with pytest.raises(verifier.VerificationFailure):
        verifier.decode_public_inputs(ec.R.to_bytes(32, "big"))


def test_wrapped_containers_equal_the_reference(proofs):
    wg = Groth16WrappedProof(proofs["g_proof"], proofs["g_vk"], WRAP_PV, 2)
    b = verifier.encode_groth16_wrapped(wg)
    assert b == jverifier.encode_groth16_wrapped(JG16Wrapped(proofs["jg_proof"], proofs["jg_vk"], WRAP_PV, 2))
    assert verifier.decode_groth16_wrapped(b) == wg
    assert convert.snark_to_reference("groth16_wrapped", wg, jverifier) == jverifier.decode_groth16_wrapped(b)
    wp = PlonkWrappedProof(proofs["p_proof"], proofs["p_vk"], WRAP_PV, 3)
    pb = verifier.encode_plonk_wrapped(wp)
    assert verifier.decode_plonk_wrapped(pb) == wp
    assert jverifier.encode_plonk_wrapped(jverifier.decode_plonk_wrapped(pb)) == pb
    for bad in (b[:-1], b + b"\x00", b"ZKG2" + b[4:]):
        with pytest.raises(verifier.VerificationFailure):
            verifier.decode_groth16_wrapped(bad)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_byte_verifiers_accept_both_packages_proofs(proofs, package):
    v = verifier if package == "port" else jverifier
    pubs = v.encode_public_inputs(proofs["publics"])
    wrong = v.encode_public_inputs([proofs["publics"][0] + 1, proofs["publics"][1]])
    for prefix in ("g_", "jg_"):
        pb = v.encode_groth16_proof(proofs[prefix + "proof"])
        vb = v.encode_groth16_vk(proofs[prefix + "vk"])
        assert v.Groth16Verifier.verify(pb, vb, pubs)
        assert not v.Groth16Verifier.verify(pb, vb, wrong)
        with pytest.raises(v.VerificationFailure):
            v.Groth16Verifier.verify(pb[:-1], vb, pubs)
    for prefix in ("p_", "jp_"):
        pb = v.encode_plonk_proof(proofs[prefix + "proof"])
        vb = v.encode_plonk_vk(proofs[prefix + "vk"])
        assert v.PlonkVerifier.verify(pb, vb, pubs)
        assert not v.PlonkVerifier.verify(pb, vb, wrong)
        bad = bytearray(pb)
        bad[5] ^= 0x40
        with pytest.raises(v.VerificationFailure):
            v.PlonkVerifier.verify(bytes(bad), vb, pubs)


# ---- gnark's wire format, written independently of the port's encoder ---------

_P = ec.P
_HALF = (_P - 1) // 2


def _be(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _g1c(p) -> bytes:
    """x with flag 0b10 (smaller y) or 0b11 (larger y) in byte 0's top bits."""
    if p is None:
        return b"\x40" + b"\x00" * 31
    out = bytearray(_be(p[0]))
    out[0] |= 0xC0 if p[1] > _HALF else 0x80
    return bytes(out)


def _g2c(p) -> bytes:
    """x1 || x0 with the flag of the lexicographically larger y."""
    if p is None:
        return b"\x40" + b"\x00" * 63
    (x0, x1), (y0, y1) = p
    larger = y1 > _HALF if y1 else y0 > _HALF
    out = bytearray(_be(x1) + _be(x0))
    out[0] |= 0xC0 if larger else 0x80
    return bytes(out)


def gnark_vk_bytes(vk) -> bytes:
    """alpha(G1c) g1beta(skipped) beta gamma (G2c) g1delta(skipped) delta(G2c) n_k k[i](G1c)."""
    return (_g1c(vk.alpha1) + _g1c(None) + _g2c(vk.beta2) + _g2c(vk.gamma2) + _g1c(None) + _g2c(vk.delta2)
            + len(vk.ic).to_bytes(4, "big") + b"".join(_g1c(p) for p in vk.ic))


def gnark_proof_bytes(proof, vk_bytes: bytes) -> bytes:
    """sha256(vk)[:4] || ar(G1u) || bs(x1 x0 y1 y0) || krs(G1u)."""
    (x0, x1), (y0, y1) = proof.b
    return (hashlib.sha256(vk_bytes).digest()[:4] + _be(proof.a[0]) + _be(proof.a[1])
            + _be(x1) + _be(x0) + _be(y1) + _be(y0) + _be(proof.c[0]) + _be(proof.c[1]))


@pytest.fixture(scope="module")
def gnark_bytes(proofs):
    vk_b = gnark_vk_bytes(proofs["g_vk"])
    return vk_b, gnark_proof_bytes(proofs["g_proof"], vk_b)


def test_gnark_bytes_decode_to_equal_points(proofs, gnark_bytes):
    vk_b, proof_b = gnark_bytes
    assert gnark.dump_groth16_vk(proofs["g_vk"]) == vk_b
    assert gnark.dump_groth16_proof(proofs["g_proof"], vk_b) == proof_b
    vk, jvk = gnark.load_groth16_vk(vk_b), jgnark.load_groth16_vk(vk_b)
    k = proofs["g_vk"]
    assert (vk.alpha, vk.beta, vk.gamma, vk.delta, vk.k) == (jvk.alpha, jvk.beta, jvk.gamma, jvk.delta, jvk.k) \
        == (k.alpha1, k.beta2, k.gamma2, k.delta2, k.ic)
    p, jp = gnark.load_groth16_proof(proof_b[4:]), jgnark.load_groth16_proof(proof_b[4:])
    assert (p.ar, p.bs, p.krs) == (jp.ar, jp.bs, jp.krs) == (proofs["g_proof"].a, proofs["g_proof"].b,
                                                             proofs["g_proof"].c)


@pytest.mark.parametrize("package", [gnark, jgnark], ids=["port", "reference"])
def test_gnark_bytes_verify_and_a_flipped_flag_is_rejected(gnark_bytes, package):
    vk_b, proof_b = gnark_bytes
    assert package.verify_gnark_groth16(proof_b, PV_BYTES, VKEY_HASH.hex(), vk_b)
    assert package.verify_gnark_groth16(proof_b, PV_BYTES, VKEY_HASH, vk_b)
    assert not package.verify_gnark_groth16(proof_b, PV_BYTES + b"!", VKEY_HASH, vk_b)
    flipped = bytearray(vk_b)
    flipped[0] ^= 0x40  # alpha: the other y
    with pytest.raises(package.GnarkDecodeError):  # the proof's vk-hash prefix no longer matches
        package.verify_gnark_groth16(proof_b, PV_BYTES, VKEY_HASH, bytes(flipped))
    vk, proof = package.load_groth16_vk(bytes(flipped)), package.load_groth16_proof(proof_b[4:])
    publics = verifier.bn254_public_values(VKEY_HASH, PV_BYTES)
    assert not package.verify_gnark_groth16_algebraic(vk, proof, publics)
    unknown = bytearray(vk_b)
    unknown[0] &= 0x3F  # no compression flag at all
    with pytest.raises(package.GnarkDecodeError):
        package.load_groth16_vk(bytes(unknown))


def test_solidity_verifier_equals_the_reference(gnark_bytes, proofs):
    vk_b, _ = gnark_bytes
    src = solidity.render_groth16_verifier(vk_b)
    assert src == jsolidity.render_groth16_verifier(vk_b)
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"constant (\w+) = (\d+);", src)}
    k = proofs["g_vk"]
    assert (consts["ALPHA_X"], consts["ALPHA_Y"]) == k.alpha1
    for name, pt in (("BETA", k.beta2), ("GAMMA", k.gamma2), ("DELTA", k.delta2)):
        (x0, x1), (y0, y1) = pt
        assert (consts[f"{name}_X0"], consts[f"{name}_X1"], consts[f"{name}_Y0"], consts[f"{name}_Y1"]) == \
            (x0, x1, y0, y1)
    assert [(consts[f"K{i}_X"], consts[f"K{i}_Y"]) for i in range(3)] == k.ic
    assert hashlib.sha256(vk_b).digest()[:4].hex() in src
    with pytest.raises(ValueError):
        solidity.render_groth16_verifier(vk_b[:288] + (2).to_bytes(4, "big") + vk_b[292:292 + 64])


@pytest.mark.gpu
def test_byte_verifier_on_card_read_inputs(proofs):
    """Public inputs that went through a card tensor (as 32-bit chunks)
    verify as before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    chunks = torch.tensor([[v >> (32 * i) & 0xFFFFFFFF for i in range(8)] for v in proofs["publics"]],
                          dtype=torch.int64, device="cuda")
    back = [sum(int(c) << (32 * i) for i, c in enumerate(row)) for row in chunks.cpu().tolist()]
    assert back == proofs["publics"]
    pb = verifier.encode_groth16_proof(proofs["g_proof"])
    vb = verifier.encode_groth16_vk(proofs["g_vk"])
    assert verifier.Groth16Verifier.verify(pb, vb, verifier.encode_public_inputs(back))
