"""Standalone proof verification: the `zkm-verifier` crate analog.

The reference ships a no-std crate that verifies gnark Groth16/PLONK proof
bytes against embedded verifying keys plus a byte-API STARK verifier
(crates/verifier/src/lib.rs:26-39, src/stark/verify.rs:113).  This package
is the same boundary for integrators: the SNARK byte codecs and verifiers
here depend only on the snark curve module (pure Python ints, no tensors in
the API); the STARK proof bytes and ``verify_core`` live in
``stark_codec``, the gnark wire format in ``gnark``, the Solidity verifier
in ``solidity``.  The encodings are the reference package's, byte for byte.

Byte encodings (all big-endian field elements, 32 bytes each):

* G1 point: ``x || y`` (64 bytes); the point at infinity is all zeros.
* G2 point: ``x0 || x1 || y0 || y1`` (128 bytes; Fp2 c0 then c1).
* Groth16 proof: ``A (G1) || B (G2) || C (G1)`` = 256 bytes.
* Groth16 vk: ``alpha1 (G1) || beta2 (G2) || gamma2 (G2) || delta2 (G2) ||
  n_ic (4-byte BE) || ic[0..n_ic] (G1 each)``.
* Public inputs: 32-byte BE scalars, concatenated.
"""

from __future__ import annotations

from ..snark import bn254_curve as ec
from ..snark.groth16 import ProofG16, VerifyingKeyG16, verify as _verify_g16


class VerificationFailure(Exception):
    pass


# ---------------------------------------------------------------------------
# Point codecs
# ---------------------------------------------------------------------------


def _fp_bytes(x: int) -> bytes:
    return int(x).to_bytes(32, "big")


def _fp_from(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    if v >= ec.P:
        raise VerificationFailure("field element out of range")
    return v


def encode_g1(p) -> bytes:
    if p is None:
        return b"\x00" * 64
    return _fp_bytes(p[0]) + _fp_bytes(p[1])


def decode_g1(b: bytes):
    if len(b) != 64:
        raise VerificationFailure("bad G1 length")
    if b == b"\x00" * 64:
        return None
    p = (_fp_from(b[:32]), _fp_from(b[32:]))
    if not ec.g1_is_on_curve(p):
        raise VerificationFailure("G1 point not on curve")
    return p


def encode_g2(p) -> bytes:
    if p is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = p
    return _fp_bytes(x0) + _fp_bytes(x1) + _fp_bytes(y0) + _fp_bytes(y1)


def decode_g2(b: bytes):
    if len(b) != 128:
        raise VerificationFailure("bad G2 length")
    if b == b"\x00" * 128:
        return None
    p = (
        (_fp_from(b[0:32]), _fp_from(b[32:64])),
        (_fp_from(b[64:96]), _fp_from(b[96:128])),
    )
    if not ec.g2_is_on_curve(p):
        raise VerificationFailure("G2 point not on curve")
    return p


# ---------------------------------------------------------------------------
# Groth16 proof / vk codecs
# ---------------------------------------------------------------------------


def encode_groth16_proof(proof: ProofG16) -> bytes:
    return encode_g1(proof.a) + encode_g2(proof.b) + encode_g1(proof.c)


def decode_groth16_proof(b: bytes) -> ProofG16:
    if len(b) != 256:
        raise VerificationFailure("bad proof length")
    return ProofG16(decode_g1(b[:64]), decode_g2(b[64:192]), decode_g1(b[192:]))


def encode_groth16_vk(vk: VerifyingKeyG16) -> bytes:
    out = encode_g1(vk.alpha1) + encode_g2(vk.beta2) + encode_g2(vk.gamma2) + encode_g2(vk.delta2)
    out += len(vk.ic).to_bytes(4, "big")
    for p in vk.ic:
        out += encode_g1(p)
    return out


def decode_groth16_vk(b: bytes) -> VerifyingKeyG16:
    if len(b) < 64 + 128 * 3 + 4:
        raise VerificationFailure("bad vk length")
    alpha1 = decode_g1(b[:64])
    beta2 = decode_g2(b[64:192])
    gamma2 = decode_g2(b[192:320])
    delta2 = decode_g2(b[320:448])
    n = int.from_bytes(b[448:452], "big")
    if len(b) != 452 + 64 * n:
        raise VerificationFailure("bad vk length")
    ic = [decode_g1(b[452 + 64 * i : 452 + 64 * (i + 1)]) for i in range(n)]
    return VerifyingKeyG16(alpha1=alpha1, beta2=beta2, gamma2=gamma2, delta2=delta2, ic=ic)


def encode_public_inputs(values) -> bytes:
    return b"".join(int(v % ec.R).to_bytes(32, "big") for v in values)


def decode_public_inputs(b: bytes) -> list[int]:
    if len(b) % 32:
        raise VerificationFailure("bad public-input length")
    out = []
    for i in range(0, len(b), 32):
        v = int.from_bytes(b[i : i + 32], "big")
        if v >= ec.R:
            raise VerificationFailure("public input out of range")
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# Verifiers (crates/verifier/src/lib.rs Groth16Verifier analog)
# ---------------------------------------------------------------------------


class Groth16Verifier:
    @staticmethod
    def verify(proof: bytes, vk: bytes, public_inputs: bytes) -> bool:
        """Verify Groth16 proof bytes; raises VerificationFailure on
        malformed inputs, returns the pairing-check result."""
        p = decode_groth16_proof(proof)
        k = decode_groth16_vk(vk)
        pubs = decode_public_inputs(public_inputs)
        if len(pubs) != len(k.ic) - 1:
            raise VerificationFailure("public input count mismatch")
        return _verify_g16(k, p, pubs)


def verify_groth16_wrapped(wg, core_vk, program) -> bool:
    """Object-level verification of a Groth16WrappedProof (the full digest
    tree + shard chain checks; prover/src/verify.rs:295+ analog)."""
    from ..snark.outer_circuit import verify_groth16

    return verify_groth16(core_vk, program, wg)


# ---------------------------------------------------------------------------
# PLONK proof / vk codecs + verifier (crates/verifier PlonkVerifier analog)
# ---------------------------------------------------------------------------


def _fr_bytes(x: int) -> bytes:
    return int(x % ec.R).to_bytes(32, "big")


def _fr_from(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    if v >= ec.R:
        raise VerificationFailure("scalar out of range")
    return v


def encode_plonk_proof(proof) -> bytes:
    pts = (proof.a_c, proof.b_c, proof.c_c, proof.z_c,
           proof.tlo_c, proof.tmid_c, proof.thi_c, proof.wz_c, proof.wzw_c)
    out = b"".join(encode_g1(p) for p in pts)
    out += b"".join(_fr_bytes(s) for s in (
        proof.a_bar, proof.b_bar, proof.c_bar, proof.s1_bar, proof.s2_bar, proof.zw_bar))
    return out


def decode_plonk_proof(b: bytes):
    from ..snark.plonk import PlonkProof

    if len(b) != 9 * 64 + 6 * 32:
        raise VerificationFailure("bad plonk proof length")
    pts = [decode_g1(b[64 * i : 64 * (i + 1)]) for i in range(9)]
    off = 9 * 64
    scalars = [_fr_from(b[off + 32 * i : off + 32 * (i + 1)]) for i in range(6)]
    return PlonkProof(*pts, *scalars)


def encode_plonk_vk(vk) -> bytes:
    out = int(vk.n).to_bytes(8, "big") + int(vk.num_public).to_bytes(4, "big")
    for p in (vk.qm_c, vk.ql_c, vk.qr_c, vk.qo_c, vk.qc_c, vk.s1_c, vk.s2_c, vk.s3_c):
        out += encode_g1(p)
    out += encode_g2(vk.x2)
    return out


def decode_plonk_vk(b: bytes):
    from ..snark.plonk import PlonkVerifyingKey

    if len(b) != 8 + 4 + 8 * 64 + 128:
        raise VerificationFailure("bad plonk vk length")
    n = int.from_bytes(b[:8], "big")
    if n < 4 or n & (n - 1):
        raise VerificationFailure("plonk vk domain size not a power of two")
    num_public = int.from_bytes(b[8:12], "big")
    pts = [decode_g1(b[12 + 64 * i : 12 + 64 * (i + 1)]) for i in range(8)]
    x2 = decode_g2(b[12 + 8 * 64 :])
    return PlonkVerifyingKey(n, num_public, *pts, x2=x2)


class PlonkVerifier:
    @staticmethod
    def verify(proof: bytes, vk: bytes, public_inputs: bytes) -> bool:
        """Verify PLONK proof bytes; raises VerificationFailure on malformed
        inputs, returns the pairing-check result."""
        from ..snark.plonk import verify as _verify_plonk

        p = decode_plonk_proof(proof)
        k = decode_plonk_vk(vk)
        pubs = decode_public_inputs(public_inputs)
        if len(pubs) != k.num_public:
            raise VerificationFailure("public input count mismatch")
        return _verify_plonk(k, p, pubs)


# ---------------------------------------------------------------------------
# Public-input hashing helpers (crates/verifier/src/utils.rs:7-23 analog)
# ---------------------------------------------------------------------------


def hash_public_inputs(public_inputs: bytes) -> bytes:
    """sha256 of the guest's committed public-value bytes with the top 3
    bits zeroed so the digest fits in the BN254 scalar field — byte-for-byte
    the reference's `hash_public_inputs` (crates/verifier/src/utils.rs:7,
    golden-vectored against crates/primitives/src/io.rs:102)."""
    import hashlib

    d = bytearray(hashlib.sha256(public_inputs).digest())
    d[0] &= 0x1F
    return bytes(d)


def bn254_public_values(vkey_hash: bytes, public_inputs: bytes) -> list[int]:
    """[vkey_hash as Fr (top byte dropped), committed-values digest as Fr] —
    the 2-element SNARK public-input vector format of
    crates/verifier/src/utils.rs:18-23."""
    if len(vkey_hash) != 32:
        raise VerificationFailure("vkey hash must be 32 bytes")
    return [
        int.from_bytes(vkey_hash[1:], "big"),
        int.from_bytes(hash_public_inputs(public_inputs), "big"),
    ]


# ---------------------------------------------------------------------------
# Wrapped-proof (Groth16/PLONK) byte containers — final-proof persistence
# without pickle (the reference bincodes ZKMProofWithPublicValues)
# ---------------------------------------------------------------------------


def _u32le(v: int) -> bytes:
    return int(v).to_bytes(4, "little")


def encode_groth16_wrapped(wg) -> bytes:
    """Groth16WrappedProof -> stable bytes (proof | vk | record | shards)."""
    pb = encode_groth16_proof(wg.proof)
    vb = encode_groth16_vk(wg.groth16_vk)
    out = b"ZKG1" + _u32le(2)
    out += _u32le(len(pb)) + pb
    out += _u32le(len(vb)) + vb
    out += _u32le(len(wg.wrap_public_values))
    out += b"".join(_u32le(v) for v in wg.wrap_public_values)
    out += _u32le(wg.num_shards)
    return out


def decode_groth16_wrapped(b: bytes):
    from ..snark.outer_circuit import Groth16WrappedProof

    if b[:4] != b"ZKG1" or int.from_bytes(b[4:8], "little") != 2:
        raise VerificationFailure("bad groth16 container header")
    off = 8

    def take(n):
        nonlocal off
        if off + n > len(b):
            raise VerificationFailure("truncated groth16 container")
        v = b[off : off + n]
        off += n
        return v

    np_ = int.from_bytes(take(4), "little")
    proof = decode_groth16_proof(take(np_))
    nv = int.from_bytes(take(4), "little")
    vk = decode_groth16_vk(take(nv))
    npv = int.from_bytes(take(4), "little")
    if npv > 4096:
        raise VerificationFailure("bad pv count")
    pv = [int.from_bytes(take(4), "little") for _ in range(npv)]
    num_shards = int.from_bytes(take(4), "little")
    if off != len(b):
        raise VerificationFailure("trailing bytes in groth16 container")
    return Groth16WrappedProof(proof=proof, groth16_vk=vk,
                               wrap_public_values=pv, num_shards=num_shards)


def encode_plonk_wrapped(wp) -> bytes:
    """PlonkWrappedProof -> stable bytes."""
    pb = encode_plonk_proof(wp.proof)
    vb = encode_plonk_vk(wp.plonk_vk)
    out = b"ZKPL" + _u32le(2)
    out += _u32le(len(pb)) + pb
    out += _u32le(len(vb)) + vb
    out += _u32le(len(wp.wrap_public_values))
    out += b"".join(_u32le(v) for v in wp.wrap_public_values)
    out += _u32le(wp.num_shards)
    return out


def decode_plonk_wrapped(b: bytes):
    from ..snark.outer_circuit import PlonkWrappedProof

    if b[:4] != b"ZKPL" or int.from_bytes(b[4:8], "little") != 2:
        raise VerificationFailure("bad plonk container header")
    off = 8

    def take(n):
        nonlocal off
        if off + n > len(b):
            raise VerificationFailure("truncated plonk container")
        v = b[off : off + n]
        off += n
        return v

    np_ = int.from_bytes(take(4), "little")
    proof = decode_plonk_proof(take(np_))
    nv = int.from_bytes(take(4), "little")
    vk = decode_plonk_vk(take(nv))
    npv = int.from_bytes(take(4), "little")
    if npv > 4096:
        raise VerificationFailure("bad pv count")
    pv = [int.from_bytes(take(4), "little") for _ in range(npv)]
    num_shards = int.from_bytes(take(4), "little")
    if off != len(b):
        raise VerificationFailure("trailing bytes in plonk container")
    return PlonkWrappedProof(proof=proof, plonk_vk=vk,
                             wrap_public_values=pv, num_shards=num_shards)
