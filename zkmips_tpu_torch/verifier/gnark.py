"""gnark wire-format Groth16 verification (BN254).

The reference's offchain verifier crate verifies gnark-serialized Groth16
proofs against gnark-serialized verifying keys
(crates/verifier/src/groth16/converter.rs, src/converter.rs,
src/groth16/verify.rs, src/utils.rs).  This module is the same byte boundary
over the port's BN254 stack (snark/bn254_curve.py), on pure Python ints, and
doubles as a golden cross-check of the whole pairing
stack: it verifies the reference repo's shipped gnark artifacts
(crates/prover/scripts/artifacts/example_proof.json +
example_vk_groth16.bin), which were produced by gnark itself.

gnark encodings (BE 32-byte Fp limbs; gnark-crypto bn254/marshal.go):

* compressed point: x with the 2 MSBs of byte 0 as flag
  (0b10 = smaller y, 0b11 = larger y, 0b01 = infinity)
* uncompressed G1: x || y
* uncompressed G2: x1 || x0 || y1 || y0  (Fp2 c1 first)
* "lexicographically largest" Fp2: c1 > (p-1)/2, or c1 == 0 and c0 > (p-1)/2
* Groth16 vk: alpha(G1c) g1beta(skip) beta(G2c) gamma(G2c) g1delta(skip)
  delta(G2c) n_k(u32 BE) k[i](G1c)
* Groth16 proof: ar(G1u) bs(G2u) krs(G1u), prefixed by the first 4 bytes of
  sha256(vk bytes); trailing gnark commitment data is ignored

``dump_groth16_vk`` and ``dump_groth16_proof`` write this port's Groth16 keys
and proofs in the same layout.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..snark import bn254_curve as ec

MASK = 0b11 << 6
FLAG_SMALLER = 0b10 << 6  # gnark mCompressedSmallest
FLAG_LARGER = 0b11 << 6  # gnark mCompressedLargest
FLAG_INFINITY = 0b01 << 6

P = ec.P
HALF = (P - 1) // 2


class GnarkDecodeError(Exception):
    pass


# ---------------------------------------------------------------------------
# field / curve helpers
# ---------------------------------------------------------------------------


def _fp_sqrt(a: int) -> int | None:
    """Square root in Fp (p % 4 == 3)."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


def _fp2_sqrt(a) -> tuple | None:
    """Square root in Fp2 = Fp[u]/(u^2+1) for p % 4 == 3 (Adj–Rodríguez)."""
    if a == (0, 0):
        return (0, 0)
    a1 = ec._f2_pow(a, (P - 3) // 4)
    alpha = ec.f2_mul(ec.f2_sqr(a1), a)
    x0 = ec.f2_mul(a1, a)
    if alpha == (P - 1, 0):
        return (P - x0[1] if x0[1] else 0, x0[0])  # u * x0
    b = ec._f2_pow(ec.f2_add((1, 0), alpha), (P - 1) // 2)
    x = ec.f2_mul(b, x0)
    return x if ec.f2_sqr(x) == a else None


def _fp2_is_larger(y) -> bool:
    c0, c1 = y
    if c1 != 0:
        return c1 > HALF
    return c0 > HALF


def _fp_from_be(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    if v >= P:
        raise GnarkDecodeError("Fp element out of range")
    return v


# ---------------------------------------------------------------------------
# point decoding
# ---------------------------------------------------------------------------


def decode_g1_compressed(buf: bytes):
    if len(buf) != 32:
        raise GnarkDecodeError("bad compressed G1 length")
    flag = buf[0] & MASK
    if flag == FLAG_INFINITY:
        return None
    if flag not in (FLAG_SMALLER, FLAG_LARGER):
        # gnark's converter rejects unknown flags (converter.rs: _ =>
        # Err(InvalidPoint)); accepting them would add encoding malleability
        raise GnarkDecodeError("invalid G1 compression flag")
    x_bytes = bytes([buf[0] & ~MASK]) + buf[1:]
    x = _fp_from_be(x_bytes)
    y = _fp_sqrt((pow(x, 3, P) + 3) % P)
    if y is None:
        raise GnarkDecodeError("compressed G1 x not on curve")
    if (y > HALF) != (flag == FLAG_LARGER):
        y = P - y
    return (x, y)


def decode_g2_compressed(buf: bytes):
    if len(buf) != 64:
        raise GnarkDecodeError("bad compressed G2 length")
    flag = buf[0] & MASK
    if flag == FLAG_INFINITY:
        return None
    if flag not in (FLAG_SMALLER, FLAG_LARGER):
        raise GnarkDecodeError("invalid G2 compression flag")
    x1 = _fp_from_be(bytes([buf[0] & ~MASK]) + buf[1:32])
    x0 = _fp_from_be(buf[32:64])
    x = (x0, x1)
    b2 = ec.f2_mul((3, 0), ec.f2_inv(ec.XI))  # twist constant 3/(9+u)
    rhs = ec.f2_add(ec.f2_mul(ec.f2_sqr(x), x), b2)
    y = _fp2_sqrt(rhs)
    if y is None:
        raise GnarkDecodeError("compressed G2 x not on curve")
    if _fp2_is_larger(y) != (flag == FLAG_LARGER):
        y = ec.f2_neg(y)
    return (x, y)


def decode_g1_uncompressed(buf: bytes):
    if len(buf) != 64:
        raise GnarkDecodeError("bad G1 length")
    p = (_fp_from_be(buf[:32]), _fp_from_be(buf[32:]))
    if p == (0, 0):
        return None
    if not ec.g1_is_on_curve(p):
        raise GnarkDecodeError("G1 point not on curve")
    return p


def decode_g2_uncompressed(buf: bytes):
    if len(buf) != 128:
        raise GnarkDecodeError("bad G2 length")
    x1, x0 = _fp_from_be(buf[:32]), _fp_from_be(buf[32:64])
    y1, y0 = _fp_from_be(buf[64:96]), _fp_from_be(buf[96:128])
    p = ((x0, x1), (y0, y1))
    if p == ((0, 0), (0, 0)):
        return None
    if not ec.g2_is_on_curve(p):
        raise GnarkDecodeError("G2 point not on curve")
    return p


# ---------------------------------------------------------------------------
# point encoding (the inverse of the decoders above)
# ---------------------------------------------------------------------------


def _fp_to_be(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


def encode_g1_compressed(p) -> bytes:
    if p is None:
        return bytes([FLAG_INFINITY]) + b"\x00" * 31
    out = bytearray(_fp_to_be(p[0]))
    out[0] |= FLAG_LARGER if p[1] > HALF else FLAG_SMALLER
    return bytes(out)


def encode_g2_compressed(p) -> bytes:
    if p is None:
        return bytes([FLAG_INFINITY]) + b"\x00" * 63
    (x0, x1), y = p
    out = bytearray(_fp_to_be(x1) + _fp_to_be(x0))
    out[0] |= FLAG_LARGER if _fp2_is_larger(y) else FLAG_SMALLER
    return bytes(out)


def encode_g1_uncompressed(p) -> bytes:
    if p is None:
        return b"\x00" * 64
    return _fp_to_be(p[0]) + _fp_to_be(p[1])


def encode_g2_uncompressed(p) -> bytes:
    if p is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = p
    return _fp_to_be(x1) + _fp_to_be(x0) + _fp_to_be(y1) + _fp_to_be(y0)


def dump_groth16_vk(vk) -> bytes:
    """A Groth16 verifying key (``snark.groth16.VerifyingKeyG16``) in gnark's
    vk layout.  The two G1 slots gnark carries and the verifier skips
    (g1beta, g1delta) hold the point at infinity."""
    out = encode_g1_compressed(vk.alpha1) + encode_g1_compressed(None)
    out += encode_g2_compressed(vk.beta2) + encode_g2_compressed(vk.gamma2)
    out += encode_g1_compressed(None) + encode_g2_compressed(vk.delta2)
    out += len(vk.ic).to_bytes(4, "big")
    return out + b"".join(encode_g1_compressed(p) for p in vk.ic)


def dump_groth16_proof(proof, vk_bytes: bytes) -> bytes:
    """A Groth16 proof (``snark.groth16.ProofG16``) in gnark's wire layout,
    prefixed with the first 4 bytes of sha256 of the gnark vk bytes."""
    return (hashlib.sha256(vk_bytes).digest()[:4] + encode_g1_uncompressed(proof.a)
            + encode_g2_uncompressed(proof.b) + encode_g1_uncompressed(proof.c))


# ---------------------------------------------------------------------------
# vk / proof loading (converter.rs layouts)
# ---------------------------------------------------------------------------


@dataclass
class GnarkGroth16Vk:
    alpha: tuple  # G1
    beta: tuple  # G2 (original sign)
    gamma: tuple  # G2
    delta: tuple  # G2
    k: list  # G1 input commitments


@dataclass
class GnarkGroth16Proof:
    ar: tuple
    bs: tuple
    krs: tuple


def load_groth16_vk(buf: bytes) -> GnarkGroth16Vk:
    alpha = decode_g1_compressed(buf[:32])
    beta = decode_g2_compressed(buf[64:128])
    gamma = decode_g2_compressed(buf[128:192])
    delta = decode_g2_compressed(buf[224:288])
    n_k = int.from_bytes(buf[288:292], "big")
    k, off = [], 292
    for _ in range(n_k):
        k.append(decode_g1_compressed(buf[off : off + 32]))
        off += 32
    return GnarkGroth16Vk(alpha, beta, gamma, delta, k)


def load_groth16_proof(buf: bytes) -> GnarkGroth16Proof:
    return GnarkGroth16Proof(
        ar=decode_g1_uncompressed(buf[:64]),
        bs=decode_g2_uncompressed(buf[64:192]),
        krs=decode_g1_uncompressed(buf[192:256]),
    )


# ---------------------------------------------------------------------------
# verification (verify.rs + utils.rs)
# ---------------------------------------------------------------------------


def hash_public_inputs(public_values: bytes) -> int:
    """sha256 masked into the BN254 scalar field (utils.rs:7-15)."""
    d = bytearray(hashlib.sha256(public_values).digest())
    d[0] &= 0x1F
    return int.from_bytes(bytes(d), "big")


def verify_gnark_groth16_algebraic(vk: GnarkGroth16Vk, proof: GnarkGroth16Proof,
                                   public_inputs: list) -> bool:
    if len(public_inputs) + 1 != len(vk.k):
        raise GnarkDecodeError("public input count mismatch")
    acc = vk.k[0]
    for x, kp in zip(public_inputs, vk.k[1:]):
        acc = ec.g1_add(acc, ec.g1_mul(kp, x % ec.R))
    return ec.pairing_product_is_one([
        (ec.g1_neg(proof.ar), proof.bs),
        (acc, vk.gamma),
        (proof.krs, vk.delta),
        (vk.alpha, vk.beta),
    ])


def verify_gnark_groth16(proof_bytes: bytes, zkm_public_values: bytes,
                         zkm_vkey_hash: "str | bytes", groth16_vk_bytes: bytes) -> bool:
    """Groth16Verifier::verify analog (groth16/mod.rs:53-81): checks the
    4-byte vk-hash prefix, then verifies against
    [vkey_hash, sha256(public_values)] as the two public inputs."""
    vk_hash4 = hashlib.sha256(groth16_vk_bytes).digest()[:4]
    if proof_bytes[:4] != vk_hash4:
        raise GnarkDecodeError("groth16 vk hash prefix mismatch")
    if isinstance(zkm_vkey_hash, str):
        zkm_vkey_hash = bytes.fromhex(zkm_vkey_hash.removeprefix("0x"))
    vkey_fr = int.from_bytes(zkm_vkey_hash[1:], "big")  # utils.rs:20 drops byte 0
    inputs = [vkey_fr, hash_public_inputs(zkm_public_values)]
    vk = load_groth16_vk(groth16_vk_bytes)
    proof = load_groth16_proof(proof_bytes[4:])
    return verify_gnark_groth16_algebraic(vk, proof, inputs)
