"""Elliptic curve parameters and pure-int affine arithmetic for precompiles.

Host-side analog of crates/curves: curve parameter tables (reference
crates/curves/src/weierstrass/{secp256k1,secp256r1,bn254,bls12_381}.rs,
edwards/ed25519.rs) and the affine group laws used by the ec precompile
syscalls (AffinePoint ops, crates/curves/src/lib.rs).  Python bigints stand
in for the reference's BigUint; coordinates travel as little-endian u32 word
lists, matching guest memory layout.
"""

from __future__ import annotations

from dataclasses import dataclass


def words_to_int(words) -> int:
    v = 0
    for i, w in enumerate(words):
        v |= int(w) << (32 * i)
    return v


def int_to_words(v: int, nwords: int):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(nwords)]


@dataclass(frozen=True)
class WeierstrassCurve:
    """y^2 = x^3 + a*x + b over F_p; nwords u32 words per coordinate."""

    name: str
    p: int
    a: int
    b: int
    nwords: int

    def add(self, p1, p2):
        (x1, y1), (x2, y2) = p1, p2
        p = self.p
        if x1 == x2:
            if (y1 + y2) % p == 0:
                raise ValueError(f"{self.name}: sum is the point at infinity")
            return self.double(p1)
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return x3, (lam * (x1 - x3) - y1) % p

    def double(self, pt):
        x1, y1 = pt
        p = self.p
        if y1 == 0:
            raise ValueError(f"{self.name}: doubling a 2-torsion point")
        lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
        x3 = (lam * lam - 2 * x1) % p
        return x3, (lam * (x1 - x3) - y1) % p

    def decompress(self, x: int, sign: int) -> tuple[int, int]:
        """y with parity == sign (k256/p256/bls conventions all use y-odd)."""
        p = self.p
        rhs = (x * x * x + self.a * x + self.b) % p
        assert p % 4 == 3
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p != rhs:
            raise ValueError(f"{self.name}: x is not on the curve")
        if (y & 1) != (sign & 1):
            y = p - y
        return x, y


SECP256K1 = WeierstrassCurve(
    "secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    nwords=8,
)
SECP256R1 = WeierstrassCurve(
    "secp256r1",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=-3,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    nwords=8,
)
BN254 = WeierstrassCurve(
    "bn254",
    p=0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
    a=0,
    b=3,
    nwords=8,
)
BLS12381 = WeierstrassCurve(
    "bls12381",
    p=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    a=0,
    b=4,
    nwords=12,
)

# Field-only parameters for the fptower precompiles (BLS12381_FP* / BN254_FP*).
FP_MOD = {"bls12381": (BLS12381.p, 12), "bn254": (BN254.p, 8)}


# --- Ed25519 (twisted Edwards, -x^2 + y^2 = 1 + d x^2 y^2) ------------------

ED_P = (1 << 255) - 19
ED_D = 37095705934669439343138083508754565189542113879843219016388785533085940283555
_ED_SQRT_M1 = pow(2, (ED_P - 1) // 4, ED_P)


def ed_add(p1, p2):
    (x1, y1), (x2, y2) = p1, p2
    p = ED_P
    t = ED_D * x1 * x2 % p * y1 * y2 % p
    x3 = (x1 * y2 + x2 * y1) * pow(1 + t, -1, p) % p
    y3 = (y1 * y2 + x1 * x2) * pow(1 - t, -1, p) % p
    return x3, y3


def ed_decompress(y: int, sign: int) -> tuple[int, int]:
    """RFC 8032 §5.1.3 point decoding: recover x from y and the sign bit."""
    p = ED_P
    if y >= p:
        raise ValueError("ed25519: y out of range")
    u = (y * y - 1) % p
    v = (ED_D * y * y + 1) % p
    x = u * pow(v, 3, p) % p * pow(u * pow(v, 7, p) % p, (p - 5) // 8, p) % p
    if v * x * x % p == (-u) % p:
        x = x * _ED_SQRT_M1 % p
    elif v * x * x % p != u:
        raise ValueError("ed25519: not a valid y coordinate")
    if x == 0 and sign:
        raise ValueError("ed25519: sign bit set with x == 0")
    if (x & 1) != (sign & 1):
        x = p - x
    return x, y
