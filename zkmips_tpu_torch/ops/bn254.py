"""BN254 scalar field + Poseidon2 width-3 + multi-field sponge (outer config).

The wrap stage re-proves the shrink proof under a BN254-friendly STARK
config: trace values stay KoalaBear, but Merkle hashing and the Fiat-Shamir
transcript run over the BN254 scalar field, so the final proof is cheap to
verify inside a BN254 SNARK (reference:
crates/recursion/core/src/stark/config.rs:23-103 ``KoalaBearPoseidon2Outer``).

* ``permute3`` -- Poseidon2 over Fr(BN254), width 3, 8 external + 56
  internal rounds, x^5 s-box, external matrix circ(2,1,1), internal diagonal
  (1,1,2); the round constants are the public HorizenLabs instance
  (``_poseidon2_bn254_rc.py``).
* ``hash_felts`` -- the MultiField32PaddingFreeSponge: KoalaBear felts in
  blocks of 16, each block packed 8 per Fr with a 2^32 stride, overwriting
  state[0..1], one permutation per block, digest = state[0].
* ``compress`` -- the TruncatedPermutation: state = [l, r, 0], permute,
  digest = state[0].

This is host code on Python ints: the outer config's transcript is short.
The batched row hashes of its Merkle trees run in C (``bn254_native``).
"""

from __future__ import annotations

import numpy as np

from . import bn254_native
from ._poseidon2_bn254_rc import RC3

# BN254 (alt_bn128) scalar field modulus.
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

ROUNDS_F = 8
ROUNDS_P = 56
HALF_F = ROUNDS_F // 2

# external rounds use all 3 lanes, internal rounds lane 0 only
_RC_EXT_FIRST = [RC3[r] for r in range(HALF_F)]
_RC_INT = [RC3[HALF_F + r][0] for r in range(ROUNDS_P)]
_RC_EXT_LAST = [RC3[HALF_F + ROUNDS_P + r] for r in range(HALF_F)]


def _sbox(x: int) -> int:
    x2 = x * x % P
    x4 = x2 * x2 % P
    return x4 * x % P


def _ext_mat(s0: int, s1: int, s2: int):
    t = s0 + s1 + s2
    return (s0 + t) % P, (s1 + t) % P, (s2 + t) % P


def permute3(state) -> list[int]:
    """Poseidon2-BN254 width-3 permutation on canonical ints."""
    s0, s1, s2 = int(state[0]) % P, int(state[1]) % P, int(state[2]) % P
    s0, s1, s2 = _ext_mat(s0, s1, s2)
    for rc in _RC_EXT_FIRST:
        s0, s1, s2 = _sbox(s0 + rc[0]), _sbox(s1 + rc[1]), _sbox(s2 + rc[2])
        s0, s1, s2 = _ext_mat(s0, s1, s2)
    for rc in _RC_INT:
        s0 = _sbox(s0 + rc)
        t = s0 + s1 + s2
        s0, s1, s2 = (s0 + t) % P, (s1 + t) % P, (2 * s2 + t) % P
    for rc in _RC_EXT_LAST:
        s0, s1, s2 = _sbox(s0 + rc[0]), _sbox(s1 + rc[1]), _sbox(s2 + rc[2])
        s0, s1, s2 = _ext_mat(s0, s1, s2)
    return [s0, s1, s2]


# ---------------------------------------------------------------------------
# Multi-field sponge over KoalaBear inputs
# ---------------------------------------------------------------------------

RATE_FELTS = 16  # KoalaBear felts absorbed per permutation
PACK = 8  # felts packed per Fr when hashing (floor(254 / 31))
CHALLENGER_PACK = 3  # felts packed per Fr in the challenger (floor(254 / 64))
CHALLENGER_RATE = 2  # Fr slots absorbed per duplex


def reduce_32(vals) -> int:
    """Pack 32-bit KoalaBear canonical values into one Fr: sum v_i * 2^(32 i)."""
    acc = 0
    for i, v in enumerate(vals):
        acc += int(v) << (32 * i)
    return acc % P


def split_32(val: int, n: int) -> list[int]:
    """Split an Fr into n KoalaBear felts: 64-bit windows of the low 256
    bits, each reduced mod the KoalaBear prime."""
    from . import field as f

    out = []
    v = int(val) & ((1 << 256) - 1)
    for i in range(n):
        out.append(((v >> (64 * i)) & ((1 << 64) - 1)) % f.P)
    return out


def hash_felts(felts) -> int:
    """Hash KoalaBear canonical values to one Fr digest (padding-free sponge)."""
    state = [0, 0, 0]
    vals = [int(v) for v in np.asarray(felts, dtype=np.uint64).reshape(-1)]
    for i in range(0, len(vals), RATE_FELTS):
        block = vals[i : i + RATE_FELTS]
        for chunk_id in range(0, len(block), PACK):
            state[chunk_id // PACK] = reduce_32(block[chunk_id : chunk_id + PACK])
        state = permute3(state)
    return state[0]


def compress(left: int, right: int) -> int:
    return permute3([left, right, 0])[0]


# ---------------------------------------------------------------------------
# Batched paths (csrc/bn254.c)
# ---------------------------------------------------------------------------


def hash_felts_rows(rows: np.ndarray) -> list[int]:
    """``hash_felts`` over every row of a canonical uint32 matrix."""
    return bn254_native.unpack_fr(bn254_native.hash_felts_rows(rows))


def compress_rows(left: list[int], right: list[int]) -> list[int]:
    """``compress`` over digest pairs."""
    if not left:
        return []
    return bn254_native.unpack_fr(
        bn254_native.compress_rows(bn254_native.pack_fr(left), bn254_native.pack_fr(right))
    )
