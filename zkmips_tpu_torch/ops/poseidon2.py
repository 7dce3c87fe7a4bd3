"""Poseidon2 over KoalaBear, width 16, s-box x^3 (8 external + 13 internal rounds).

Three forms of the same permutation:

* ``permute_ints``: Python ints, for the host transcript (one state at a time);
* ``*_plain``: plain torch on any device, the reference the kernels are held
  against (the CPU tests and ``chip_smoke.py``'s comparison phase);
* ``permute`` / ``hash_matrix_rows`` / ``compress`` / ``compress_layer``: the
  entry points.  On a CUDA tensor they launch the hand-written kernels of
  ``poseidon2_cuda`` (and raise if those fail); on a CPU tensor they run the
  plain version.

The external MDS-light layer is the fixed integer matrix kron(I + J, M4)
(entries <= 6, row sums 35), applied as one float64 product: every partial
sum stays below 2^37 < 2^53, so the result is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as f
from ._poseidon2_rc import RC_16_30

WIDTH = 16
RATE = 8
OUT = 8
ROUNDS_F = 8
ROUNDS_P = 13

_RC = [[f.to_monty_int(c) for c in row] for row in RC_16_30]
RC_EXT_FIRST = _RC[0:4]
RC_INTERNAL = [_RC[r][0] for r in range(4, 17)]
RC_EXT_SECOND = _RC[17:21]

_p = f.P
_DIAG_CANON = [
    _p - 2, 1, 2, (_p + 1) >> 1, 3, 4, (_p - 1) >> 1, _p - 3, _p - 4,
    _p - ((_p - 1) >> 8), _p - ((_p - 1) >> 3), _p - 127,
    (_p - 1) >> 8, (_p - 1) >> 3, (_p - 1) >> 4, 127,
]
DIAG = [f.to_monty_int(c) for c in _DIAG_CANON]

_M4 = np.array([[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]], dtype=np.int64)
# out = M4 per 4-lane group, plus the per-position sums across the 4 groups
EXT_MATRIX = np.kron(np.eye(4, dtype=np.int64) + np.ones((4, 4), dtype=np.int64), _M4)
_EXT_ROWS = [[int(c) for c in row] for row in EXT_MATRIX]


def kernel_constants() -> np.ndarray:
    """(21, 16) round constants (internal rounds on lane 0, zeros elsewhere),
    Montgomery uint32, for the CUDA kernels.  The diagonal is not passed: the
    kernels' internal round is written for ``_DIAG_CANON`` lane by lane."""
    rc = np.zeros((21, 16), dtype=np.uint32)
    rc[0:4] = RC_EXT_FIRST
    rc[4:17, 0] = RC_INTERNAL
    rc[17:21] = RC_EXT_SECOND
    return rc


# Words at which arithmetic that reduces lazily is most likely to go wrong:
# the ends of the field, its middle, and the powers of two of p = 2^31 - 2^24 + 1.
EDGE_WORDS = (0, 1, _p - 1, _p - 2, (_p - 1) >> 1, (_p + 1) >> 1,
              (1 << 24) - 1, 1 << 24, (1 << 31) - (1 << 24))


def edge_matrix(width: int, seed: int, mixed_rows: int = 64) -> np.ndarray:
    """(len(EDGE_WORDS) + mixed_rows, width) uint32: one row filled with each
    edge word, then rows that mix edge words with random field elements."""
    rng = np.random.default_rng(seed)
    const = np.repeat(np.array(EDGE_WORDS, dtype=np.uint32)[:, None], width, axis=1)
    rand = rng.integers(0, _p, size=(mixed_rows, width), dtype=np.int64).astype(np.uint32)
    edge = np.array(EDGE_WORDS, dtype=np.uint32)[rng.integers(0, len(EDGE_WORDS), size=rand.shape)]
    mixed = np.where(rng.random(rand.shape) < 0.5, edge, rand)
    return np.concatenate([const, mixed], axis=0)


# ---------------------------------------------------------------------------
# Python-int permutation (host transcript)
# ---------------------------------------------------------------------------


def _sbox_int(x: int) -> int:
    return f.mul64(f.mul64(x, x), x)


def _ext_linear_ints(s: list) -> list:
    return [sum(c * v for c, v in zip(row, s)) % _p for row in _EXT_ROWS]


def permute_ints(state: list) -> list:
    """Poseidon2 on one state of 16 Montgomery ints."""
    s = _ext_linear_ints(list(state))
    for rc in RC_EXT_FIRST:
        s = _ext_linear_ints([_sbox_int((v + c) % _p) for v, c in zip(s, rc)])
    for rc in RC_INTERNAL:
        s[0] = _sbox_int((s[0] + rc) % _p)
        total = sum(s)
        s = [(f.mul64(v, d) + total) % _p for v, d in zip(s, DIAG)]
    for rc in RC_EXT_SECOND:
        s = _ext_linear_ints([_sbox_int((v + c) % _p) for v, c in zip(s, rc)])
    return s


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

_TABLES: dict = {}


def _tables(device):
    key = str(device)
    t = _TABLES.get(key)
    if t is None:
        i64 = dict(dtype=torch.int64, device=device)
        t = (
            torch.tensor(EXT_MATRIX.T, dtype=torch.float64, device=device),
            torch.tensor(RC_EXT_FIRST, **i64),
            torch.tensor(RC_INTERNAL, **i64),
            torch.tensor(RC_EXT_SECOND, **i64),
            torch.tensor(DIAG, **i64),
        )
        _TABLES[key] = t
    return t


def _sbox64(x):
    return f.mul64(f.mul64(x, x), x)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on (..., 16) Montgomery states, plain torch."""
    ext_t, rc1, rci, rc2, diag = _tables(state.device)

    def ext_linear(s):
        return (s.to(torch.float64) @ ext_t).to(torch.int64) % _p

    s = ext_linear(state.to(torch.int64))
    for r in range(4):
        s = ext_linear(_sbox64((s + rc1[r]) % _p))
    for r in range(ROUNDS_P):
        lane0 = _sbox64((s[..., 0:1] + rci[r]) % _p)
        s = torch.cat([lane0, s[..., 1:]], dim=-1)
        s = (f.mul64(s, diag) + s.sum(-1, keepdim=True)) % _p
    for r in range(4):
        s = ext_linear(_sbox64((s + rc2[r]) % _p))
    return f.narrow(s)


def hash_matrix_rows_plain(mat: torch.Tensor) -> torch.Tensor:
    """PaddingFreeSponge<16, 8, 8> over each row of (n, w): rate-8 chunks are
    absorbed by overwrite (a short final chunk overwrites only its prefix),
    one permutation per chunk; returns the first 8 lanes."""
    n, w = mat.shape
    state = torch.zeros((n, WIDTH), dtype=torch.int32, device=mat.device)
    for start in range(0, w, RATE):
        chunk = min(RATE, w - start)
        state = state.clone()
        state[:, :chunk] = mat[:, start : start + chunk]
        state = permute_plain(state)
    return state[:, :OUT].contiguous()


def compress_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """TruncatedPermutation<2, 8, 16>: (..., 8) x 2 -> (..., 8)."""
    return permute_plain(torch.cat([left, right], dim=-1))[..., :OUT].contiguous()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on (n, 16) states."""
    if state.is_cuda:
        from . import poseidon2_cuda

        return poseidon2_cuda.permute(state)
    return permute_plain(state)


def hash_matrix_rows(mat: torch.Tensor) -> torch.Tensor:
    """Row digests (n, w) -> (n, 8)."""
    if mat.is_cuda:
        from . import poseidon2_cuda

        return poseidon2_cuda.hash_rows(mat)
    return hash_matrix_rows_plain(mat)


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """2-to-1 digest compression, (n, 8) x 2 -> (n, 8)."""
    if left.is_cuda:
        from . import poseidon2_cuda

        return poseidon2_cuda.compress(left, right)
    return compress_plain(left, right)


def compress_layer(layer: torch.Tensor) -> torch.Tensor:
    """One Merkle level: a contiguous (n, 8) layer, n even -> (n/2, 8), digest
    i from rows 2i and 2i + 1.  On a CUDA tensor the kernel reads the pairs
    from the layer's own memory: no slice and no copy."""
    if layer.is_cuda:
        from . import poseidon2_cuda

        return poseidon2_cuda.compress_layer(layer)
    return compress_plain(layer[0::2], layer[1::2])


def hash_flat(values: torch.Tensor) -> torch.Tensor:
    """Sponge digest of a flat vector -> (8,)."""
    return hash_matrix_rows(values.reshape(1, -1))[0]


# ---------------------------------------------------------------------------
# Host helpers on canonical ints (the recursion ladder's digests)
# ---------------------------------------------------------------------------


def hash_canonical(values) -> list:
    """``hash_flat`` of canonical felts, on the host: canonical digest (8 ints)."""
    m = torch.tensor([f.to_monty_int(int(v) % _p) for v in values], dtype=torch.int32)
    return [f.from_monty_int(x) for x in hash_flat(m).tolist()]


def compress_canonical(left, right) -> list:
    """``compress`` of two canonical 8-felt digests, on the host."""
    state = [f.to_monty_int(int(v) % _p) for v in list(left) + list(right)]
    return [f.from_monty_int(x) for x in permute_ints(state)[:OUT]]
