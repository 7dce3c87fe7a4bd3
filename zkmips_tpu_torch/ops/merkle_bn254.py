"""Mixed-matrix Merkle commitment over Poseidon2-BN254 digests (outer config).

The layout of ``ops/merkle.py`` (equal-height rows concatenated, tallest
first, per-layer injection folds), but each digest is one BN254 scalar: the
multi-field sponge over the row's *canonical* KoalaBear values (reference
``OuterValMmcs``, crates/recursion/core/src/stark/config.rs:30-32).

The tree is built on the host: the committed matrices (Montgomery int32
tensors, on any device) are read back once as canonical values, and the
rows are hashed in C (``bn254_native``).  The digest layers stay (n, 4)
uint64 limb arrays; what leaves the tree -- the root and the opened
siblings -- are numpy object arrays of Python ints with a trailing axis of
1, as the reference holds them.  Opened rows are Montgomery int32 CPU
tensors, as ``ops/merkle.py`` returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bn254_native as nv, field as f
from .bn254 import P as FR_P

DIGEST_SIZE = 1


def _canon_host(m) -> np.ndarray:
    """Montgomery values (tensor or uint32 array) -> canonical uint32 numpy."""
    if isinstance(m, torch.Tensor):
        return f.from_monty(m).cpu().numpy().view(np.uint32)
    return f.from_monty(np.asarray(m, dtype=np.uint32))


def to_objects(packed: np.ndarray) -> np.ndarray:
    """(..., 4) uint64 limbs -> (..., 1) object array of Python ints."""
    flat = nv.unpack_fr(packed.reshape(-1, 4))
    out = np.empty(len(flat), dtype=object)
    out[:] = flat
    return out.reshape(packed.shape[:-1] + (1,))


def from_objects(digests) -> np.ndarray:
    """(..., 1) object array of Python ints -> (..., 4) uint64 limbs,
    reduced mod the BN254 scalar prime as the Python permutation reduces
    its inputs."""
    a = np.asarray(digests)
    return nv.pack_fr([int(v) % FR_P for v in a.reshape(-1)]).reshape(a.shape[:-1] + (4,))


def _hash_layer(mats) -> np.ndarray:
    canon = [_canon_host(m) for m in mats]
    return nv.hash_felts_rows(canon[0] if len(canon) == 1 else np.concatenate(canon, axis=1))


def build_layers(matrices) -> list:
    """Packed digest layers bottom-up for a mixed-height batch."""
    by_height: dict[int, list] = {}
    for m in matrices:
        h = m.shape[0]
        assert h & (h - 1) == 0, "matrix heights must be powers of two"
        by_height.setdefault(h, []).append(m)
    size = max(by_height)
    cur = _hash_layer(by_height[size])
    layers = [cur]
    while size > 1:
        size //= 2
        cur = nv.compress_rows(cur[0::2], cur[1::2])
        if size in by_height:
            cur = nv.compress_rows(cur, _hash_layer(by_height[size]))
        layers.append(cur)
    return layers


class MerkleTree:
    """Prover-side tree: every digest layer is kept for openings."""

    def __init__(self, matrices, layers=None):
        assert matrices, "cannot commit to zero matrices"
        self.matrices = list(matrices)
        self.max_height = max(m.shape[0] for m in self.matrices)
        self.digest_layers = layers if layers is not None else build_layers(self.matrices)

    @property
    def root(self) -> np.ndarray:
        """(1,) object array."""
        return to_objects(self.digest_layers[-1][0:1])[0]

    def open(self, index: int):
        rows, sibs = self.open_many([index])
        return [r[0] for r in rows], sibs[0]

    def open_many(self, indices):
        """([per-matrix (Q, w) Montgomery int32 CPU tensors], (Q, L, 1) object)."""
        idx = torch.as_tensor(indices, dtype=torch.int64)
        log_max = self.max_height.bit_length() - 1
        rows = []
        for m in self.matrices:
            log_h = m.shape[0].bit_length() - 1
            sel = idx >> (log_max - log_h)
            if isinstance(m, torch.Tensor):
                rows.append(m[sel.to(m.device)].cpu())
            else:
                rows.append(torch.from_numpy(np.asarray(m, dtype=np.uint32)[sel.numpy()].view(np.int32)))
        if log_max == 0:
            return rows, np.zeros((len(idx), 0, DIGEST_SIZE), dtype=object)
        ix = idx.numpy()
        sibs = np.stack([self.digest_layers[k][(ix >> k) ^ 1] for k in range(log_max)], axis=1)
        return rows, to_objects(sibs)


def verify_openings(root, indices, dims, rows_per_matrix, siblings) -> np.ndarray:
    """Batched opening check over Q queries; returns a (Q,) bool array.

    dims: (height, width) per committed matrix in commitment order;
    rows_per_matrix[m]: (Q, w_m) Montgomery values; siblings: (Q, L, 1)."""
    idx = np.asarray(torch.as_tensor(indices, dtype=torch.int64).numpy())
    max_height = max(h for h, _ in dims)
    log_max = max_height.bit_length() - 1
    by_height: dict[int, list] = {}
    for (h, _w), rows in zip(dims, rows_per_matrix):
        by_height.setdefault(h, []).append(rows)

    digest = _hash_layer(by_height[max_height])  # (Q, 4)
    sibs = from_objects(siblings)  # (Q, L, 4)
    size = max_height
    for k in range(log_max):
        bit = ((idx >> k) & 1).astype(bool)[:, None]
        sib = sibs[:, k]
        digest = nv.compress_rows(np.where(bit, sib, digest), np.where(bit, digest, sib))
        size //= 2
        if size in by_height:
            digest = nv.compress_rows(digest, _hash_layer(by_height[size]))
    target = int(np.asarray(root).reshape(-1)[0])
    return np.array([v == target for v in nv.unpack_fr(digest)], dtype=bool)
