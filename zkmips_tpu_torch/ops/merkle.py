"""Mixed-matrix Merkle commitment (MMCS) over Poseidon2-KoalaBear digests.

Layout (shared by prover and verifier, identical to the reference):
  * matrices of equal height have their rows concatenated, then row-hashed;
  * the leaf layer belongs to the tallest height; after each 2-to-1
    compression, the row digests of matrices whose height equals the new
    layer size are folded in with one more compression.

Layers stay on the matrices' device; openings gather there and come back to
the host as CPU tensors.
"""

from __future__ import annotations

import torch

from . import poseidon2 as p2

DIGEST_SIZE = 8


def _hash_layer(mats):
    mat = mats[0] if len(mats) == 1 else torch.cat(mats, dim=1)
    return p2.hash_matrix_rows(mat)


def build_layers(matrices) -> list:
    """Digest layers bottom-up for a mixed-height batch."""
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
        cur = p2.compress_layer(cur)
        if size in by_height:
            cur = p2.compress(cur, _hash_layer(by_height[size]))
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
    def root(self) -> torch.Tensor:
        return self.digest_layers[-1][0].cpu()

    def open_many(self, indices):
        """Batched openings: ([per-matrix (Q, w)], (Q, L, 8)), CPU tensors."""
        idx = torch.as_tensor(indices, dtype=torch.int64)
        log_max = self.max_height.bit_length() - 1
        dev = self.digest_layers[0].device
        idx_d = idx.to(dev)
        rows = []
        for m in self.matrices:
            log_h = m.shape[0].bit_length() - 1
            rows.append(m[idx_d >> (log_max - log_h)].cpu())
        if log_max == 0:
            return rows, torch.zeros((len(idx), 0, DIGEST_SIZE), dtype=torch.int32)
        sibs = [self.digest_layers[k][(idx_d >> k) ^ 1] for k in range(log_max)]
        return rows, torch.stack(sibs, dim=1).cpu()


def verify_openings(root, indices, dims, rows_per_matrix, siblings) -> torch.Tensor:
    """Batched opening check over Q queries (CPU): returns a (Q,) bool tensor.

    dims: (height, width) per committed matrix in commitment order;
    rows_per_matrix[m]: (Q, w_m); siblings: (Q, L, 8)."""
    idx = torch.as_tensor(indices, dtype=torch.int64)
    max_height = max(h for h, _ in dims)
    log_max = max_height.bit_length() - 1
    by_height: dict[int, list] = {}
    for (h, _w), rows in zip(dims, rows_per_matrix):
        by_height.setdefault(h, []).append(torch.as_tensor(rows, dtype=torch.int32))

    digest = _hash_layer(by_height[max_height])
    size = max_height
    siblings = torch.as_tensor(siblings, dtype=torch.int32)
    for k in range(log_max):
        sib = siblings[:, k]
        bit = ((idx >> k) & 1).bool()[:, None]
        left = torch.where(bit, sib, digest)
        right = torch.where(bit, digest, sib)
        digest = p2.compress(left, right)
        size //= 2
        if size in by_height:
            digest = p2.compress(digest, _hash_layer(by_height[size]))
    return (digest == torch.as_tensor(root, dtype=torch.int32)[None, :]).all(dim=1)
