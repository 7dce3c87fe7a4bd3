"""Bit-reversal permutations and modular sums.

Committed LDE matrices are stored in bit-reversed row order, so the FRI
fold pairs f(x), f(-x) are adjacent rows.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as f

_BITREV_CACHE: dict = {}


def bitrev_indices(log_n: int, device="cpu") -> torch.Tensor:
    """int64 permutation i -> reverse of i's low log_n bits."""
    key = (log_n, str(device))
    idx = _BITREV_CACHE.get(key)
    if idx is None:
        n = 1 << log_n
        i = np.arange(n, dtype=np.int64)
        rev = np.zeros(n, dtype=np.int64)
        for b in range(log_n):
            rev |= ((i >> b) & 1) << (log_n - 1 - b)
        idx = torch.from_numpy(rev).to(device)
        _BITREV_CACHE[key] = idx
    return idx


def bitrev_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of (n, ...) in bit-reversed order (an involution)."""
    n = x.shape[0]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "bitrev needs power-of-two height"
    return x[bitrev_indices(log_n, x.device)]


def sum_mod(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Field sum along ``dim`` (exact in int64 for up to 2^32 terms)."""
    return f.narrow(x.to(torch.int64).sum(dim) % f.P)


def powers_canonical_np(base: int, n: int) -> np.ndarray:
    """[1, b, ..., b^(n-1)] canonical, uint64 numpy (host precompute)."""
    out = np.ones(1, dtype=np.uint64)
    cur = base % f.P
    while out.shape[0] < n:
        out = np.concatenate([out, (out * cur) % f.P])
        cur = cur * cur % f.P
    return out[:n]


def powers_monty_np(base: int, n: int) -> np.ndarray:
    """[1, b, ..., b^(n-1)] in Montgomery form, uint32 numpy."""
    return ((powers_canonical_np(base, n) << np.uint64(32)) % f.P).astype(np.uint32)


def powers_monty(base: int, n: int, device="cpu") -> torch.Tensor:
    """[1, b, ..., b^(n-1)] in Montgomery form, int32 on ``device``."""
    return f.batch_powers(base, n, device)
