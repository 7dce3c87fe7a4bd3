"""ctypes bridge to the BN254 Poseidon2 batch hashes of ``csrc/bn254.c``.

Binds the two functions the outer config's Merkle trees need: the
multi-field sponge over rows of canonical KoalaBear values
(``zkm_bn254_hash_felts_rows``) and the 2-to-1 compression of digest pairs
(``zkm_bn254_compress_rows``).  Digests cross the boundary as (n, 4) uint64
arrays: the canonical BN254 scalar, 64-bit limbs little-endian.  The C
source is compiled with OpenMP where it lies into ``build/native/`` at first
use; a failed build or load raises.  ``lib()`` is the one loaded library,
which ``snark/native`` binds for the MSMs and Fr FFTs of the SNARK link.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.cbuild import REPO_ROOT, build
from ._poseidon2_bn254_rc import RC3

_LIB = None
_RC = None
_SRC = os.path.join(str(REPO_ROOT), "csrc", "bn254.c")
_U64 = ctypes.POINTER(ctypes.c_uint64)


def lib():
    """The loaded ``bn254.c`` library (built at first use; raises if the
    build or the load fails)."""
    global _LIB, _RC
    if _LIB is None:
        _RC = pack_fr([c for row in RC3 for c in row])
        so = ctypes.CDLL(build(_SRC, ("-fopenmp",)))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        so.zkm_bn254_hash_felts_rows.argtypes = [u32p, ctypes.c_int64, ctypes.c_int64, _U64, _U64]
        so.zkm_bn254_hash_felts_rows.restype = None
        so.zkm_bn254_compress_rows.argtypes = [_U64, _U64, ctypes.c_int64, _U64, _U64]
        so.zkm_bn254_compress_rows.restype = None
        _LIB = so
    return _LIB


def pack_fr(vals) -> np.ndarray:
    """Python ints (canonical Fr) -> (n, 4) uint64 limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype=np.uint64).reshape(-1, 4).copy()


def unpack_fr(arr: np.ndarray) -> list[int]:
    """(n, 4) uint64 limbs -> Python ints."""
    a = np.ascontiguousarray(arr, dtype=np.uint64)
    return [int.from_bytes(row.tobytes(), "little") for row in a]


def hash_felts_rows(rows: np.ndarray) -> np.ndarray:
    """(h, w) canonical uint32 rows -> (h, 4) packed digests."""
    so = lib()
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    if rows.ndim != 2:
        raise ValueError(f"rows of shape {rows.shape}, not (h, w)")
    h, w = rows.shape
    out = np.empty((h, 4), dtype=np.uint64)
    if h:
        so.zkm_bn254_hash_felts_rows(
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(h), ctypes.c_int64(w),
            _RC.ctypes.data_as(_U64), out.ctypes.data_as(_U64),
        )
    return out


def compress_rows(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """(n, 4) x 2 packed digests -> (n, 4): compress(left[i], right[i])."""
    so = lib()
    left = np.ascontiguousarray(left, dtype=np.uint64)
    right = np.ascontiguousarray(right, dtype=np.uint64)
    if left.shape != right.shape or left.ndim != 2 or left.shape[1] != 4:
        raise ValueError(f"digest pairs of shapes {left.shape} and {right.shape}, not (n, 4)")
    n = left.shape[0]
    out = np.empty((n, 4), dtype=np.uint64)
    if n:
        so.zkm_bn254_compress_rows(
            left.ctypes.data_as(_U64), right.ctypes.data_as(_U64), ctypes.c_int64(n),
            _RC.ctypes.data_as(_U64), out.ctypes.data_as(_U64),
        )
    return out
