"""Bindings of the hand-written Poseidon2 CUDA kernels (``csrc/poseidon2.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, cached in ``build/kernels/`` at the
root of the checkout (keyed by a hash of the source and flags), and loaded
with ctypes.  Kernels launch on PyTorch's current stream; every launch is
checked with ``cudaGetLastError`` and a failure raises.  Nothing here falls
back to the plain torch versions in ``poseidon2``.

``LAUNCHES`` counts launches per kernel, so a run can show that a path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from . import poseidon2 as p2

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "poseidon2.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES = {"poseidon2_hash_rows": 0, "poseidon2_compress": 0, "poseidon2_permute": 0}

_LIB = None
_CONSTANTS_ON: set = set()  # device indices whose constant memory is loaded


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile the kernels (once per source version); returns the library path.

    The compiler's output (``-Xptxas=-v``: registers and spills per kernel)
    is kept beside the library as ``<name>.log``."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libzkm_poseidon2-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.zkm_p2_error_string.argtypes = [ctypes.c_int]
        lib.zkm_p2_error_string.restype = ctypes.c_char_p
        lib.zkm_p2_set_constants.argtypes = [ptr, ptr]
        lib.zkm_p2_hash_rows.argtypes = [ptr, i64, i64, ptr, ptr]
        lib.zkm_p2_compress.argtypes = [ptr, i64, ptr, ptr]
        lib.zkm_p2_permute.argtypes = [ptr, i64, ptr, ptr]
        for fn in (lib.zkm_p2_set_constants, lib.zkm_p2_hash_rows,
                   lib.zkm_p2_compress, lib.zkm_p2_permute):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(lib, err: int, what: str):
    if err != 0:
        msg = lib.zkm_p2_error_string(err).decode()
        raise RuntimeError(f"poseidon2 {what}: CUDA error {err} ({msg})")


def _ready(device: torch.device):
    """The loaded library, with the round constants in ``device``'s memory."""
    lib = _lib()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _CONSTANTS_ON:
        rc, diag = p2.kernel_constants()
        with torch.cuda.device(idx):
            _check(lib, lib.zkm_p2_set_constants(rc.ctypes.data, diag.ctypes.data), "set_constants")
        _CONSTANTS_ON.add(idx)
    return lib


def _validated(t: torch.Tensor, width: int | None, what: str) -> torch.Tensor:
    if not t.is_cuda:
        raise ValueError(f"poseidon2 {what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"poseidon2 {what}: expected torch.int32, got {t.dtype}")
    if t.dim() != 2 or (width is not None and t.shape[1] != width):
        raise ValueError(f"poseidon2 {what}: bad shape {tuple(t.shape)}")
    return t.contiguous()


def _launch(name: str, fn, inp: torch.Tensor, out: torch.Tensor, *extra):
    if inp.shape[0] == 0:
        return out
    lib = _ready(inp.device)
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    err = getattr(lib, fn)(inp.data_ptr(), inp.shape[0], *extra, out.data_ptr(), stream)
    _check(lib, err, name)
    LAUNCHES[name] += 1
    return out


def hash_rows(mat: torch.Tensor) -> torch.Tensor:
    """Sponge digest of every row: (n, w) int32 -> (n, 8)."""
    mat = _validated(mat, None, "hash_rows")
    out = torch.empty((mat.shape[0], p2.OUT), dtype=torch.int32, device=mat.device)
    return _launch("poseidon2_hash_rows", "zkm_p2_hash_rows", mat, out, mat.shape[1])


def compress(pairs: torch.Tensor) -> torch.Tensor:
    """2-to-1 compression of (left || right) rows: (n, 16) -> (n, 8)."""
    pairs = _validated(pairs, p2.WIDTH, "compress")
    out = torch.empty((pairs.shape[0], p2.OUT), dtype=torch.int32, device=pairs.device)
    return _launch("poseidon2_compress", "zkm_p2_compress", pairs, out)


def permute(states: torch.Tensor) -> torch.Tensor:
    """Full permutation: (n, 16) -> (n, 16)."""
    states = _validated(states, p2.WIDTH, "permute")
    out = torch.empty_like(states)
    return _launch("poseidon2_permute", "zkm_p2_permute", states, out)
