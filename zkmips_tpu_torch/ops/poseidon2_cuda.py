"""Bindings of the hand-written Poseidon2 CUDA kernels (``csrc/poseidon2.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, cached in ``build/kernels/`` at the
root of the checkout (keyed by a hash of the source and flags), and loaded
with ctypes.  Kernels launch on PyTorch's current stream; every launch is
checked with ``cudaGetLastError`` and a failure raises.  Nothing here falls
back to the plain torch versions in ``poseidon2``.

``LAUNCHES`` counts launches per kernel, so a run can show that a path went
through the kernels.  ``sass_counts`` reports how many machine instructions
each built kernel has (the kernels are bound by integer issue slots, so that
count is what a redesign moves).  ``build`` and ``load`` take any version of
the source or library, so a script can bind two and compare them on one card
without touching the handle the wrappers here use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
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
_COUNT_LOCK = threading.Lock()  # shards proved in several threads launch side by side

_LIB = None
_CONSTANTS_ON: set = set()  # device indices whose constant memory is loaded


# (rows, width) of every matrix ``hash_rows`` launched on since the last
# reset: the leaf shapes a path gives K1
HASH_SHAPES: set = set()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    HASH_SHAPES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(source: Path | None = None) -> Path:
    """Compile the kernels (once per source version); returns the library path.

    The compiler's output (``-Xptxas=-v``: registers and spills per kernel)
    is kept beside the library as ``<name>.log``."""
    source = Path(source or SOURCE)
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libzkm_poseidon2-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


_SASS_LINE = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_.]*)")
_KERNEL_NAMES = (
    ("hash_rows_kernel", "hash_rows_kernel"),
    ("permute_kernelILi8E", "permute_kernel<8>"),
    ("permute_kernelILi16E", "permute_kernel<16>"),
)


def disassemble(lib: Path | None = None) -> str | None:
    """``cuobjdump -sass`` of the built library (or any CUDA binary); None
    where the toolkit has no ``cuobjdump`` or it fails."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    proc = subprocess.run([str(tool), "-sass", str(lib or build())], capture_output=True, text=True)
    return proc.stdout if proc.returncode == 0 else None


def sass_counts(lib: Path | None = None) -> dict | None:
    """Machine instructions of each kernel in the built library, from its
    disassembly: ``{kernel: {"total": n, "by_op": {opcode: n}}}``, opcodes
    with their modifiers (``IMAD.WIDE.U32`` is not ``IMAD``); ``NOP`` padding
    left out; a loop's body counts once.  None where there is no
    disassembly: this is a report, nothing depends on it."""
    text = disassemble(lib)
    if text is None:
        return None
    out: dict = {}
    ops = None
    for line in text.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            name = next((nice for key, nice in _KERNEL_NAMES if key in mangled), mangled)
            ops = out.setdefault(name, {})
            continue
        m = _SASS_LINE.match(line)
        if m and ops is not None and m.group(1) != "NOP":
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return {
        k: {"total": sum(v.values()), "by_op": dict(sorted(v.items(), key=lambda kv: -kv[1]))}
        for k, v in out.items()
    }


def load(path: Path) -> ctypes.CDLL:
    """A built library's C interface, typed.  Its constant memory is not yet
    loaded: call ``zkm_p2_set_constants`` once per device."""
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.zkm_p2_error_string.argtypes = [ctypes.c_int]
    lib.zkm_p2_error_string.restype = ctypes.c_char_p
    lib.zkm_p2_set_constants.argtypes = [ptr]
    lib.zkm_p2_hash_rows.argtypes = [ptr, i64, i64, ptr, ptr]
    lib.zkm_p2_compress.argtypes = [ptr, ptr, i64, i64, ptr, ptr]
    lib.zkm_p2_permute.argtypes = [ptr, i64, ptr, ptr]
    for fn in (lib.zkm_p2_set_constants, lib.zkm_p2_hash_rows,
               lib.zkm_p2_compress, lib.zkm_p2_permute):
        fn.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = load(build())
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
        rc = p2.kernel_constants()
        with torch.cuda.device(idx):
            _check(lib, lib.zkm_p2_set_constants(rc.ctypes.data), "set_constants")
        _CONSTANTS_ON.add(idx)
    return lib


def _validated(t: torch.Tensor, width: int | None, what: str) -> torch.Tensor:
    """``t`` after the checks every wrapper makes, contiguous (a copy if it
    was not)."""
    return _checked(t, width, what).contiguous()


def _checked(t: torch.Tensor, width: int | None, what: str) -> torch.Tensor:
    if not t.is_cuda:
        raise ValueError(f"poseidon2 {what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"poseidon2 {what}: expected torch.int32, got {t.dtype}")
    if t.dim() != 2 or (width is not None and t.shape[1] != width):
        raise ValueError(f"poseidon2 {what}: bad shape {tuple(t.shape)}")
    return t


def _launch(name: str, fn: str, out: torch.Tensor, *args):
    """Launch ``fn(*args, out, stream)`` on ``out``'s device, one row of
    ``out`` per thread; counts the launch."""
    if out.shape[0] == 0:
        return out
    lib = _ready(out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _check(lib, getattr(lib, fn)(*args, out.data_ptr(), stream), name)
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
    return out


def _digests(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty((n, p2.OUT), dtype=torch.int32, device=like.device)


def hash_rows(mat: torch.Tensor) -> torch.Tensor:
    """Sponge digest of every row: (n, w) int32 -> (n, 8)."""
    mat = _validated(mat, None, "hash_rows")
    n, w = mat.shape
    HASH_SHAPES.add((n, w))
    return _launch("poseidon2_hash_rows", "zkm_p2_hash_rows", _digests(n, mat), mat.data_ptr(), n, w)


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """2-to-1 compression of row i of ``left`` with row i of ``right``:
    (n, 8) x 2 -> (n, 8).  The kernel reads both where they lie when their
    rows are unbroken and equally far apart (two contiguous matrices, or the
    even and odd rows of one); any other layout is copied first."""
    left = _checked(left, p2.OUT, "compress")
    right = _checked(right, p2.OUT, "compress")
    if left.shape != right.shape or left.device != right.device:
        raise ValueError(f"poseidon2 compress: {tuple(left.shape)} on {left.device} "
                         f"against {tuple(right.shape)} on {right.device}")
    n = left.shape[0]
    if left.stride() != right.stride() or left.stride(1) != 1:
        left, right = left.contiguous(), right.contiguous()
    return _launch("poseidon2_compress", "zkm_p2_compress", _digests(n, left),
                   left.data_ptr(), right.data_ptr(), left.stride(0), n)


def compress_layer(layer: torch.Tensor) -> torch.Tensor:
    """One Merkle level: (n, 8), n even -> (n/2, 8), digest i from rows 2i
    and 2i + 1, read from the layer's own memory (a contiguous layer is
    already the (n/2, 16) matrix of pairs)."""
    layer = _validated(layer, p2.OUT, "compress_layer")
    if layer.shape[0] % 2:
        raise ValueError(f"poseidon2 compress_layer: odd number of rows {layer.shape[0]}")
    n = layer.shape[0] // 2
    base = layer.data_ptr()
    return _launch("poseidon2_compress", "zkm_p2_compress", _digests(n, layer),
                   base, base + 4 * p2.OUT, p2.WIDTH, n)


def permute(states: torch.Tensor) -> torch.Tensor:
    """Full permutation: (n, 16) -> (n, 16)."""
    states = _validated(states, p2.WIDTH, "permute")
    return _launch("poseidon2_permute", "zkm_p2_permute", torch.empty_like(states),
                   states.data_ptr(), states.shape[0])
