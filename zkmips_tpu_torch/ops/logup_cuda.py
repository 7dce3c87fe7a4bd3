"""Binding of the LogUp kernels (``csrc/logup.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, cached in ``build/kernels/``
(``utils/cbuild.build_cuda``), and loaded with ctypes.  One call launches the
three kernels of a chip's permutation trace on PyTorch's current stream (the
rows, the scan of the tiles' totals, the tiles' prefixes); each launch is
checked with ``cudaGetLastError`` and a failure raises.  There is no
fallback: ``permutation_trace`` takes CUDA tensors only.  What it runs, a
code tensor of instructions and a table of constants, is compiled from a
chip's lookups by the prover (``stark/logup_tape.py``); this module takes
them as they are.

``LAUNCHES`` counts the launches, ``KERNELS_A_CHIP`` of them a call, so a
run can show that the LogUp trace went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..utils import cbuild

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "logup.cu"

# Scratch for the slots of the rows in flight, as ``quotient_cuda``'s: at
# least one tile of threads, at most the trace.  A row keeps a denominator and
# a running product a lookup, so the budget sets the blocks in flight: on an
# H100 the Cpu chip over 2^20 rows took 3.13 ms at 24 MiB, 2.32 at 48, 2.25
# at 96; KeccakSponge over 2^15 rows 26.7, 15.5 and 9.1 ms.  Far below the
# int64 temporaries of the eager path (over 1 GB for the Cpu chip at 2^20).
SCRATCH_BYTES = 96 << 20

KERNELS_A_CHIP = 3
LAUNCHES = {"logup": 0}
_COUNT_LOCK = threading.Lock()

_LIB = None
_LOCK = threading.Lock()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    return cbuild.build_cuda(SOURCE, "libzkm_logup")


def load(path: Path) -> ctypes.CDLL:
    """A built library's C interface, typed."""
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.zkm_logup_error_string.argtypes = [ctypes.c_int]
    lib.zkm_logup_error_string.restype = ctypes.c_char_p
    lib.zkm_logup_threads.restype = ctypes.c_int
    lib.zkm_logup_trace.argtypes = [
        ptr, i64, ptr, ptr, ptr, i64, ptr, i64, ptr, ptr, i64, i64, i64, i64, ptr, i64, i64, ptr, ptr, ptr,
    ]
    lib.zkm_logup_trace.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = load(build())
    return _LIB


def rows_in_flight(n_base: int, n_ext: int, h: int, threads: int = 128) -> int:
    """The rows a launch evaluates at once over ``h`` rows, for ``n_base``
    base and ``n_ext`` ext slots a row: what ``SCRATCH_BYTES`` holds of the
    slots, in whole tiles of ``threads`` rows, at least one tile and at most
    the tiles of ``h``."""
    row_bytes = max(4 * n_base + 16 * n_ext, 1)
    tiles = -(-h // threads) * threads
    return min(tiles, max(threads, SCRATCH_BYTES // row_bytes // threads * threads))


def _checked(t: torch.Tensor | None, rows: int, what: str) -> torch.Tensor | None:
    if t is None:
        return None
    if not t.is_cuda:
        raise ValueError(f"logup: {what} is on {t.device}, not a CUDA device")
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"logup: {what} is {t.dtype} {tuple(t.shape)}, not int32 ({rows}, w)")
    return t.contiguous()


def permutation_trace(code: torch.Tensor, consts: torch.Tensor, main: torch.Tensor, prep, chal: torch.Tensor,
                      total: torch.Tensor, *, n_base: int, n_lookups: int, batch_size: int) -> torch.Tensor:
    """The LogUp permutation trace over the rows of ``main``, as an (H, 4 *
    width) int32 tensor on its device: the chunk columns of ``batch_size``
    lookups each, then the running sum; the running sum's last row goes to
    ``total``.

    ``code``: (n, 4) int32 instructions, ``consts``: the int32 words they
    read, on that device; ``main``, ``prep``: (H, w) int32 Montgomery traces,
    ``prep`` None where the code reads none; ``chal``: (1 + k, 4) int32 ext
    words on that device, alpha then beta^0 .. beta^(k-1); ``total``: an int32
    (4,) view on that device; ``n_base``: the code's base slots a row;
    ``n_lookups``: the lookups it opens (at least one)."""
    h = main.shape[0]
    main = _checked(main, h, "main")
    dev = main.device
    prep = _checked(prep, h, "preprocessed")
    for t, what, shape in ((code, "the code", (-1, 4)), (consts, "the constants", (-1,)),
                           (chal, "the challenge table", (-1, 4)), (total, "the total", (4,))):
        if (t.device != dev or t.dtype != torch.int32 or t.dim() != len(shape)
                or any(s not in (-1, n) for s, n in zip(shape, t.shape))):
            raise ValueError(f"logup: {what} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"not int32 {shape} on {dev}")
    if not total.is_contiguous() or total.data_ptr() % 16 or n_lookups < 1 or batch_size < 1:
        raise ValueError("logup: the total is not one aligned ext word, or no lookups")
    lib = _lib()
    threads = lib.zkm_logup_threads()
    n_ext = 2 * n_lookups
    rows = rows_in_flight(n_base + n_lookups, n_ext, h, threads)
    width = -(-n_lookups // batch_size) + 1
    code, consts, chal = code.contiguous(), consts.contiguous(), chal.contiguous()
    out = torch.empty((h, 4 * width), dtype=torch.int32, device=dev)
    ext_bytes = 16 * rows * n_ext
    scratch = torch.empty(ext_bytes + 4 * rows * (n_base + n_lookups), dtype=torch.uint8, device=dev)
    partials = torch.empty((-(-h // threads), 4), dtype=torch.int32, device=dev)
    # an absent segment is never read: its pointer stands in as main's, width 0
    prep_p, prep_w = (main.data_ptr(), 0) if prep is None else (prep.data_ptr(), prep.shape[1])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zkm_logup_trace(
            code.data_ptr(), code.shape[0], consts.data_ptr(), chal.data_ptr(), main.data_ptr(), main.shape[1],
            prep_p, prep_w, scratch.data_ptr() + ext_bytes, scratch.data_ptr(), rows, n_base, n_lookups,
            batch_size, out.data_ptr(), width, h, partials.data_ptr(), total.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"logup: CUDA error {err} ({lib.zkm_logup_error_string(err).decode()})")
    with _COUNT_LOCK:
        LAUNCHES["logup"] += KERNELS_A_CHIP
    return out
