"""Binding of the quotient's fold kernel (``csrc/quotient.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, cached in ``build/kernels/``
(``utils/cbuild.build_cuda``), and loaded with ctypes.  The kernel launches
on PyTorch's current stream; the launch is checked with ``cudaGetLastError``
and a failure raises.  There is no fallback: ``fold_chunks`` takes CUDA
tensors only.  What it runs, a code tensor of instructions and a table of
uniform words, is compiled from a chip's constraints by the prover
(``stark/quotient_tape.py``, which also holds the plain version); this
module takes them as they are.

``LAUNCHES`` counts the launches, so a run can show that the quotient went
through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..utils import cbuild
from . import field as f

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "quotient.cu"

# Scratch for the slots of the rows in flight: the rows a launch evaluates at
# once are this many bytes over a row's slots (at least one block of threads,
# at most the domain).  Half the L2 cache's 50 MB, so that the slots stay
# there beside the rows of the LDEs they read: on an H100 the Cpu chip's fold
# over 2^22 rows took 13.2 ms at 24 MiB, 23.3 ms at 48 MiB, 36.0 ms at 6 MiB.
# Far below the int64 temporaries the eager fold held for a block of 2^19 rows.
SCRATCH_BYTES = 24 << 20

LAUNCHES = {"quotient_fold": 0}
_COUNT_LOCK = threading.Lock()

_LIB = None
_LOCK = threading.Lock()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    return cbuild.build_cuda(SOURCE, "libzkm_quotient")


def load(path: Path) -> ctypes.CDLL:
    """A built library's C interface, typed."""
    lib = ctypes.CDLL(str(path))
    ptr, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
    lib.zkm_quotient_error_string.argtypes = [ctypes.c_int]
    lib.zkm_quotient_error_string.restype = ctypes.c_char_p
    lib.zkm_quotient_threads.restype = ctypes.c_int
    lib.zkm_quotient_fold.argtypes = [
        ptr, i64, ptr, i64, ptr, i64, ptr, i64, ptr, i64, ptr, ptr,
        i64, i64, i64, u32, u32, u32, u32, ctypes.c_int32, ptr, ptr,
    ]
    lib.zkm_quotient_fold.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = load(build())
    return _LIB


def rows_in_flight(n_base: int, n_ext: int, n: int, threads: int = 128) -> int:
    """The rows a launch evaluates at once over a domain of ``n`` rows, for
    a tape of ``n_base`` base and ``n_ext`` ext slots a row: what
    ``SCRATCH_BYTES`` holds of the slots, whole blocks of ``threads``, at
    least one block and at most ``n``."""
    row_bytes = max(4 * n_base + 16 * n_ext, 1)
    return min(n, max(threads, SCRATCH_BYTES // row_bytes // threads * threads))


def _checked(t: torch.Tensor | None, rows: int, what: str) -> torch.Tensor | None:
    if t is None:
        return None
    if not t.is_cuda:
        raise ValueError(f"quotient fold: {what} is on {t.device}, not a CUDA device")
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"quotient fold: {what} is {t.dtype} {tuple(t.shape)}, "
                         f"not int32 ({rows}, w)")
    return t.contiguous()


def fold_chunks(code: torch.Tensor, main_q: torch.Tensor, prep_q, perm_q, uni: torch.Tensor, *,
                log_h: int, lqd: int, n_base: int, n_ext: int, inv_zh: int, invert: bool,
                omega: int, shift: int, last: int) -> torch.Tensor:
    """The alpha-folded constraint sum times 1/Z_H over the quotient domain
    g * <w_N> (N = 2^log_h << lqd) by one launch of the fold kernel, as
    (2^lqd, H, 4) int32 chunks on ``main_q``'s device (row r in chunk
    r mod 2^lqd, row r >> lqd).

    ``code``: (n, 4) int32 instructions on that device; ``main_q``,
    ``prep_q``: (N, w) int32 Montgomery LDEs, ``perm_q`` (N, 4 * ext
    columns), either of the last two None where the code reads none;
    ``uni``: the int32 uniform table (it may lie on the host), whose words
    ``inv_zh`` to ``inv_zh + 2^lqd`` hold 1/Z_H by row class; ``n_base``,
    ``n_ext``: the slots a row needs; ``invert``: the code reads FIRST or
    LAST; ``omega``, ``shift``, ``last``: w_N, g and w_H^-1, Montgomery."""
    n = (1 << log_h) << lqd
    main_q = _checked(main_q, n, "main")
    dev = main_q.device
    prep_q = _checked(prep_q, n, "preprocessed")
    perm_q = _checked(perm_q, n, "permutation")
    if code.device != dev or code.dtype != torch.int32 or code.dim() != 2 or code.shape[1] != 4:
        raise ValueError(f"quotient fold: the code is {code.dtype} {tuple(code.shape)} on {code.device}, "
                         f"not int32 (n, 4) on {dev}")
    if perm_q is not None and perm_q.shape[1] % 4:
        raise ValueError(f"quotient fold: permutation width {perm_q.shape[1]} is not whole ext columns")
    lib = _lib()
    threads = lib.zkm_quotient_threads()
    rows = rows_in_flight(n_base, n_ext, n, threads)
    code = code.contiguous()
    uni = uni.to(dev, torch.int32)
    out = torch.empty((1 << lqd, 1 << log_h, 4), dtype=torch.int32, device=dev)
    ext_bytes = 16 * rows * n_ext
    scratch = torch.empty(max(ext_bytes + 4 * rows * n_base, 16), dtype=torch.uint8, device=dev)
    omega_rows = f.to_monty_int(pow(f.from_monty_int(omega), rows, f.P))
    # an absent segment is never read: its pointer stands in as main's, width 0
    prep_p, prep_w = (main_q.data_ptr(), 0) if prep_q is None else (prep_q.data_ptr(), prep_q.shape[1])
    perm_p, perm_w = (main_q.data_ptr(), 0) if perm_q is None else (perm_q.data_ptr(), perm_q.shape[1] // 4)
    if perm_p % 16:
        raise ValueError("quotient fold: the permutation trace is not 16-byte aligned")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zkm_quotient_fold(
            code.data_ptr(), code.shape[0], uni.data_ptr(), inv_zh,
            main_q.data_ptr(), main_q.shape[1], prep_p, prep_w, perm_p, perm_w,
            scratch.data_ptr() + ext_bytes, scratch.data_ptr(), rows, log_h + lqd, lqd,
            omega, omega_rows, shift, last, int(invert), out.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"quotient fold: CUDA error {err} ({lib.zkm_quotient_error_string(err).decode()})")
    with _COUNT_LOCK:
        LAUNCHES["quotient_fold"] += 1
    return out
