"""Thread-pool helper: numpy errstate is thread-local, so worker threads
re-apply the overflow setting the numpy trace fills rely on (wrapping
uint32/uint64 arithmetic would otherwise emit RuntimeWarnings in a worker)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _init_worker():
    # the fills wrap uint32/uint64 on purpose; overflow warnings in workers
    # are noise, not bugs.
    np.seterr(over="ignore")


def make_pool(max_workers: int) -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=max_workers, initializer=_init_worker)


_FILL_POOL = None


def zeros_mt(shape, dtype=None, order="C"):
    """np.zeros with the memset parallelized across threads.

    Big trace allocations (hundreds of MB) spend ~135 ms per 256 MB in a
    single-threaded memset inside np.zeros; numpy's scalar-fill releases the
    GIL, so chunked fills scale near-linearly.  Small arrays fall through to
    np.zeros.
    """
    import numpy as np

    n_items = 1
    for d in shape:
        n_items *= d
    itemsize = np.dtype(dtype or np.float64).itemsize
    if n_items * itemsize < (16 << 20):
        return np.zeros(shape, dtype=dtype, order=order)
    global _FILL_POOL
    if _FILL_POOL is None:
        import os

        _FILL_POOL = make_pool(min(8, os.cpu_count() or 4))
    buf = np.empty(shape, dtype=dtype, order=order)
    flat = buf.T.reshape(-1) if order == "F" else buf.reshape(-1)
    nchunks = 8
    step = (flat.shape[0] + nchunks - 1) // nchunks
    futs = [
        _FILL_POOL.submit(flat[i * step : (i + 1) * step].fill, 0)
        for i in range(nchunks)
    ]
    for f in futs:
        f.result()
    return buf
