"""Wall-clock tracing spans, on when ZKMIPS_LOG or RUST_LOGGER is set (or
after ``configure(enabled=True)``).

With sync on (ZKM_SYNC_SPANS=1, or ``configure(sync=True)``) every span
boundary calls ``torch.cuda.synchronize()``, so a span's time is its device
work and not only the time to enqueue it.  That serialises host and device,
so it is for measurement runs, not for throughput.

Each thread has its own span stack and its own notes, so spans opened in
worker threads nest under that thread's path.  A worker that does part of a
caller's span passes the caller's ``current_path()`` as ``span(...,
parent=...)``: the pooled trace fills report as
``prove.trace_gen/fill.<chip>``.  Such totals are thread time: fills that ran
side by side can add up to more than their enclosing ``prove.trace_gen``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_CFG = {
    "enabled": bool(os.environ.get("ZKMIPS_LOG") or os.environ.get("RUST_LOGGER")),
    "sync": bool(os.environ.get("ZKM_SYNC_SPANS")),
    "echo": True,
}
_LOCK = threading.Lock()  # guards _TOTALS, _COUNTS, _ALL_NOTES and _GEN
_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
_LOCAL = threading.local()  # per thread: .stack, .notes, .gen
_ALL_NOTES: list[dict] = []  # every thread's notes since the last reset
_GEN = [0]  # bumped by spans_reset: a thread's older notes dict is dropped


def configure(enabled: bool | None = None, sync: bool | None = None, echo: bool | None = None):
    """Turn spans, their device fence, or their printing on or off."""
    for key, val in (("enabled", enabled), ("sync", sync), ("echo", echo)):
        if val is not None:
            _CFG[key] = val


def _fence():
    if _CFG["sync"] and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _notes() -> dict:
    """The calling thread's notes (the caller holds _LOCK)."""
    if getattr(_LOCAL, "gen", None) != _GEN[0]:
        _LOCAL.notes, _LOCAL.gen = {}, _GEN[0]
        _ALL_NOTES.append(_LOCAL.notes)
    return _LOCAL.notes


def current_path() -> str:
    """The calling thread's enclosing span path ("" outside any span)."""
    return "/".join(_stack())


@contextmanager
def span(name: str, parent: str | None = None):
    """Time the block under ``<enclosing path>/name``; with ``parent`` (a
    ``current_path()`` of another thread) under ``<parent>/name`` instead."""
    if not _CFG["enabled"]:
        yield
        return
    _fence()
    st = _stack()
    saved = None
    if parent is not None:
        saved = st[:]
        st[:] = parent.split("/") if parent else []
    st.append(name)
    path = "/".join(st)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _fence()
        dt = time.perf_counter() - t0
        with _LOCK:
            _TOTALS[path] += dt
            _COUNTS[path] += 1
        st.pop()
        if saved is not None:
            st[:] = saved
        if _CFG["echo"]:
            print(f"[span] {path}: {dt:.3f}s", file=sys.stderr, flush=True)


def note(name: str, value: int):
    """Keep a count (rows of a trace, say) under the calling thread's
    enclosing spans' path."""
    if _CFG["enabled"]:
        key = "/".join(_stack() + [name])
        with _LOCK:
            _notes()[key] = value


def notes_report() -> dict:
    """{enclosing span path/name: value}, each thread's in the order noted."""
    with _LOCK:
        out = {}
        for notes in _ALL_NOTES:
            out.update(notes)
        return out


def spans_report() -> dict:
    """{span path: (total seconds, count)}."""
    with _LOCK:
        return {k: (_TOTALS[k], _COUNTS[k]) for k in sorted(_TOTALS)}


def spans_reset():
    with _LOCK:
        _TOTALS.clear()
        _COUNTS.clear()
        _ALL_NOTES.clear()
        _GEN[0] += 1
