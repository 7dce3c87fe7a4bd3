"""Wall-clock tracing spans, on when ZKMIPS_LOG or RUST_LOGGER is set (or
after ``configure(enabled=True)``).

With sync on (ZKM_SYNC_SPANS=1, or ``configure(sync=True)``) every span
boundary calls ``torch.cuda.synchronize()``, so a span's time is its device
work and not only the time to enqueue it.  That serialises host and device,
so it is for measurement runs, not for throughput.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_CFG = {
    "enabled": bool(os.environ.get("ZKMIPS_LOG") or os.environ.get("RUST_LOGGER")),
    "sync": bool(os.environ.get("ZKM_SYNC_SPANS")),
    "echo": True,
}
_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
_STACK: list[str] = []
_NOTES: dict[str, int] = {}


def configure(enabled: bool | None = None, sync: bool | None = None, echo: bool | None = None):
    """Turn spans, their device fence, or their printing on or off."""
    for key, val in (("enabled", enabled), ("sync", sync), ("echo", echo)):
        if val is not None:
            _CFG[key] = val


def _fence():
    if _CFG["sync"] and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def span(name: str):
    if not _CFG["enabled"]:
        yield
        return
    _fence()
    _STACK.append(name)
    path = "/".join(_STACK)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _fence()
        dt = time.perf_counter() - t0
        _TOTALS[path] += dt
        _COUNTS[path] += 1
        _STACK.pop()
        if _CFG["echo"]:
            print(f"[span] {path}: {dt:.3f}s", file=sys.stderr, flush=True)


def note(name: str, value: int):
    """Keep a count (rows of a trace, say) under the enclosing spans' path."""
    if _CFG["enabled"]:
        _NOTES["/".join(_STACK + [name])] = value


def notes_report() -> dict:
    """{enclosing span path/name: value}, in the order noted."""
    return dict(_NOTES)


def spans_report() -> dict:
    """{span path: (total seconds, count)}."""
    return {k: (_TOTALS[k], _COUNTS[k]) for k in sorted(_TOTALS)}


def spans_reset():
    _TOTALS.clear()
    _COUNTS.clear()
    _NOTES.clear()
