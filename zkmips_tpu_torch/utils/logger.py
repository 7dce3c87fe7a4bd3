"""Tracing spans, on when ZKMIPS_LOG or RUST_LOGGER is set (or after
``configure(enabled=True)``).  Off, ``span`` returns at once and records
nothing.

Every span that closes appends one record to a timeline (``timeline()``):
the thread's name, the span's path, and its start and end in ns on the clock
``torch.profiler`` stamps its events with, which is ``time.time_ns()``'s.
Durations are taken with ``time.perf_counter_ns()`` and put on that clock by
one offset taken at ``spans_reset()``, so a step of the wall clock inside a
window bends no span.  ``spans_report()`` sums the timeline by path.  The
timeline holds at most ``TIMELINE_CAP`` records; a span past the cap still
adds its host seconds to the report and is counted by ``timeline_dropped()``.

With sync on (ZKM_SYNC_SPANS=1, or ``configure(sync=True)``) a span also
records a CUDA timing event on the current device's current stream at its
entry and at its exit; the host does not wait.  The span's settled start is
the later of the host's entry and the moment the stream reached the entry
event, its settled end likewise: the time a synchronize at each boundary
would measure, without draining the device's queue.  The events are resolved
when a report is read (``timeline()``, ``spans_report()``), after the
window: one synchronize and one anchor event a device map the device's times
onto the host's.  The report then gives settled seconds.  Spans opened with
``parent=``, spans opened while CUDA is not initialised, and every span while
sync is off record no events and report host time.

While spans are on, every run of Python's cyclic garbage collector is a
top-level host span ``gc.gen<N>`` (N the oldest generation it collected),
recorded with the name of the thread that ran it: a ``gc.callbacks`` entry,
registered only while spans are on.  A collection holds the interpreter lock,
so it pauses every thread and is no child of the span it interrupted; its
length is the collecting thread's CPU time.  Such spans are not echoed.

Each thread has its own span stack and its own notes, so spans opened in
worker threads nest under that thread's path.  A worker that does part of a
caller's span passes the caller's ``current_path()`` as ``span(...,
parent=...)``: the pooled trace fills report as
``prove.trace_gen/fill.<chip>``.  Such totals are thread time: fills that ran
side by side can add up to more than their enclosing ``prove.trace_gen``.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import NamedTuple

import torch

_CFG = {
    "enabled": bool(os.environ.get("ZKMIPS_LOG") or os.environ.get("RUST_LOGGER")),
    "sync": bool(os.environ.get("ZKM_SYNC_SPANS")),
    "echo": True,
}
TIMELINE_CAP = 1 << 20


class SpanRecord(NamedTuple):
    """One closed span; times in ns on the profiler's clock."""

    thread: str
    path: str
    host_start_ns: int
    host_end_ns: int
    start_ns: int | None  # settled by the device's events; None where none were recorded
    end_ns: int | None

    @property
    def seconds(self) -> float:
        """Settled seconds where the span was settled, else host seconds."""
        if self.start_ns is None:
            return (self.host_end_ns - self.host_start_ns) / 1e9
        return (self.end_ns - self.start_ns) / 1e9


_LOCK = threading.Lock()  # guards the timeline, its pending events, the overflow, the notes and _GEN
_TIMELINE: list[SpanRecord] = []
_PENDING: list[tuple] = []  # (timeline index, device, entry event, exit event), unresolved
_OVERFLOW: dict[str, list] = defaultdict(lambda: [0.0, 0])  # path: [host seconds, count] past the cap
_LOCAL = threading.local()  # per thread: .stack, .notes, .gen
_ALL_NOTES: list[dict] = []  # every thread's notes since the last reset
_GEN = [0]  # bumped by spans_reset: a thread's older notes dict is dropped
# Collections closed and not yet in the timeline: (thread, path, t0, t1) in
# counter ns.  The gc callback only appends here, without _LOCK, since a
# collection may start inside any bytecode, including a holder of _LOCK.
_GC_CLOSED: list[tuple] = []
_GC_T0 = [0]  # thread CPU ns at the start of the running collection (one runs at a time)


def _clock_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(), read between two counter reads."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return wall - (a + b) // 2


_OFFSET = [_clock_offset()]


def configure(enabled: bool | None = None, sync: bool | None = None, echo: bool | None = None):
    """Turn spans, their device events, or their printing on or off."""
    for key, val in (("enabled", enabled), ("sync", sync), ("echo", echo)):
        if val is not None:
            _CFG[key] = val
    _track_collections()


def _gc_span(phase: str, info: dict):
    """The ``gc.callbacks`` entry: one collection as a closed span, as long
    as the thread's CPU time between the two callbacks (a wait for the
    interpreter lock around them is no part of the pause) and ending now."""
    if phase == "start":
        _GC_T0[0] = time.thread_time_ns()
        return
    cpu = time.thread_time_ns() - _GC_T0[0]
    t1 = time.perf_counter_ns()
    _GC_CLOSED.append((threading.current_thread().name, f"gc.gen{info['generation']}", t1 - cpu, t1))


def _track_collections():
    """Register ``_gc_span`` exactly while spans are on."""
    registered = _gc_span in gc.callbacks
    if _CFG["enabled"] and not registered:
        gc.callbacks.append(_gc_span)
    elif not _CFG["enabled"] and registered:
        gc.callbacks.remove(_gc_span)


def _record_event():
    """(device, timing event recorded on its current stream), or None while
    CUDA is not initialised."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return torch.cuda.current_device(), ev


def _anchor(device: int) -> tuple:
    """(event, profiler-clock ns at which the idle device reached it)."""
    torch.cuda.synchronize(device)
    with torch.cuda.device(device):
        ev = torch.cuda.Event(enable_timing=True)
        a = time.perf_counter_ns()
        ev.record()
        ev.synchronize()
        b = time.perf_counter_ns()
    return ev, (a + b) // 2 + _OFFSET[0]


def _settle():
    """Give every pending record its settled start and end."""
    with _LOCK:
        pending, gen = _PENDING[:], _GEN[0]
        _PENDING.clear()
    if not pending:
        return
    anchors = {dev: _anchor(dev) for dev in sorted({p[1] for p in pending})}
    settled = []
    for idx, dev, e0, e1 in pending:
        anchor, t_anchor = anchors[dev]
        settled.append((idx, t_anchor - round(e0.elapsed_time(anchor) * 1e6),
                        t_anchor - round(e1.elapsed_time(anchor) * 1e6)))
    with _LOCK:
        if _GEN[0] != gen:
            return
        for idx, d0, d1 in settled:
            r = _TIMELINE[idx]
            _TIMELINE[idx] = r._replace(start_ns=max(r.host_start_ns, d0),
                                        end_ns=max(r.host_end_ns, d1))


def _append(thread: str, path: str, t0: int, t1: int, entry=None, exit_=None):
    """Add the record of a span that ran from counter time t0 to t1 (the
    caller holds _LOCK)."""
    if len(_TIMELINE) >= TIMELINE_CAP:
        over = _OVERFLOW[path]
        over[0] += (t1 - t0) / 1e9
        over[1] += 1
        return
    if entry is not None and entry[0] == exit_[0]:
        _PENDING.append((len(_TIMELINE), entry[0], entry[1], exit_[1]))
    off = _OFFSET[0]
    _TIMELINE.append(SpanRecord(thread, path, t0 + off, t1 + off, None, None))


def _drain_collections():
    """Move the closed collections into the timeline (the caller holds _LOCK)."""
    n = len(_GC_CLOSED)
    if n:
        closed = _GC_CLOSED[:n]
        del _GC_CLOSED[:n]
        for rec in closed:
            _append(*rec)


def _close(path: str, t0: int, t1: int, entry, exit_):
    """Append the record of a span that ran from counter time t0 to t1."""
    thread = threading.current_thread().name
    with _LOCK:
        _drain_collections()
        _append(thread, path, t0, t1, entry, exit_)


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
    ``current_path()`` of another thread) under ``<parent>/name`` instead,
    on the host's clock alone."""
    if not _CFG["enabled"]:
        yield
        return
    st = _stack()
    saved = None
    if parent is not None:
        saved = st[:]
        st[:] = parent.split("/") if parent else []
    st.append(name)
    path = "/".join(st)
    entry = _record_event() if _CFG["sync"] and parent is None else None
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        _close(path, t0, t1, entry, _record_event() if entry is not None else None)
        st.pop()
        if saved is not None:
            st[:] = saved
        if _CFG["echo"]:
            print(f"[span] {path}: {(t1 - t0) / 1e9:.3f}s", file=sys.stderr, flush=True)


def note(name: str, value: int):
    """Keep a count (rows of a trace, say) under the calling thread's
    enclosing spans' path."""
    if _CFG["enabled"]:
        key = "/".join(_stack() + [name])
        with _LOCK:
            _notes()[key] = value
        if _CFG["echo"]:
            print(f"[note] {key}: {value}", file=sys.stderr, flush=True)


def notes_report() -> dict:
    """{enclosing span path/name: value}, each thread's in the order noted."""
    with _LOCK:
        out = {}
        for notes in _ALL_NOTES:
            out.update(notes)
        return out


def timeline() -> list:
    """Every SpanRecord since the last reset, in the order the spans closed
    (settled first: read it after the device's work is done)."""
    _settle()
    with _LOCK:
        _drain_collections()
        return _TIMELINE[:]


def timeline_dropped() -> int:
    """Spans closed past ``TIMELINE_CAP`` since the last reset."""
    with _LOCK:
        _drain_collections()
        return sum(n for _secs, n in _OVERFLOW.values())


def spans_report() -> dict:
    """{span path: (total seconds, count)}: settled seconds where settled."""
    totals: dict = defaultdict(lambda: [0.0, 0])
    for rec in timeline():
        tot = totals[rec.path]
        tot[0] += rec.seconds
        tot[1] += 1
    with _LOCK:
        for path, (secs, n) in _OVERFLOW.items():
            totals[path][0] += secs
            totals[path][1] += n
    return {k: tuple(totals[k]) for k in sorted(totals)}


def spans_reset():
    with _LOCK:
        _TIMELINE.clear()
        _PENDING.clear()
        _OVERFLOW.clear()
        del _GC_CLOSED[:]
        _ALL_NOTES.clear()
        _GEN[0] += 1
        _OFFSET[0] = _clock_offset()


_track_collections()
