"""The port's spans (``utils/logger.py``): no span fences the device, every
closed span leaves one timeline record on the profiler's clock, the report is
the timeline's sums, ``ProverClient.prove`` times its executor as the
top-level ``client.execute``, and while spans are on each run of the cyclic
garbage collector is a top-level ``gc.gen<N>`` span of the thread that ran
it (the collector spans are left out where a test counts the program's own).

On the CPU a simulated device stands in for the card's events (its queue runs
behind the host by what the test enqueues); the ``gpu`` twins hold the same on
the card."""

import contextlib
import gc
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from zkmips_tpu_torch.executor import Opcode, Register, asm
from zkmips_tpu_torch.sdk import ProverClient, ZKMStdin
from zkmips_tpu_torch.stark.machine import StarkConfig
from zkmips_tpu_torch.utils import logger

MS = 1_000_000


@pytest.fixture
def spans():
    """Spans on, sync on, no printing; off again afterwards."""
    logger.spans_reset()
    logger.configure(enabled=True, sync=True, echo=False)
    try:
        yield
    finally:
        logger.configure(enabled=False, sync=False)
        logger.spans_reset()


def _no_synchronize(*_a, **_k):
    raise AssertionError("a span synchronized the device")


class FakeDevice:
    """A device queue that finishes ``busy_until`` (perf_counter ns): an event
    recorded at host time h is reached at max(h, busy_until)."""

    def __init__(self):
        self.busy_until = 0

    def enqueue(self, seconds: float):
        self.busy_until = max(time.perf_counter_ns(), self.busy_until) + int(seconds * 1e9)

    def synchronize(self, device=None):
        self.syncs.append(device)
        time.sleep(max(0, self.busy_until - time.perf_counter_ns()) / 1e9)


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA initialised on a simulated device; ``torch.cuda.synchronize``
    raises until the test calls ``allow_sync()``, then waits for the device
    and counts in ``syncs``."""
    dev = FakeDevice()
    dev.syncs = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at = None

        def record(self, stream=None):
            self.at = max(time.perf_counter_ns(), dev.busy_until)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return (end.at - self.at) / MS

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "device", lambda _d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", _no_synchronize)

    dev.allow_sync = lambda: monkeypatch.setattr(torch.cuda, "synchronize", dev.synchronize)
    return dev


def _collection(path: str) -> bool:
    """A span of the cyclic garbage collector."""
    return path.startswith("gc.gen")


def _program_spans(report: dict) -> dict:
    """The report without the collector's spans."""
    return {p: v for p, v in report.items() if not _collection(p)}


@contextlib.contextmanager
def _no_collections():
    """No automatic collection inside the block (the test counts records)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _by_path(records) -> dict:
    return {r.path: r for r in records}


def test_sync_spans_never_synchronize(spans, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", _no_synchronize)
    with logger.span("a"):
        with logger.span("b"):
            torch.ones(8).sum()
    with logger.span("c", parent="a"):
        pass
    assert set(_program_spans(logger.spans_report())) == {"a", "a/b", "a/c"}
    assert all(r.start_ns is None for r in logger.timeline())


def test_settled_spans_wait_for_the_device_not_the_host(spans, fake_cuda):
    """A span whose device work outlasts its host work ends where the device
    reached its exit event; the host left it first and nothing synchronized."""
    with logger.span("outer"):
        with logger.span("launch"):
            fake_cuda.enqueue(0.05)
        with logger.span("host"):
            pass
    fake_cuda.allow_sync()
    recs = _by_path(logger.timeline())
    assert fake_cuda.syncs == [0]  # one anchor for the whole window, at the read
    launch = recs["outer/launch"]
    assert launch.host_end_ns - launch.host_start_ns < 40 * MS
    assert launch.end_ns >= launch.host_end_ns + 45 * MS
    assert launch.seconds >= 0.045
    # the next span starts when the device reached its entry event
    assert recs["outer/host"].start_ns >= launch.end_ns - MS
    assert recs["outer"].end_ns >= recs["outer/host"].end_ns
    logger.timeline()
    assert fake_cuda.syncs == [0]  # resolved once


def test_parent_spans_are_host_only(spans, fake_cuda):
    with logger.span("main"):
        parent = logger.current_path()
        t = threading.Thread(target=_fill, args=(parent,))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    fake_cuda.allow_sync()
    recs = _by_path(logger.timeline())
    assert recs["main/fill.x"].start_ns is None and recs["main/fill.x"].end_ns is None
    assert recs["main/fill.x"].thread != recs["main"].thread
    assert recs["main"].start_ns is not None


def _fill(parent):
    with logger.span("fill.x", parent=parent):
        pass


def test_sync_off_records_no_events(spans, fake_cuda):
    logger.configure(sync=False)
    with logger.span("a"):
        fake_cuda.enqueue(0.01)
    fake_cuda.allow_sync()
    (rec,) = [r for r in logger.timeline() if not _collection(r.path)]
    assert rec.start_ns is None and fake_cuda.syncs == []


def test_disabled_spans_leave_no_record(spans):
    logger.configure(enabled=False)
    with logger.span("a"):
        with logger.span("b"):
            pass
    assert logger.timeline() == [] and logger.spans_report() == {}


def test_report_is_the_timelines_sums(spans, fake_cuda):
    for i in range(3):
        with logger.span("job"):
            with logger.span("step"):
                fake_cuda.enqueue(0.002 * i)
            with logger.span("fill", parent="job"):
                pass
    fake_cuda.allow_sync()
    report, records = _program_spans(logger.spans_report()), logger.timeline()
    assert set(report) == {"job", "job/step", "job/fill"}
    for path, (secs, n) in report.items():
        mine = [r for r in records if r.path == path]
        assert n == len(mine) == 3
        assert secs == pytest.approx(sum(r.seconds for r in mine), abs=1e-12)


def test_records_past_the_cap_still_count(spans, monkeypatch):
    monkeypatch.setattr(logger, "TIMELINE_CAP", 2)
    with _no_collections():
        for _ in range(5):
            with logger.span("s"):
                pass
    assert len(logger.timeline()) == 2
    assert logger.timeline_dropped() == 3
    assert logger.spans_report()["s"][1] == 5


def test_timeline_is_on_the_profilers_clock(spans):
    """A span around a ``record_function`` encloses the profiler's event,
    and the reverse, within 1 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with logger.span("outer"):
            with record_function("zk.inner"):
                torch.ones(1 << 16).cumsum(0)
        with record_function("zk.around"):
            with logger.span("inside"):
                torch.ones(1 << 16).cumsum(0)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("zk.")}
    recs = _by_path(logger.timeline())
    inner, around = events["zk.inner"], events["zk.around"]
    assert recs["outer"].host_start_ns - MS <= inner.start_ns() <= inner.end_ns() <= recs["outer"].host_end_ns + MS
    assert around.start_ns() - MS <= recs["inside"].host_start_ns <= recs["inside"].host_end_ns <= around.end_ns() + MS


def _tiny_program(n: int = 5):
    R, O = Register, Opcode
    return asm.prog([asm.addi(R.A0, 0, n), asm.addi(R.A0, R.A0, -1),
                     asm.branch(O.BNE, R.A0, R.ZERO, -8), asm.nop()] + asm.halt_sequence())


def test_client_prove_times_its_executor(spans):
    program = _tiny_program()
    client = ProverClient(config=StarkConfig.test(), device="cpu")
    pk, vk = client.setup(program)
    logger.spans_reset()
    for _ in range(2):
        proof = client.prove(pk, program, ZKMStdin())
    report = logger.spans_report()
    assert report["client.execute"][1] == 2
    assert report["shard1"][1] == 2
    assert "shard1/prove.trace_gen" in report
    assert not any(p.startswith("client.execute/") for p in report)
    assert client.verify(vk, proof, program)


def test_a_forced_collection_is_a_top_level_span(spans):
    with logger.span("outer"):
        gc.collect()
    recs = [r for r in logger.timeline() if r.path == "gc.gen2"]
    outer = _by_path(logger.timeline())["outer"]
    assert len(recs) == 1
    (rec,) = recs
    assert rec.thread == threading.current_thread().name and rec.start_ns is None
    assert outer.host_start_ns <= rec.host_start_ns <= rec.host_end_ns <= outer.host_end_ns
    assert logger.spans_report()["gc.gen2"][1] == 1


def test_a_collection_is_recorded_in_the_thread_that_ran_it(spans):
    t = threading.Thread(target=gc.collect, name="collector-test")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert [r.thread for r in logger.timeline() if _collection(r.path)] == ["collector-test"]


def test_no_collector_callback_while_tracing_is_off(spans):
    assert gc.callbacks.count(logger._gc_span) == 1
    logger.configure(enabled=True)
    assert gc.callbacks.count(logger._gc_span) == 1
    logger.configure(enabled=False)
    assert logger._gc_span not in gc.callbacks
    gc.collect()
    assert logger.timeline() == []
    logger.configure(enabled=True)
    assert gc.callbacks.count(logger._gc_span) == 1


# ----------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.cuda.init()
    torch.cuda._sleep(1000)  # the spin kernel loaded before any span
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_card_settled_span_covers_the_device_work(spans, monkeypatch):
    """A span around ``torch.cuda._sleep`` settles at least the sleep's device
    time while the host left it first; no span synchronized."""
    _card()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    monkeypatch.setattr(torch.cuda, "synchronize", _no_synchronize)
    with logger.span("sleep"):
        a.record()
        torch.cuda._sleep(200_000_000)
        b.record()
    monkeypatch.undo()
    torch.cuda.synchronize()
    (rec,) = logger.timeline()
    slept = a.elapsed_time(b) / 1e3
    assert slept > 0.02, slept
    assert rec.seconds >= slept - 1e-4, (rec, slept)
    assert rec.host_end_ns < rec.end_ns - int(slept * 1e9) // 2, (rec, slept)


@pytest.mark.gpu
def test_card_span_encloses_its_kernel_on_the_profilers_clock(spans):
    _card()
    x = torch.ones(1 << 24, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with logger.span("kernel"):
            x.cumsum(0)
    torch.cuda.synchronize()
    (rec,) = logger.timeline()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert kernels
    for k in kernels:
        assert rec.start_ns - MS <= k.start_ns() <= rec.end_ns + MS
