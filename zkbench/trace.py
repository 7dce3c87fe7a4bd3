"""What a traced run reads from the device and the host.

* ``DeviceTrace``: ``torch.profiler`` with CUDA activity over the window.
  The window is marked on the device by two marker kernels (a float64 fill,
  which the program, all int32 and int64, never launches) enqueued after a
  synchronize at its start and before one at its end, so the device's time
  base needs no alignment with the host's.  ``reduce`` gives the union of
  the device's busy intervals inside the marks (kernels, copies and
  fills), the time of each kernel by name, and the idle gaps.
* ``HostSampler``: a thread that samples every thread's innermost frame of
  the program every few milliseconds, so that an idle gap of the device can
  be named by what the host was doing in it.
"""

from __future__ import annotations

import collections
import sys
import threading
import time

import torch

MARKER = "FillFunctor<double>"


class DeviceTrace:
    def __init__(self, device: torch.device):
        self.device = device
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.host_marks: list = []

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def mark(self):
        """Wait for the device, note the host's time, and run a marker kernel."""
        torch.cuda.synchronize(self.device)
        self.host_marks.append(time.perf_counter())
        torch.empty(1, dtype=torch.float64, device=self.device).fill_(1.0)
        torch.cuda.synchronize(self.device)

    def reduce(self, top: int = 10) -> dict:
        """busy_s, window_s, kernel seconds by name and the idle gaps, in
        the device's time base between the two marks."""
        events = []
        marks = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
            if MARKER in e.name():
                marks.append((t0, t1))
            else:
                events.append((t0, t1, e.name()))
        if len(marks) != 2:
            raise RuntimeError(f"the device trace holds {len(marks)} window marks, not 2")
        (w0, _), (_, w1) = sorted(marks)
        by_name: dict = collections.defaultdict(float)
        spans = []
        for t0, t1, name in events:
            t0, t1 = max(t0, w0), min(t1, w1)
            if t1 > t0:
                by_name[name] += (t1 - t0) / 1e9
                spans.append((t0, t1))
        spans.sort()
        busy, gaps, cur0, cur1 = 0, [], w0, w0
        for t0, t1 in spans:
            if t0 > cur1:
                busy += cur1 - cur0
                gaps.append((cur1, t0))
                cur0 = t0
            cur1 = max(cur1, t1)
        busy += cur1 - cur0
        if w1 > cur1:
            gaps.append((cur1, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return {
            "busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9, "kernel_s": dict(by_name),
            "gaps": [((a - w0) / 1e9, (b - w0) / 1e9) for a, b in gaps[:top]],
        }


class HostSampler:
    """Samples what the program's threads are doing, ``interval`` apart."""

    def __init__(self, package: str, interval: float = 0.005):
        self.package = package
        self.interval = interval
        self.samples: list = []  # (perf_counter, [labels])
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="zkbench-sampler", daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def _label(self, frame) -> str | None:
        while frame is not None:
            path = frame.f_code.co_filename
            if f"/{self.package}/" in path:
                return f"{path.split(f'/{self.package}/', 1)[1]}:{frame.f_code.co_name}"
            frame = frame.f_back
        return None

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.interval):
            labels = [lab for tid, fr in sys._current_frames().items()
                      if tid != me and (lab := self._label(fr)) is not None]
            self.samples.append((time.perf_counter(), labels))

    def label(self, t0: float, t1: float) -> str:
        """The label sampled most often between host times t0 and t1."""
        count = collections.Counter()
        for t, labels in self.samples:
            if t0 <= t <= t1:
                count.update(labels)
        return count.most_common(1)[0][0] if count else "host: outside the program"
