"""One run of one cell: set-up, the measured window, the check.

The system under test is ``zkmips_tpu_torch.sdk.client.ProverClient``, built
at the configuration's FRI parameters and driven as its users drive it: a
closed loop of one job at a time, back to back, each a whole guest executed
and proved by ``ProverClient.prove`` in the configuration's mode.  Set-up
builds the client, runs its ``setup`` on the mix's program and proves one
whole job (job 0) so that every kernel, native library and recursion
circuit the window uses is built before it.  The window opens after that
and closes at the end of the first job that ends ``seconds`` or more after
it opened.  Verification and the comparison with the plain reference come
after the window.

Jobs draw their inputs from ``numpy.random.default_rng([seed, job])``: the
same seed gives the same jobs, and every job of a run has its own input.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time

import numpy as np

from . import checks, spec, trace, work

PACKAGE = "zkmips_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "zkmips_tpu")
CACHE = spec.ROOT / "build" / "zkbench"


def set_environment(config: dict):
    """The configuration's prover options, as the environment variables the
    program reads; the program's own tracing switches off; the compiler
    caches at fixed paths inside the checkout."""
    for key in ("ZKMIPS_LOG", "RUST_LOGGER", "ZKM_SYNC_SPANS"):
        os.environ.pop(key, None)
    for key, value in config["opts"].items():
        os.environ[key] = str(value)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def job_stdin(guest, traffic: dict, seed: int, job: int) -> list:
    return guest.stdin(traffic, np.random.default_rng([seed % (1 << 64), job]))


class Observed:
    """Every STARK proof made while it is open, with its FRI log blowup:
    the proofs' shapes give the Poseidon2 work of a traced window."""

    def __init__(self, stark_machine_cls):
        self.cls = stark_machine_cls
        self.proofs: list = []

    def __enter__(self):
        inner = self.original = self.cls.prove_shard
        proofs = self.proofs

        def prove_shard(machine, *a, **kw):
            p = inner(machine, *a, **kw)
            proofs.append((machine.config.fri.log_blowup, p))
            return p

        self.cls.prove_shard = prove_shard
        return self

    def __exit__(self, *exc):
        self.cls.prove_shard = self.original


class Context:
    """What a per-layer metric reader reads: ``spans`` ({path: (seconds,
    count)} of the program's spans over the window), ``window_s``, ``jobs``,
    ``proofs`` ([(log_blowup, proof)] of every STARK proof the window made),
    ``device`` (``trace.DeviceTrace.reduce``'s dict, None off the card),
    ``peak`` (the card's row of ``peaks.json``, None for another card) and
    ``work`` (the ``work`` module)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def span_total(self, last: str) -> float:
        """Seconds of every span whose last path component is ``last``."""
        return sum(t for path, (t, _n) in self.spans.items() if path.rsplit("/", 1)[-1] == last)


class Session:
    """The system under test for one cell: the client, its proving key on
    the mix's program, and the closed loop of jobs."""

    def __init__(self, cell: spec.Cell, device: str = "cuda", client_hook=None):
        """``client_hook(client)`` may replace parts of the client before its
        set-up (the control and the tests' faults)."""
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        set_environment(self.cfg)

        import torch

        from zkmips_tpu_torch.executor import Program
        from zkmips_tpu_torch.sdk.client import ProverClient, ZKMStdin
        from zkmips_tpu_torch.stark.machine import StarkConfig, StarkMachine
        from zkmips_tpu_torch.stark.pcs import FriConfig
        from zkmips_tpu_torch.utils import logger

        self.torch, self.logger, self.stark_machine, self.stdin_cls = torch, logger, StarkMachine, ZKMStdin
        self.dev = torch.device(device)
        self.on_card = self.dev.type == "cuda"
        logger.configure(enabled=False, sync=False, echo=False)
        self.guest = spec.guest(self.traffic["guest"])
        self.elf = self.guest.program(self.traffic)
        self.program = Program.from_elf(self.elf)
        self.client = ProverClient(config=StarkConfig(FriConfig(**self.cfg["fri"])), device=device)
        if client_hook is not None:
            client_hook(self.client)
        self.pk, self.vk = self.client.setup(self.program)

    def stdin(self, bufs: list):
        s = self.stdin_cls()
        for b in bufs:
            s.write_bytes(b)
        return s

    def prove(self, seed: int, job: int) -> tuple:
        bufs = job_stdin(self.guest, self.traffic, seed, job)
        proof = self.client.prove(self.pk, self.program, self.stdin(bufs),
                                  shard_size=self.cfg["shard_size"], mode=self.cfg["mode"])
        if self.on_card:
            self.torch.cuda.synchronize(self.dev)
        return bufs, proof

    def warm(self, seed: int):
        """Job 0: every kernel, library and circuit the window uses built."""
        self.prove(seed, 0)
        gc.collect()
        if self.on_card:
            self.torch.cuda.synchronize(self.dev)

    def window(self, seed: int, seconds: float, traced: bool, t_start: float) -> dict:
        """Jobs 1, 2, ... back to back until one ends ``seconds`` or more
        after the window opened; then the check."""
        torch, logger = self.torch, self.logger
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(self.dev)
        jobs, failed = [], 0
        observed = device_trace = sampler = None
        with contextlib.ExitStack() as stack:
            if traced:
                logger.spans_reset()
                logger.configure(enabled=True, sync=True, echo=False)
                stack.callback(logger.configure, enabled=False, sync=False)
                observed = stack.enter_context(Observed(self.stark_machine))
                sampler = stack.enter_context(trace.HostSampler(PACKAGE))
                if self.on_card:
                    device_trace = stack.enter_context(trace.DeviceTrace(self.dev))
                    device_trace.mark()
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            job = 1
            while True:
                try:
                    bufs, proof = self.prove(seed, job)
                    jobs.append({"job": job, "stdin": bufs, "proof": proof})
                except Exception as e:  # noqa: BLE001 - a job that fails is counted, the window goes on
                    print(f"job {job} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
                    failed += 1
                job += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(self.dev) if self.on_card else 0
            if device_trace is not None:
                device_trace.mark()
        reduced = device_trace.reduce() if device_trace is not None else None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

        counts = checks.judge(
            jobs, self.elf, self.cfg["fri"], self.program.pc_start,
            verify=lambda proof: self.client.verify(self.vk, proof, self.program),
            executed_cycles=lambda bufs: self.client.execute(
                self.program, self.stdin(bufs)).total_instruction_count,
        )
        cycles = sum(j["cycles"] for j in jobs)
        correct = failed == 0 and bool(jobs) and all(counts[k] <= lim for k, lim in checks.LIMITS.items())
        if not traced:
            values = {
                "setup_s": (setup_s, "s"),
                "cycles_per_s": (cycles / window_s, "cycles/s"),
                "compress_cycles_per_s": (cycles / window_s, "cycles/s"),
                "peak_device_gib": (peak / 2**30, "GiB"),
            }
            metrics = {m["name"]: {"value": values[m["name"]][0], "unit": m["unit"]}
                       for m in self.cell.end_to_end}
        else:
            card = torch.cuda.get_device_name(self.dev) if self.on_card else None
            ctx = Context(spans=logger.spans_report(), window_s=window_s, jobs=jobs,
                          proofs=observed.proofs, device=reduced, peak=spec.peaks().get(card),
                          work=work)
            metrics = {}
            for m in self.cell.per_layer:
                value = spec.metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        result = {"correct": correct, "attempted": len(jobs) + failed, "failed": failed,
                  "metrics": metrics, "device": device_info(self.dev, self.cell.chips, peak, reduced)}
        if reduced is not None:
            result["breakdown"] = breakdown(reduced, sampler, device_trace.host_marks[0])
        if traced and observed.proofs:
            total = work.total(observed.proofs)
            result["p2_work"] = {"permutations": total.perms, "bytes": total.bytes,
                                 **(work.roofline(total, ctx.peak) if ctx.peak else {})}
        result["window"] = {"jobs": len(jobs), "cycles": cycles, "seconds": window_s}
        result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]} for k, v in counts.items()}
        result["checks"]["failed_jobs"] = {"value": failed, "limit": 0}
        return result


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t_start: float | None = None, client_hook=None) -> dict:
    """One run of ``cell``: the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    session = Session(cell, device, client_hook)
    session.warm(seed)
    return session.window(seed, seconds, traced, t_start)


def device_info(dev, chips: int, peak: int, reduced: dict | None) -> dict:
    import torch

    on_card = dev.type == "cuda"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": chips, "memory_peak_bytes": peak}
    if reduced is not None:
        info["busy_s"] = reduced["busy_s"]
        info["window_s"] = reduced["window_s"]
    return info


def breakdown(reduced: dict, sampler, host_t0: float) -> dict:
    ops = sorted(reduced["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = [[sampler.label(host_t0 + a, host_t0 + b), b - a] for a, b in reduced["gaps"]]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": gaps}
