"""The readers of the collector's spans, ``collector_s.compress`` and
``collector_s.core``: Python's cyclic garbage collector in seconds a job,
the program's ``gc.gen<N>`` spans summed over the window.  None where the
program records no such span (as a program without them); a traced window
of ``core-fib2`` on the CPU, at the fault tests' size, reads one."""

import pytest

from zkbench import harness, spec

READERS = ["collector_s.compress", "collector_s.core"]
CELL_OF = {"collector_s.compress": "compress-fib2", "collector_s.core": "core-fib2"}


def _ctx(spans, jobs=2):
    return harness.Context(spans=spans, window_s=20.0, jobs=[{}] * jobs, proofs=[], device=None,
                           peak=None, work=None)


@pytest.mark.parametrize("name", READERS)
def test_reads_every_generation_per_job(name):
    read = spec.metric_reader(name)
    spans = {"gc.gen0": (0.5, 900), "gc.gen1": (0.25, 80), "gc.gen2": (1.25, 3),
             "shard1": (12.0, 2), "lift.execute": (4.0, 2)}
    assert read(_ctx(spans)) == pytest.approx(1.0)


@pytest.mark.parametrize("name", READERS)
def test_absent_without_collector_spans(name):
    read = spec.metric_reader(name)
    assert read(_ctx({"shard1": (12.0, 2), "client.execute": (1.0, 2)})) is None
    assert read(_ctx({"gc.gen0": (0.5, 9)}, jobs=0)) is None


@pytest.mark.parametrize("name", READERS)
def test_entries(name):
    (m,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == name]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "s", "lower", "program_span", "host runtime", "cycles_per_s", [CELL_OF[name]])


def test_a_traced_core_window_reads_the_collector():
    cell = spec.cell("core-fib2")
    cell.config = dict(cell.config, fri={"log_blowup": 1, "num_queries": 8, "proof_of_work_bits": 4},
                       shard_size=256)
    cell.traffic = {"guest": "fib", "iterations": 60}
    r = harness.run(cell, 2**31 + 77, 0.0, True, device="cpu")
    assert r["correct"], r["checks"]
    assert r["metrics"]["collector_s.core"]["value"] > 0
