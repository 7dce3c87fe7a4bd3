"""The readers of the program's spans ``execute_share.core`` and
``prover_host_share.core``, on a synthetic window: what each reads, and None
where the spans it reads are absent (as in a program without them)."""

import pytest

from zkbench import harness, spec
from zkmips_tpu_torch.utils import logger

S = 1_000_000_000


def _rec(path, start_s, end_s, settled=None):
    """A timeline record; ``settled`` (start, end) in seconds, or None."""
    s0, s1 = settled if settled is not None else (None, None)
    return logger.SpanRecord("MainThread", path, int(start_s * S), int(end_s * S),
                             None if s0 is None else int(s0 * S), None if s1 is None else int(s1 * S))


def _ctx(spans, window_s=20.0):
    return harness.Context(spans=spans, window_s=window_s, jobs=[{}, {}], proofs=[], device=None,
                           peak=None, work=None)


def test_execute_share_reads_the_client_execute_spans():
    read = spec.metric_reader("execute_share.core")
    spans = {"client.execute": (3.0, 2), "shard1": (12.0, 2), "shard1/prove.open": (2.0, 2)}
    assert read(_ctx(spans)) == pytest.approx(15.0)


def test_execute_share_absent():
    read = spec.metric_reader("execute_share.core")
    assert read(_ctx({"shard1": (12.0, 2)})) is None


def test_prover_host_share_reads_host_seconds(monkeypatch):
    timeline = [
        _rec("client.execute", 0.0, 2.0),
        _rec("shard1", 2.0, 9.0, (2.0, 9.5)),
        _rec("shard1/prove.trace_gen", 2.0, 3.0, (2.0, 3.2)),
        _rec("shard1/prove.trace_gen/fill.Cpu", 2.1, 2.9),
        _rec("shard1/prove.main_commit", 3.0, 4.0, (3.2, 5.0)),  # host 1 s, settled 1.8 s
        _rec("shard1/prove.quotient", 4.0, 7.0, (5.0, 8.0)),  # host 3 s
        _rec("shard1/prove.open", 7.0, 9.0, (8.0, 9.5)),  # host 2 s
        _rec("shard2/prove.upload", 9.0, 9.5),  # host 0.5 s, no events
    ]
    monkeypatch.setattr(logger, "timeline", lambda: timeline)
    read = spec.metric_reader("prover_host_share.core")
    assert read(_ctx({}, window_s=13.0)) == pytest.approx(100.0 * 6.5 / 13.0)


def test_prover_host_share_absent(monkeypatch):
    read = spec.metric_reader("prover_host_share.core")
    monkeypatch.setattr(logger, "timeline", lambda: [_rec("client.execute", 0.0, 2.0)])
    assert read(_ctx({})) is None
    monkeypatch.delattr(logger, "timeline")
    assert read(_ctx({})) is None


def test_both_are_per_layer_metrics_of_core_fib2():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name, layer in (("execute_share.core", "client and executor"),
                        ("prover_host_share.core", "shard prover")):
        m = entries[name]
        assert (m["layer"], m["source"], m["moves"], m["workloads"]) == (
            layer, "program_span", "cycles_per_s", ["core-fib2"])
