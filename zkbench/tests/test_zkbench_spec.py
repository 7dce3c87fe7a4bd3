"""BENCHMARK.json and the files it names: every cell's configuration,
traffic, guest and per-layer metric found by name, within the limits the
file keeps (names, units, bounds, sizes)."""

import json
import re

import pytest

from zkbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "zkbench/run.py"]
    assert BENCH["paths"] == ["zkbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.cell(cell)
    assert c.chips in (1, 4)
    assert {"mode", "fri", "shard_size", "opts"} <= set(c.config)
    guest = spec.guest(c.traffic["guest"])
    assert guest.program(c.traffic)[:4] == b"\x7fELF"
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = spec.cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.fullmatch(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_per_layer_metrics_list_only_cells_that_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]


def test_configs_are_the_files_they_name():
    for c in BENCH["configs"]:
        assert c["file"].startswith("zkbench/") and c["reduced"] == []
        with open(spec.ROOT / c["file"]) as fh:
            assert json.load(fh)["name"] == c["name"]
