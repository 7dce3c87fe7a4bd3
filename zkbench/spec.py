"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names every configuration,
cell and metric.  What belongs to one of them sits in files of its own:

* a configuration: the JSON file its entry names (``configs/<config>.json``);
* a traffic mix: ``traffic/<mix>.json``, whose ``guest`` names the guest
  template ``guests/<guest>.py`` that builds it;
* a per-layer metric: its reader ``metrics/<metric>.py``, a ``read(ctx)``
  that returns a number or None.

A later change adds a cell, a configuration, a mix or a metric as new files
and entries; nothing here names one of them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / cfg_entry["file"]) as fh:
        config = json.load(fh)
    return Cell(
        name=name,
        config=config,
        traffic=traffic(w["traffic"]),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def traffic(mix: str) -> dict:
    with open(HERE / "traffic" / f"{mix}.json") as fh:
        return json.load(fh)


def guest(name: str):
    """The guest template module ``guests/<name>.py``."""
    return importlib.import_module(f"{__package__}.guests.{name}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py`` (metric names hold dots, so the
    file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks() -> dict:
    with open(HERE / "peaks.json") as fh:
        return json.load(fh)
