"""run.py measures only on a card: without one it exits non-zero and prints
no result line, and so it does where the program is missing."""

import shutil
import subprocess
import sys

import pytest

from zkbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def run_py(cwd, cell):
    return subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload", cell, "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )


@pytest.mark.parametrize("cell", CELLS)
def test_no_card_no_result(cell):
    out = run_py(spec.ROOT, cell)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A checkout of BENCHMARK.json and zkbench/ alone: the run fails when it
    reaches for the program (here past the card check, on the CPU)."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "zkbench", tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from zkbench import harness, spec; "
            f"print(harness.run(spec.cell({CELLS[0]!r}), 1, 1, False, 'cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "zkmips_tpu_torch" in out.stderr
