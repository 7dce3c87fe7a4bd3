"""Nothing under zkbench/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), the plain
reference imports nothing of the program, and nothing reads the JAX-era
benchmark files."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "zkmips_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")) + [HERE / "work.py", HERE / "checks.py"],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "zkmips_tpu_torch" not in top_level_imports(path)
    assert "torch" not in top_level_imports(path)


def test_nothing_reads_the_jax_era_benchmark():
    for path in FILES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for name in ("bench.py", "BENCH_", "MULTICHIP_", "chip_smoke"):
            assert name not in text, (path, name)
