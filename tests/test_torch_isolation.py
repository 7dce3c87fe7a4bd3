"""The port stands alone: neither zkmips_tpu_torch nor chip_smoke.py imports
JAX or the JAX package, and the entry points refuse to run without a GPU
unless the caller asks for the CPU."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "zkmips_tpu"}


def _port_files():
    return sorted((ROOT / "zkmips_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(str(p.relative_to(ROOT)), name) for p in files
           for name in _imported_top_levels(p) if name in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("sub", ["verifier", "guest", "recursion", "snark", "sdk", "parallel", "examples"])
def test_new_subpackages_are_covered(sub):
    files = [p for p in _port_files() if p.parent.name == sub]
    assert len(files) >= 2
    assert [n for p in files for n in _imported_top_levels(p) if n in FORBIDDEN] == []


def test_port_modules_load_without_jax():
    """Importing every module of the port leaves JAX and the reference
    package out of ``sys.modules``."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in _port_files() if p.name != "chip_smoke.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert not bad, bad\n" % (FORBIDDEN,)
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    from zkmips_tpu_torch import resolve_device
    from zkmips_tpu_torch.stark.machine import StarkConfig, StarkMachine

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    machine = StarkMachine(StarkConfig.test(), [], num_public_values=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.setup(None)
    pk = machine.setup(None, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.prove_shard(pk, None, np.zeros(0, dtype=np.uint32))


def test_mips_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    from zkmips_tpu_torch.executor import asm
    from zkmips_tpu_torch.machine.machine import mips_machine, prove_program
    from zkmips_tpu_torch.stark.machine import StarkConfig

    program = asm.prog(asm.halt_sequence())
    machine = mips_machine(StarkConfig.test(), minimal=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.setup(program)
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.prove(None, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.prove_record(None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        prove_program(program, machine=machine)
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.prove_streaming(None, iter(()))
    assert machine.setup(program, device="cpu").device == torch.device("cpu")
    assert machine.prove_streaming(None, iter(()), device="cpu") == []


def test_recursion_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.recursion import Builder, RecursionMachine
    from zkmips_tpu_torch.recursion.compress import RecursionProver
    from zkmips_tpu_torch.stark.machine import StarkConfig

    b = Builder()
    b.commit_public_values([b.felt(1)] * 8)
    program = b.compile()
    machine = RecursionMachine(StarkConfig.test())
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.setup(program)
    pk = machine.setup(program, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.prove(pk, machine.execute(program))
    rp = RecursionProver(mips_machine(StarkConfig.test(), minimal=True))
    for call in (lambda: rp.join([(None, None), (None, None)], 2), lambda: rp.lift(None, None),
                 lambda: rp.compress(None, [None]), lambda: rp.prove_deferred(None, [0] * 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_sdk_client_proves_on_the_card_unless_told(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    from zkmips_tpu_torch.executor import asm
    from zkmips_tpu_torch.machine.machine import MipsMachine
    from zkmips_tpu_torch.sdk import ProverClient
    from zkmips_tpu_torch.stark.machine import StarkConfig

    program = asm.prog(asm.halt_sequence())
    client = ProverClient(config=StarkConfig.test())
    with pytest.raises(RuntimeError, match="CUDA"):
        client.setup(program)
    for mode in ("core", "compressed", "groth16", "plonk"):
        with pytest.raises(RuntimeError, match="CUDA"):
            client.prove(None, program, mode=mode)
    seen = []
    monkeypatch.setattr(MipsMachine, "setup",
                        lambda self, program, device=None: seen.append(device) or SimpleNamespace(vk=None))
    ProverClient(config=StarkConfig.test(), device="cpu").setup(program)
    assert seen == [torch.device("cpu")]


def test_snark_native_raises_without_its_library(monkeypatch, tmp_path):
    """A ``bn254.c`` that does not build raises at the first SNARK call:
    there is no pure-Python fallback on the port's path."""
    import subprocess as sp

    from zkmips_tpu_torch.ops import bn254_native
    from zkmips_tpu_torch.snark import groth16, native, r1cs

    assert not hasattr(native, "available")
    broken = tmp_path / "bn254.c"
    broken.write_text("this is not C\n")
    monkeypatch.setattr(bn254_native, "_LIB", None)
    monkeypatch.setattr(bn254_native, "_SRC", str(broken))
    monkeypatch.setattr("zkmips_tpu_torch.utils.cbuild.BUILD_DIR", tmp_path / "native")
    cs = r1cs.ConstraintSystem()
    cs.assert_eq(cs.mul(cs.public(3), cs.witness(5)), cs.witness(15))
    with pytest.raises(sp.CalledProcessError):
        groth16.setup(cs)
    with pytest.raises(sp.CalledProcessError):
        native.g1_msm([None], [1])
    monkeypatch.setattr(bn254_native, "_SRC", str(tmp_path / "missing.c"))
    with pytest.raises(OSError):
        native.fr_vec_inv(native.pack_fr([1]))


def test_kernel_wrappers_refuse_cpu_tensors():
    from zkmips_tpu_torch.ops import poseidon2_cuda

    with pytest.raises(ValueError):
        poseidon2_cuda.hash_rows(torch.zeros((4, 3), dtype=torch.int32))


def test_chip_smoke_fails_without_gpu_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
