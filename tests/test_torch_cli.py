"""The port's CLI (``python -m zkmips_tpu_torch.cli``) against the
reference's ``zkmips_tpu.cli`` on the CPU: ``execute`` and ``vkey`` print
the reference's lines character for character, ``solidity-verifier``
renders the reference's source from the same vk bytes, ``--device`` left at
its default (``cuda``) raises without a GPU, and ``warmup`` exits 1 when a
guest fails.  ``prove`` / ``verify`` are ``test_torch_cli_prove.py``."""

import types
from pathlib import Path

import pytest
import torch

from zkmips_tpu.cli import main as jmain

from zkmips_tpu_torch import cli
from zkmips_tpu_torch.cli import main as tmain

from test_elf_cli import CODE, build_elf

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "guests" / "io_hints_commit.elf"
STDIN = ["78563412", "0f0f0f0f"]  # the two little-endian words it reads


def _out(capsys, main, argv) -> str:
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def elf(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "guest.elf"
    path.write_bytes(build_elf(CODE))
    return str(path)


@pytest.mark.parametrize("guest", ["synthesized", "fixture"])
def test_execute_prints_the_references_lines(capsys, elf, guest):
    argv = ["execute", elf] if guest == "synthesized" else \
        ["execute", str(FIXTURE)] + [x for h in STDIN for x in ("--stdin-hex", h)]
    got = _out(capsys, tmain, argv)
    assert got == _out(capsys, jmain, argv)
    assert got.startswith("cycles=") and "exit=0" in got


@pytest.mark.parametrize("config", ["test", "core"])
def test_vkey_prints_the_references_line(capsys, elf, config):
    got = _out(capsys, tmain, ["vkey", elf, "--config", config, "--device", "cpu"])
    assert got == _out(capsys, jmain, ["vkey", elf, "--config", config])
    assert got.startswith("vk: ") and got.count("-") == 7


def test_solidity_verifier_renders_the_references_source(capsys, tmp_path):
    from zkmips_tpu_torch.snark import bn254_curve as ec
    from zkmips_tpu_torch.verifier import gnark

    vk = types.SimpleNamespace(
        alpha1=ec.g1_mul(ec.G1_GEN, 3), beta2=ec.g2_mul(ec.G2_GEN, 5), gamma2=ec.g2_mul(ec.G2_GEN, 7),
        delta2=ec.g2_mul(ec.G2_GEN, 11), ic=[ec.g1_mul(ec.G1_GEN, k) for k in (13, 17, 19)])
    vk_bin = tmp_path / "groth16_vk.bin"
    vk_bin.write_bytes(gnark.dump_groth16_vk(vk))
    ours, theirs = tmp_path / "ours.sol", tmp_path / "theirs.sol"
    assert "wrote" in _out(capsys, tmain, ["solidity-verifier", str(vk_bin), "-o", str(ours)])
    assert "wrote" in _out(capsys, jmain, ["solidity-verifier", str(vk_bin), "-o", str(theirs)])
    assert ours.read_text() == theirs.read_text()
    assert "K2_Y" in ours.read_text()


def test_the_default_device_raises_without_a_gpu(elf):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    for argv in (["vkey", elf], ["prove", elf, "--config", "test"], ["verify", elf, "proof.bin"],
                 ["serve", "--port", "0"], ["warmup", "--quick"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tmain(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain(["vkey", elf, "--device", "cuda:0"])


def test_prove_endpoint_refuses_a_config(elf, capsys):
    """``prove --endpoint`` proves at the server's config: a ``--config``
    there is refused before anything is sent."""
    with pytest.raises(SystemExit) as e:
        tmain(["prove", elf, "--endpoint", "http://127.0.0.1:1", "--config", "test"])
    assert e.value.code == 2 and "--config does not apply" in capsys.readouterr().err


def test_warmup_exits_1_when_a_guest_fails(capsys, monkeypatch):
    """A failing guest is reported, the others still run, and the exit code
    is 1; with every guest passing it is 0.  (The corpus is cut to two
    small guests and the machine to the minimal one.)"""
    from zkmips_tpu_torch.executor import asm
    from zkmips_tpu_torch.machine import machine as mm, shape_gen

    good = asm.prog(asm.halt_sequence())
    bad = asm.prog([asm.nop()])  # runs off the end of the program
    full = mm.MipsMachine
    monkeypatch.setattr(mm, "MipsMachine", lambda config: full(config, chip_airs=mm.minimal_chip_airs()))
    monkeypatch.setattr(shape_gen, "corpus_programs", lambda: [("bad", bad), ("good", good)])
    capsys.readouterr()
    assert cli.main(["warmup", "--config", "test", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "warm bad: FAILED" in out and "warm good:" in out and "1 of 2 guests failed: bad" in out
    monkeypatch.setattr(shape_gen, "corpus_programs", lambda: [("good", good)])
    assert cli.main(["warmup", "--config", "test", "--device", "cpu", "--quick"]) == 0
