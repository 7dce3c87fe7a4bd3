"""``prove`` and ``verify`` of the port's CLI against the reference's, on
the CPU: ``prove --config test --device cpu`` writes the reference's
``proof.bin`` bytes, each CLI verifies the other's file, and a file with
one flipped byte exits 1."""

import pytest
import torch

from zkmips_tpu.cli import main as jmain

from zkmips_tpu_torch.cli import main as tmain

from test_elf_cli import CODE, build_elf

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_prove")
    elf = d / "guest.elf"
    elf.write_bytes(build_elf(CODE))
    ours, theirs = d / "ours.bin", d / "theirs.bin"
    assert tmain(["prove", str(elf), "-o", str(ours), "--config", "test", "--device", "cpu"]) == 0
    assert jmain(["prove", str(elf), "-o", str(theirs), "--config", "test"]) == 0
    return {"elf": str(elf), "ours": ours, "theirs": theirs, "dir": d}


def test_prove_writes_the_references_bytes(files):
    assert files["ours"].read_bytes() == files["theirs"].read_bytes()


def test_each_cli_verifies_the_others_file(files, capsys):
    capsys.readouterr()
    assert tmain(["verify", files["elf"], str(files["theirs"]), "--config", "test", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == "verification: OK\n"
    assert jmain(["verify", files["elf"], str(files["ours"]), "--config", "test"]) == 0


def test_a_flipped_byte_exits_1(files, capsys):
    bad = bytearray(files["ours"].read_bytes())
    bad[len(bad) // 2] ^= 1
    path = files["dir"] / "bad.bin"
    path.write_bytes(bytes(bad))
    capsys.readouterr()
    assert tmain(["verify", files["elf"], str(path), "--config", "test", "--device", "cpu"]) == 1
    assert capsys.readouterr().out.startswith("verification: FAILED")
