"""Shard placement, ``MipsMachine.prove(devices=...)`` and
``prove_streaming(devices=...)``, against the reference on the CPU.

The guest is ``tests/test_multichip.py``'s: fib, 120 iterations, in
256-cycle shards (three shards), on the minimal machine at the test config.
The devices are CPU devices listed several times (the port's placement
takes any list of devices; a list may repeat one).  The proofs must be the
reference's byte for byte, whatever the placement, and both verifiers must
accept them.  A copied proving key (``ProvingKey.to``) proves the bytes of
the original.  The reference proves in a second process and its byte
verifier checks the port's bytes in a third, beside the port's proofs in
this one.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from zkmips_tpu.stark import machine as jmachine
from zkmips_tpu.stark import pcs as jpcs
from zkmips_tpu.verifier import stark_codec as jcodec

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import asm, execute_for_proving, stream_for_proving
from zkmips_tpu_torch.machine.machine import MipsMachine, mips_machine
from zkmips_tpu_torch.stark.machine import StarkConfig
from zkmips_tpu_torch.verifier import stark_codec as codec

from test_torch_executor import PORT_SIDE, fib_body

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

ITERS, SHARD = 120, 256

REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
from test_torch_executor import JAX_SIDE, fib_body
from zkmips_tpu.executor import asm, execute_for_proving
from zkmips_tpu.machine.machine import mips_machine
from zkmips_tpu.stark.machine import StarkConfig
from zkmips_tpu.verifier import stark_codec
iters, shard = int(sys.argv[1]), int(sys.argv[2])
program = asm.prog(fib_body(JAX_SIDE, iters) + asm.halt_sequence())
m = mips_machine(StarkConfig.test(), minimal=True)
pk = m.setup(program)
records = execute_for_proving(program, shard_size=shard)[0]
sys.stdout.buffer.write(stark_codec.encode_core_proof(m.prove(pk, records, device=False, workers=3), config="test"))
"""

REFERENCE_VERIFIER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from zkmips_tpu.verifier import stark_codec
data = sys.stdin.buffer.read()
n = int.from_bytes(data[:8], "little")
ok = stark_codec.verify_core(data[8 + n:], data[8:8 + n], allowed_configs=("test",))
print("accepted" if ok else "rejected")
"""


def _records(program):
    return execute_for_proving(program, shard_size=SHARD)[0]


@pytest.fixture(scope="module")
def placed():
    """The port's placed proofs (batch over four devices with the key, streamed
    over two with a copy of it), the reference's proof bytes (second
    process) and the reference byte verifier's verdict on the port's batch
    bytes (third process, fed as soon as they are made)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(ITERS), str(SHARD)], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    ver = subprocess.Popen([sys.executable, "-c", REFERENCE_VERIFIER], cwd=ROOT, env=env,
                           stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        tp = asm.prog(fib_body(PORT_SIDE, ITERS) + asm.halt_sequence())
        tm = mips_machine(StarkConfig.test(), minimal=True)
        tpk = tm.setup(tp, device="cpu")
        copy = tpk.to("cpu")
        batch = tm.prove(tpk, _records(tp), devices=["cpu"] * 4)
        vk_bytes = codec.encode_vk(tpk.vk, tp.pc_start)
        ver.stdin.write(len(vk_bytes).to_bytes(8, "little") + vk_bytes
                        + codec.encode_core_proof(batch, config="test"))
        ver.stdin.close()
        streamed = tm.prove_streaming(copy, stream_for_proving(tp, shard_size=SHARD), devices=["cpu"] * 2)
        out, err = ref.communicate(timeout=600)
        verdict = ver.stdout.read().decode()
        ver.wait(timeout=600)
    finally:
        for proc in (ref, ver):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert ref.returncode == 0, err.decode()[-2000:]
    assert ver.returncode == 0, verdict[-2000:]
    return {"tm": tm, "tp": tp, "tpk": tpk, "copy": copy, "batch": batch, "streamed": streamed,
            "reference_verdict": verdict.splitlines()[-1], "reference_bytes": out}


@pytest.mark.parametrize("how", ["batch", "streamed"])
def test_placed_proofs_are_the_references_bytes(placed, how):
    proofs = placed[how]
    assert len(proofs) == 3
    ref = [convert.shard_proof_to_reference(p, jmachine, jpcs) for p in proofs]
    assert jcodec.encode_core_proof(ref, config="test") == placed["reference_bytes"]
    assert codec.encode_core_proof(proofs, config="test") == placed["reference_bytes"]


def test_both_verifiers_accept_the_placed_proofs(placed):
    """The port's verifier and the reference's byte verifier accept the
    placed proofs; the streamed ones are the same bytes."""
    assert placed["tm"].verify(placed["tpk"].vk, placed["batch"], placed["tp"])
    assert placed["reference_verdict"] == "accepted"
    for how in ("batch", "streamed"):
        assert codec.encode_core_proof(placed[how], config="test") == placed["reference_bytes"]


def test_a_copied_proving_key_proves_the_originals_bytes(placed):
    """The streamed proofs were made with a copy of the key, the batch ones
    with the key itself."""
    tpk, copy = placed["tpk"], placed["copy"]
    assert copy is not tpk and copy.prep_data is not tpk.prep_data
    assert copy.prep_data.persistent and copy.prep_order == tpk.prep_order
    assert copy.vk is tpk.vk and copy.device == torch.device("cpu")
    for name, t in tpk.prep_traces.items():
        assert torch.equal(copy.prep_traces[name], t)
    for a, b in zip(copy.prep_data.tree.digest_layers, tpk.prep_data.tree.digest_layers):
        assert torch.equal(a, b)
    assert codec.encode_core_proof(placed["streamed"], config="test") == \
        codec.encode_core_proof(placed["batch"], config="test")


@pytest.mark.parametrize("streaming", [False, True])
def test_shard_i_goes_to_device_i_mod_n_with_its_key(monkeypatch, streaming):
    """Each shard is proved on ``devices[i % n]`` with the key copy for that
    device, in a pool of at least ``len(devices)`` workers."""
    from zkmips_tpu_torch.utils import pool

    seen, sizes = [], []
    make = pool.make_pool
    monkeypatch.setattr(pool, "make_pool", lambda n: sizes.append(n) or make(n))
    monkeypatch.setattr(MipsMachine, "prove_record", lambda self, pk, r, device=None: seen.append(
        (r, device, pk, threading.current_thread().name)) or r)
    copies = []

    class Key:
        device = torch.device("cpu")

        def to(self, device):
            copies.append(torch.device(device))
            return self

    records = list(range(5))
    m = mips_machine(StarkConfig.test(), minimal=True)
    monkeypatch.setattr(MipsMachine, "split_deferred", lambda self, rs, split_threshold=None: rs)

    class Rec(int):
        def split(self, *_a):
            return []

        public_values = None

    devices = ["cpu", "meta", "cpu"]
    import zkmips_tpu_torch.machine.machine as mm

    monkeypatch.setattr(mm, "resolve_device", lambda d=None: torch.device(d or "cuda"))
    if streaming:
        out = m.prove_streaming(Key(), iter([Rec(i) for i in records]), devices=devices)
    else:
        out = m.prove(Key(), records, workers=1, devices=devices)
    assert [int(x) for x in out] == records
    assert sizes[0] == 3
    assert copies == [torch.device("meta")]  # one copy, made for the one device the key is not on
    placed_on = {int(r): d for r, d, _pk, _t in seen}
    assert placed_on == {i: torch.device(devices[i % 3]) for i in records}


def test_placement_refuses_a_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tm = mips_machine(StarkConfig.test(), minimal=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.prove(None, [], devices=["cpu", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.prove_streaming(None, iter(()), devices=["cuda"])
