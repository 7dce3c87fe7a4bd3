"""The port's remote prover service (``sdk/network.py``) against the
reference's ``tests/test_network.py``: the server in a background thread on
the CPU (``device="cpu"``), the client over real HTTP.  The served proof's
bytes must equal the reference's local ``ProverClient.prove`` bytes
(tolerance 0), and the client must work in a process without a GPU.
"""

import copy
import http.client
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from zkmips_tpu_torch.executor import Opcode, Register, asm
from zkmips_tpu_torch.sdk import ProofWithPublicValues, ProverClient, ZKMStdin
from zkmips_tpu_torch.sdk.network import ProverServer, dumps
from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
R, O = Register, Opcode


def _program():
    """tests/test_network.py's guest: commits 5 + 6."""
    return asm.prog(
        [
            *asm.li(R.T0, 5), *asm.li(R.T1, 6),
            asm.alu(O.ADD, R.T2, R.T0, R.T1),
            *asm.li(R.V0, 0x10), *asm.li(R.A0, 0),
            asm.alu(O.ADD, R.A1, R.T2, 0, imm_c=True), asm.syscall(),
        ]
        + asm.halt_sequence()
    )


@pytest.fixture(scope="module")
def server():
    s = ProverServer(client=ProverClient(config=StarkConfig.test(), device="cpu"))
    s.serve_background()
    yield s
    s.shutdown()


def _client(server):
    return ProverClient.new(backend="network", endpoint=f"http://127.0.0.1:{server.port}")


REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
from test_torch_interpreter import ref_program
from test_torch_network import _program
from zkmips_tpu.sdk import ProverClient, ZKMStdin
from zkmips_tpu.stark.machine import StarkConfig
client = ProverClient(config=StarkConfig.test())
program = ref_program(_program())
pk, _vk = client.setup(program)
sys.stdout.buffer.write(client.prove(pk, program, ZKMStdin()).to_bytes())
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's local ``ProverClient.prove`` of the guest, in a second
    process that runs beside the served proof; ``communicate()`` gives its
    bytes."""
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def served(server, reference):
    """The guest set up and proved (core mode) through the network client."""
    client = _client(server)
    assert client.remote.ready() and client.remote.config == "test"
    program = _program()
    pk, vk = client.setup(program)
    return {"client": client, "program": program, "pk": pk, "vk": vk,
            "proof": client.prove(pk, program, ZKMStdin())}


def test_network_prover_roundtrip_gives_the_references_bytes(served, reference):
    client, program, pk, vk, proof = (served[k] for k in ("client", "program", "pk", "vk", "proof"))
    assert pk.device == torch.device("cpu") and all(t.device.type == "cpu" for t in pk.prep_traces.values())
    assert proof.committed_value_digest[0] == 11
    assert client.verify(vk, proof, program)
    want, err = reference.communicate(timeout=600)
    assert reference.returncode == 0, err.decode()[-2000:]
    assert proof.to_bytes() == want


def test_network_prover_failure_surfaces(server):
    client = _client(server)
    with pytest.raises(RuntimeError, match="remote job failed"):
        client.prove(None, _program(), ZKMStdin())
    with pytest.raises(RuntimeError, match="prover service error"):
        client.remote._call("POST", "/nowhere", {})


def test_a_reported_job_is_dropped(server, served):
    """Once /status has reported a job's result or its error, the server
    keeps nothing of it: a second poll finds no job."""
    assert not server.jobs
    client = _client(server)
    job = client.remote._call("POST", "/prove_core", {"pk": None, "program": _program()})["job_id"]
    with pytest.raises(RuntimeError, match="remote job failed"):
        client.remote._poll(job, 0.05)
    assert job not in server.jobs
    with pytest.raises(RuntimeError, match="unknown job"):
        client.remote._call("GET", f"/status/{job}")


def test_the_recursion_prover_is_built_once_by_concurrent_jobs(monkeypatch, server):
    """Two jobs that reach the recursion stages together share one
    ``RecursionProver``."""
    import threading
    import time

    from zkmips_tpu_torch.recursion import compress

    built = []

    class Slow:
        def __init__(self, machine):
            time.sleep(0.2)
            built.append(self)

    monkeypatch.setattr(compress, "RecursionProver", Slow)
    client = copy.copy(server.client)  # a local client at the test config, with no recursion prover yet
    client.__dict__.pop("_rp", None)
    got = []
    threads = [threading.Thread(target=lambda: got.append(client._recursion_prover())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(built) == 1 and all(rp is built[0] for rp in got)


def test_network_verify_rejects_a_tampered_proof(served):
    bad = ProofWithPublicValues.from_bytes(served["proof"].to_bytes())
    bad.proofs[0].opened[0].main_local[0, 0] ^= 1
    with pytest.raises(VerificationError, match="remote verify"):
        served["client"].verify(served["vk"], bad, served["program"])


@pytest.mark.slow  # about a minute on the CPU; on the card in chip_smoke.py's network phase
def test_network_stage_granular_ladder(server, served):
    """Compress and Shrink of the served shard proofs, each a separate
    remote stage; the proofs travel as stable bytes.  (ProveCore is
    ``test_the_client_needs_no_gpu``'s.)"""
    client, vk, program = served["client"], served["vk"], served["program"]
    cp = client.remote.compress(vk, served["proof"].proofs)
    assert cp.stage == "compress"
    sh = client.remote.shrink(cp)
    assert sh.stage == "shrink"
    assert server.client._recursion_prover().verify_compressed(vk, program, sh)


def test_network_hmac_rejects_unauthenticated(monkeypatch, server, served):
    """With ``ZKM_NETWORK_KEY`` set (the server and the client read it per
    body), an unsigned POST gets 403 and a signed one is served."""
    monkeypatch.setenv("ZKM_NETWORK_KEY", "sekrit")
    conn = http.client.HTTPConnection(f"127.0.0.1:{server.port}", timeout=30)
    conn.request("POST", "/setup", body=pickle.dumps({"program": _program()}))
    resp = conn.getresponse()
    assert resp.status == 403
    conn.close()
    client = _client(server)
    assert client.remote.ready()
    assert client.verify(served["vk"], served["proof"], served["program"])


def test_the_server_needs_its_device(server):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    client = copy.copy(server.client)
    client.device = None  # a local client's default: CUDA
    with pytest.raises(RuntimeError, match="CUDA"):
        ProverServer(client=client)
    with pytest.raises(ValueError, match="device"):
        ProverClient(backend="network", endpoint="http://127.0.0.1:1", device="cpu")


def test_the_network_client_takes_the_servers_config():
    """The network backend builds no machine and refuses a config: the
    server's config decides."""
    assert ProverClient(backend="network", endpoint="http://127.0.0.1:1").machine is None
    with pytest.raises(ValueError, match="config"):
        ProverClient(backend="network", endpoint="http://127.0.0.1:1", config=StarkConfig.test())


def test_wire_pickles_hold_host_tensors():
    t = torch.arange(4, dtype=torch.int32)
    assert pickle.loads(dumps({"a": [t]}))["a"][0].device.type == "cpu"


CLIENT = r"""
import os, sys, torch
assert os.environ["CUDA_VISIBLE_DEVICES"] == "" and not torch.cuda.is_available()
import zkmips_tpu_torch.device as d
def refuse(*a, **k):
    raise AssertionError("the network client resolved a device")
d.resolve_device = refuse
import zkmips_tpu_torch.sdk.client as c
c.resolve_device = refuse
sys.path.insert(0, "tests")
from test_torch_network import _program
from zkmips_tpu_torch.sdk import ProverClient, ZKMStdin
from zkmips_tpu_torch.verifier import stark_codec
client = ProverClient(backend="network", endpoint=sys.argv[1])
pk, vk = client.setup(_program())
proofs = client.remote.prove_core(pk, _program(), ZKMStdin())
sys.stdout.buffer.write(stark_codec.encode_core_proof(proofs, config="test"))
"""


def test_the_client_needs_no_gpu(server, served):
    """A client process with CUDA hidden and device resolution refused sets
    up and proves (ProveCore) through the server: the served proofs' bytes."""
    from zkmips_tpu_torch.verifier import stark_codec

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", CLIENT, f"http://127.0.0.1:{server.port}"], cwd=ROOT,
                          env=env, capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert proc.stdout == stark_codec.encode_core_proof(served["proof"].proofs, config="test")
