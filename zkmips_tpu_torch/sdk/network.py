"""Remote prover service: proving offloaded to another host or process.

The counterpart of the reference's ``sdk/network.py``, which mirrors its
upstream's two remote backends (a twirp RPC to a GPU container,
crates/cuda/src/lib.rs:38-80 and proto/api.proto: Ready / Setup / ProveCore
/ Compress / Shrink / Wrap; and a signed gRPC prover network,
sdk/src/network/prover.rs):

* ``ProverServer``: a stdlib HTTP server around a local ``ProverClient`` on
  the server's device (CUDA unless its client names another; without a GPU
  it raises).  Stage-granular endpoints: ``/ready``, ``/setup``, ``/prove``
  (the whole ladder), ``/prove_core``, ``/compress``, ``/shrink``, ``/wrap``,
  ``/verify`` and ``/status/<job>``.
* ``NetworkProver``: the client; it sends requests and polls ``/status``.
  It never resolves or touches a device, so it runs where there is no GPU.

Wire format: proofs travel as the port's stable bytes (``stark_codec``'s
core and compressed proofs, ``ProofWithPublicValues.to_bytes``), tagged
with the server's FRI config.  Programs, stdin and keys travel as pickles in
which every tensor lies on the CPU (``dumps``): a peer without a GPU can
load them, and the server puts a received proving key back on its own device
(``ProvingKey.to``).  With ``ZKM_NETWORK_KEY`` set, every body, both ways,
carries an HMAC-SHA256 of itself in ``X-ZKM-MAC`` (the reference signs
network requests with ECDSA, sdk/src/network/prover.rs:242-306): the pickle
channel accepts only peers that hold the shared key, and an unsigned request
gets 403.  A failed job raises ``RuntimeError("remote job failed: ...")`` on
the client; a failed request raises ``RuntimeError("prover service error:
...")``.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import http.server
import io
import os
import pickle
import threading
import time
import uuid

import torch


def _key() -> bytes | None:
    k = os.environ.get("ZKM_NETWORK_KEY")
    return k.encode() if k else None


def _mac(body: bytes) -> str:
    k = _key()
    return hmac.new(k, body, hashlib.sha256).hexdigest() if k else ""


def _check_mac(body: bytes, mac: str) -> bool:
    k = _key()
    if k is None:
        return True
    return hmac.compare_digest(hmac.new(k, body, hashlib.sha256).hexdigest(), mac)


def _same(t):
    return t


class _HostPickler(pickle.Pickler):
    """Pickles every tensor as its CPU copy."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return _same, (obj.cpu(),)
        return NotImplemented


def dumps(obj) -> bytes:
    """``pickle.dumps`` with every tensor moved to the CPU."""
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _pack_proof(obj, config: str):
    """A proof as its stable bytes: a ``ProofWithPublicValues``, a
    compressed-family proof or a list of core shard proofs."""
    from ..recursion.compress import CompressedProof
    from ..stark.machine import ShardProof
    from ..verifier import stark_codec as codec
    from .client import ProofWithPublicValues

    if isinstance(obj, ProofWithPublicValues):
        return {"fmt": "pwp", "data": obj.to_bytes()}
    if isinstance(obj, CompressedProof):
        return {"fmt": "compressed", "data": codec.encode_compressed_proof(obj, config=config)}
    if isinstance(obj, list) and obj and all(isinstance(p, ShardProof) for p in obj):
        return {"fmt": "core", "data": codec.encode_core_proof(obj, config=config)}
    raise TypeError(f"no byte format for a {type(obj).__name__}")


def _unpack_proof(env):
    from ..verifier import stark_codec as codec

    fmt, data = env["fmt"], env["data"]
    if fmt == "pwp":
        from .client import ProofWithPublicValues

        return ProofWithPublicValues.from_bytes(data)
    if fmt == "compressed":
        return codec.decode_compressed_proof(data)[0]
    if fmt == "core":
        return codec.decode_core_proof(data)[0]
    raise ValueError(f"unknown proof format {fmt!r}")


class ProverServer:
    """Serves the stage-granular prover RPC (the analog of the GPU
    container's proto/api.proto) over HTTP, proving with ``client`` (a
    local ``ProverClient``; ``ProverClient.new()`` on CUDA when None)."""

    def __init__(self, client=None, host: str = "127.0.0.1", port: int = 0):
        from ..device import resolve_device
        from .client import ProverClient

        self.client = client or ProverClient.new()
        if self.client.remote is not None:
            raise ValueError("a prover server needs a local client, not a network one")
        self.device = resolve_device(self.client.device)
        self.config = self.client._config_name()
        self.jobs: dict[str, dict] = {}  # until /status has reported the job's result or error
        self._jobs_lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, obj, code: int = 200):
                data = dumps(obj)
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-ZKM-MAC", _mac(data))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/ready":
                    self._reply({"ready": True, "config": outer.config})
                elif self.path.startswith("/status/"):
                    job = outer._status(self.path.split("/")[-1])
                    if job is None:
                        self._reply({"error": "unknown job"}, 404)
                    elif job.get("error"):
                        self._reply({"state": "failed", "error": job["error"]})
                    elif "result" in job:
                        self._reply({"state": "done", "result": job["result"]})
                    else:
                        self._reply({"state": "running"})
                else:
                    self._reply({"error": "not found"}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(n)
                if not _check_mac(body, self.headers.get("X-ZKM-MAC", "")):
                    self._reply({"error": "bad request MAC"}, 403)
                    return
                try:
                    out = outer._handle(self.path, pickle.loads(body))
                except Exception as e:  # the client raises it as a service error
                    self._reply({"error": repr(e)}, 500)
                    return
                if out is None:
                    self._reply({"error": "not found"}, 404)
                else:
                    self._reply(out)

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def _handle(self, path: str, req: dict) -> dict | None:
        """The reply to a POST; None for an unknown path."""
        from ..stark.machine import VerificationError

        if path == "/setup":
            pk, vk = self.client.setup(req["program"])
            return {"pk": pk.to("cpu"), "vk": vk}
        if path in ("/prove", "/prove_core", "/compress", "/shrink", "/wrap"):
            job_id = uuid.uuid4().hex
            with self._jobs_lock:
                self.jobs[job_id] = {}
            threading.Thread(target=self._run_job, args=(job_id, path, req), daemon=True).start()
            return {"job_id": job_id}
        if path == "/verify":
            try:
                ok = self.client.verify(req["vk"], _unpack_proof(req["proof"]), req["program"])
            except VerificationError as e:
                return {"ok": False, "error": str(e)}
            return {"ok": bool(ok)}
        return None

    # ------------------------------------------------------------- job runner

    def _status(self, job_id: str) -> dict | None:
        """The job's entry; a finished job's is dropped as it is reported,
        so that a long-running server keeps no proof it has handed out."""
        with self._jobs_lock:
            job = self.jobs.get(job_id)
            if job is not None and ("result" in job or "error" in job):
                del self.jobs[job_id]
            return job

    def _pk(self, req: dict):
        pk = req["pk"]
        if pk is None:
            raise ValueError("no proving key in the request")
        return pk.to(self.device)

    def _run_job(self, job_id: str, path: str, req: dict):
        try:
            done = {"result": _pack_proof(self._stage(path, req), self.config)}
        except Exception as e:  # surfaced through /status, raised by the client
            done = {"error": repr(e)}
        with self._jobs_lock:
            self.jobs[job_id].update(done)

    def _stage(self, path: str, req: dict):
        dev = self.device
        if path == "/prove":
            return self.client.prove(self._pk(req), req["program"], req.get("stdin"),
                                     shard_size=req.get("shard_size", 1 << 20),
                                     mode=req.get("mode", "core"))
        if path == "/prove_core":
            from ..executor import execute_for_proving

            stdin = req.get("stdin")
            records, _info = execute_for_proving(
                req["program"],
                stdin_bufs=stdin.buffers if stdin is not None else (),
                proof_stream=stdin.proofs if stdin is not None else (),
                shard_size=req.get("shard_size", 1 << 20),
            )
            return self.client.machine.prove(self._pk(req), records, device=dev)
        rp = self.client._recursion_prover()
        if path == "/compress":
            return rp.compress(req["vk"], _unpack_proof(req["proofs"]), device=dev)
        if path == "/shrink":
            return rp.shrink(_unpack_proof(req["proof"]), device=dev)
        if path == "/wrap":
            return rp.wrap(_unpack_proof(req["proof"]), device=dev)
        raise ValueError(path)

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class NetworkProver:
    """The client of a ``ProverServer`` (the analog of
    sdk/src/network/prover.rs's NetworkProver: submit, then poll the job's
    status).  It holds no device: keys and proofs come back on the CPU."""

    def __init__(self, endpoint: str):
        if not endpoint.startswith("http://"):
            raise ValueError("the endpoint must be http://host:port")
        self.host = endpoint[len("http://"):].rstrip("/")
        self._config = None

    def _call(self, method: str, path: str, payload=None):
        conn = http.client.HTTPConnection(self.host, timeout=600)
        try:
            body = dumps(payload) if payload is not None else None
            headers = {"X-ZKM-MAC": _mac(body)} if body is not None else {}
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        if not _check_mac(data, resp.getheader("X-ZKM-MAC", "")):
            raise RuntimeError("prover service response failed its MAC check")
        out = pickle.loads(data)
        if resp.status != 200:
            raise RuntimeError(f"prover service error: {out}")
        return out

    def _poll(self, job: str, poll_interval: float):
        while True:
            st = self._call("GET", f"/status/{job}")
            if st.get("state") == "done":
                return _unpack_proof(st["result"])
            if st.get("state") == "failed":
                raise RuntimeError(f"remote job failed: {st.get('error')}")
            time.sleep(poll_interval)

    def _submit(self, path: str, payload: dict, poll_interval: float):
        return self._poll(self._call("POST", path, payload)["job_id"], poll_interval)

    @property
    def config(self) -> str:
        """The server's FRI config name (``stark_codec.CONFIG_IDS``), which
        tags the proofs this client sends back."""
        if self._config is None:
            self._config = self._call("GET", "/ready")["config"]
        return self._config

    def ready(self) -> bool:
        out = self._call("GET", "/ready")
        self._config = out.get("config")
        return bool(out.get("ready"))

    def setup(self, program):
        """-> (pk, vk) made on the server; the key's tensors on the CPU."""
        out = self._call("POST", "/setup", {"program": program})
        return out["pk"], out["vk"]

    def prove(self, pk, program, stdin=None, shard_size: int = 1 << 20, mode: str = "core",
              poll_interval: float = 0.25):
        return self._submit("/prove", {"pk": pk, "program": program, "stdin": stdin,
                                       "shard_size": shard_size, "mode": mode}, poll_interval)

    # -- stage-granular API (api.proto's ProveCore / Compress / Shrink / Wrap) --

    def prove_core(self, pk, program, stdin=None, shard_size: int = 1 << 20,
                   poll_interval: float = 0.25) -> list:
        return self._submit("/prove_core", {"pk": pk, "program": program, "stdin": stdin,
                                            "shard_size": shard_size}, poll_interval)

    def compress(self, vk, shard_proofs, poll_interval: float = 0.25):
        return self._submit("/compress", {"vk": vk, "proofs": _pack_proof(list(shard_proofs), self.config)},
                            poll_interval)

    def shrink(self, cp, poll_interval: float = 0.25):
        return self._submit("/shrink", {"proof": _pack_proof(cp, self.config)}, poll_interval)

    def wrap(self, cp, poll_interval: float = 0.25):
        return self._submit("/wrap", {"proof": _pack_proof(cp, self.config)}, poll_interval)

    def verify(self, vk, proof, program) -> bool:
        """The server's verdict; a rejected proof raises ``VerificationError``
        as the local client's ``verify`` does."""
        from ..stark.machine import VerificationError

        out = self._call("POST", "/verify", {"vk": vk, "proof": _pack_proof(proof, self.config),
                                             "program": program})
        if "error" in out:
            raise VerificationError(f"remote verify: {out['error']}")
        return bool(out["ok"])
