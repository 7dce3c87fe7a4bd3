"""ProverClient: execute / prove / verify MIPS guest programs.

The analog of the reference SDK (crates/sdk/src/lib.rs:46-287 ProverClient,
src/proof.rs ZKMProofWithPublicValues, src/io ZKMStdin): a builder-flavored
API over the core machine, in the role of the reference SDK's ``cuda``
backend.  Backends: "local" (this host, proving on ``device``: CUDA unless
the caller passes another, through ``resolve_device``), "mock" (execute
only, empty proof) and "network" (a remote ``sdk.network.ProverServer`` at
``endpoint``: setup, prove and verify are forwarded, and no device is
resolved on this side).

Proving modes: "core" (one STARK per shard), "compressed" (the recursion
ladder's compress), "groth16" and "plonk" (compress, shrink, wrap under the
BN254 outer config, then the SNARK over the outer circuit, on the host).
Every recursion stage proves on the client's device.  Proof bytes are the
reference package's, with no pickle anywhere.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, field

from ..device import resolve_device
from ..executor import Executor, NativeUnsupported, Program, execute_for_proving
from ..machine.machine import MipsMachine
from ..stark.machine import StarkConfig
from ..utils.heap import freeze_long_lived
from ..utils.logger import span


class ZKMStdin:
    """Guest input stream (analog of crates/sdk ZKMStdin / zkm-lib io)."""

    def __init__(self):
        self.buffers: list[bytes] = []
        self.proofs: list = []  # (proof, vk) pairs for verify_zkm_proof

    def write_bytes(self, data: bytes):
        self.buffers.append(bytes(data))

    def write_u32(self, value: int):
        self.buffers.append(struct.pack("<I", value))

    def write_u64(self, value: int):
        self.buffers.append(struct.pack("<Q", value))

    def write_proof(self, proof, vk):
        """Queue a (proof, vk) pair for the guest's verify_zkm_proof calls
        (reference ZKMStdin::write_proof, sdk/src/lib.rs)."""
        self.proofs.append((proof, vk))


@dataclass
class ExecutionReport:
    """Analog of crates/core/executor/src/report.rs:13-36."""

    total_instruction_count: int
    exit_code: int
    stdout: bytes
    public_values: bytes
    cycle_tracker: dict
    opcode_counts: dict = field(default_factory=dict)
    syscall_counts: dict = field(default_factory=dict)
    touched_memory_addresses: int = 0

    def total_syscall_count(self) -> int:
        return sum(self.syscall_counts.values())

    def __str__(self):
        lines = [f"cycles: {self.total_instruction_count}"]
        for op, n in sorted(self.opcode_counts.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {getattr(op, 'name', op)}: {n}")
        return "\n".join(lines)


@dataclass
class ProofWithPublicValues:
    proofs: list  # shard proofs (empty for mock)
    public_values: bytes
    committed_value_digest: list
    mode: str = "core"
    config: str = "core"  # FRI parameter set name (stark_codec.CONFIG_IDS)

    _MODE_IDS = {"mock": 0, "core": 1, "compressed": 2, "groth16": 3, "plonk": 4}

    def to_bytes(self) -> bytes:
        """Stable byte serialization, with no pickle anywhere (the reference
        bincodes ZKMProofWithPublicValues; loading attacker-supplied pickle
        would be arbitrary code execution)."""
        from .. import verifier
        from ..verifier import stark_codec as codec

        if self.mode == "core":
            payload = codec.encode_core_proof(self.proofs, config=self.config)
        elif self.mode == "compressed":
            payload = codec.encode_compressed_proof(self.proofs[0], config=self.config)
        elif self.mode == "groth16":
            payload = verifier.encode_groth16_wrapped(self.proofs[0])
        elif self.mode == "plonk":
            payload = verifier.encode_plonk_wrapped(self.proofs[0])
        elif self.mode == "mock":
            payload = b""
        else:
            raise ValueError(f"unknown proof mode {self.mode!r}")
        head = b"ZKPW" + (2).to_bytes(4, "little")
        head += self._MODE_IDS[self.mode].to_bytes(4, "little")
        head += len(self.public_values).to_bytes(4, "little") + bytes(self.public_values)
        digest = list(self.committed_value_digest)[:8] + [0] * (8 - len(self.committed_value_digest))
        head += b"".join(int(v).to_bytes(4, "little") for v in digest)
        return head + len(payload).to_bytes(4, "little") + payload

    @classmethod
    def from_bytes(cls, b: bytes) -> "ProofWithPublicValues":
        """Decode container bytes (STARK proofs land on the host)."""
        from .. import verifier
        from ..verifier import stark_codec as codec

        if b[:4] != b"ZKPW" or int.from_bytes(b[4:8], "little") != 2:
            raise codec.CodecError("bad proof container header")
        mode_id = int.from_bytes(b[8:12], "little")
        modes = {v: k for k, v in cls._MODE_IDS.items()}
        if mode_id not in modes:
            raise codec.CodecError("unknown proof mode")
        mode = modes[mode_id]
        off = 12
        npv = int.from_bytes(b[off : off + 4], "little")
        off += 4
        if off + npv > len(b):
            raise codec.CodecError("truncated container")
        pv_stream = b[off : off + npv]
        off += npv
        digest = [int.from_bytes(b[off + 4 * i : off + 4 * i + 4], "little") for i in range(8)]
        off += 32
        nplen = int.from_bytes(b[off : off + 4], "little")
        off += 4
        payload = b[off : off + nplen]
        if off + nplen != len(b):
            raise codec.CodecError("trailing bytes in container")
        config = "core"
        if mode == "core":
            proofs, config = codec.decode_core_proof(payload)
        elif mode == "compressed":
            cp, config = codec.decode_compressed_proof(payload)
            proofs = [cp]
        elif mode == "groth16":
            proofs = [verifier.decode_groth16_wrapped(payload)]
        elif mode == "plonk":
            proofs = [verifier.decode_plonk_wrapped(payload)]
        else:
            proofs = []
        return cls(proofs, pv_stream, digest, mode=mode, config=config)

    def save(self, path: str):
        with open(path, "wb") as fh:
            fh.write(self.to_bytes())

    @staticmethod
    def load(path: str) -> "ProofWithPublicValues":
        with open(path, "rb") as fh:
            return ProofWithPublicValues.from_bytes(fh.read())

    def size_bytes(self) -> int:
        return len(self.to_bytes())


class ProverClient:
    """client = ProverClient.new(); client.prove(pk, program, stdin)"""

    def __init__(self, backend: str = "local", config: StarkConfig | None = None, device=None,
                 endpoint: str | None = None):
        """backend: "local" | "mock" | "network"; ``device`` is where setup
        and every proof run (CUDA unless the caller passes another, e.g.
        "cpu"); the network backend proves on the server at ``endpoint``
        ("http://host:port"), at the server's config on the server's device:
        it takes neither, and builds no machine."""
        if backend not in ("local", "mock", "network"):
            raise ValueError(f"unknown backend {backend!r}")
        self.remote = None
        if backend == "network":
            from .network import NetworkProver

            if not endpoint:
                raise ValueError("the network backend needs endpoint='http://host:port'")
            if device is not None:
                raise ValueError("the network backend proves on the server's device, not on one given here")
            if config is not None:
                raise ValueError("the network backend proves at the server's config, not at one given here")
            self.remote = NetworkProver(endpoint)
        self.backend = backend
        self.machine = None if self.remote is not None else MipsMachine(config or StarkConfig.core())
        self.device = device
        self._rp_lock = threading.Lock()

    @staticmethod
    def new(**kw) -> "ProverClient":
        return ProverClient(**kw)

    @staticmethod
    def mock(**kw) -> "ProverClient":
        return ProverClient(backend="mock", **kw)

    # ------------------------------------------------------------------ api

    def setup(self, program: Program):
        """-> (pk, vk) for the given guest program, on the client's device
        (from the server, its tensors on the CPU, for the network backend)."""
        if self.remote is not None:
            return self.remote.setup(program)
        pk = self.machine.setup(program, device=self._device())
        freeze_long_lived()  # the machine's constraint DAGs and the key live as long as the client
        return pk, pk.vk

    def execute(self, program: Program, stdin: ZKMStdin | None = None,
                max_cycles: int | None = None) -> ExecutionReport:
        """Run the guest without proving.  The native executor runs it unless
        it raises ``NativeUnsupported`` or the guest prints cycle-tracker
        spans (which need the interpreter's per-write clocks)."""
        bufs = stdin.buffers if stdin is not None else []
        from ..executor.native import run_native

        try:
            out = run_native(program, stdin=bufs, max_cycles=max_cycles or (1 << 40))
        except NativeUnsupported:
            out = None
        if out is not None and b"cycle-tracker-" not in out["stdout"]:
            return ExecutionReport(
                total_instruction_count=out["global_clk"],
                exit_code=out["exit_code"],
                stdout=out["stdout"],
                public_values=out["public_values"],
                cycle_tracker={},
            )
        ex = self._executor(program, stdin)
        ex.run(max_cycles=max_cycles)
        return ExecutionReport(
            opcode_counts=dict(ex.report_opcode_counts),
            syscall_counts=dict(ex.report_syscall_counts),
            touched_memory_addresses=len(ex.touched_order),
            total_instruction_count=ex.global_clk,
            exit_code=ex.exit_code,
            stdout=bytes(ex.stdout),
            public_values=bytes(ex.public_values_stream),
            cycle_tracker=dict(ex.cycle_tracker),
        )

    def prove(self, pk, program: Program, stdin: ZKMStdin | None = None, shard_size: int = 1 << 20,
              mode: str = "core", rng=None) -> ProofWithPublicValues:
        """mode: "core" (one STARK per shard), "compressed" (shard proofs
        recursively aggregated into a single recursion proof), "groth16"
        (compressed -> shrink -> wrap under the BN254 outer config -> Groth16
        over the outer circuit), or "plonk" (same ladder, PLONK/KZG over the
        outer circuit): the reference's ``.compressed()`` / ``.groth16()`` /
        ``.plonk()`` actions (sdk/src/action.rs:14-156).  ``rng`` is the
        SNARK's ``randbelow`` (default ``secrets.randbelow``)."""
        if mode not in ("core", "compressed", "groth16", "plonk"):
            raise ValueError(f"unknown proof mode {mode!r}")
        if self.remote is not None:
            if rng is not None:
                raise ValueError("the network backend's SNARK draws its randomness on the server")
            return self.remote.prove(pk, program, stdin, shard_size=shard_size, mode=mode)
        device = None if self.backend == "mock" else self._device()
        with span("client.execute"):
            records, info = execute_for_proving(
                program,
                stdin_bufs=stdin.buffers if stdin is not None else (),
                proof_stream=stdin.proofs if stdin is not None else (),
                shard_size=shard_size,
            )
        if self.backend == "mock":
            return ProofWithPublicValues([], info["public_values"], info["digest"], mode="mock")
        cfg_name = self._config_name()
        proofs = self.machine.prove(pk, records, device=device)
        if mode == "core":
            return ProofWithPublicValues(proofs, info["public_values"], info["digest"],
                                         config=cfg_name)
        rp = self._recursion_prover()
        cp = rp.compress(pk.vk, proofs, device=device)
        if mode == "compressed":
            final = cp
        else:
            from ..snark import outer_circuit

            wrapped = rp.wrap(rp.shrink(cp, device=device), device=device)
            wrap = outer_circuit.wrap_groth16 if mode == "groth16" else outer_circuit.wrap_plonk
            final = wrap(rp, wrapped, rng=rng)
        return ProofWithPublicValues([final], info["public_values"], info["digest"],
                                     mode=mode, config=cfg_name)

    def verify(self, vk, proof: ProofWithPublicValues, program: Program) -> bool:
        if self.remote is not None:
            return self.remote.verify(vk, proof, program)
        if proof.mode == "mock":
            return True
        if proof.mode == "compressed":
            return self._recursion_prover().verify_compressed(vk, program, proof.proofs[0])
        if proof.mode == "groth16":
            from ..snark.outer_circuit import verify_groth16

            return verify_groth16(vk, program, proof.proofs[0])
        if proof.mode == "plonk":
            from ..snark.outer_circuit import verify_plonk

            return verify_plonk(vk, program, proof.proofs[0])
        return self.machine.verify(vk, proof.proofs, program)

    def _device(self):
        return resolve_device(self.device)

    def _config_name(self) -> str:
        """FRI parameter-set name for codecs (stark_codec.CONFIG_IDS)."""
        return "core" if self.machine.machine.config.fri.num_queries >= 84 else "test"

    def _recursion_prover(self):
        """The recursion prover, built once (under a lock: a server's jobs
        may ask for it together)."""
        with self._rp_lock:
            if not hasattr(self, "_rp"):
                from ..recursion.compress import RecursionProver

                self._rp = RecursionProver(self.machine)
            return self._rp

    # ------------------------------------------------------------- internals

    def _executor(self, program: Program, stdin: ZKMStdin | None,
                  shard_size: int = 1 << 20) -> Executor:
        ex = Executor(program, shard_size=shard_size)
        if stdin is not None:
            for buf in stdin.buffers:
                ex.write_stdin(buf)
            ex.proof_stream.extend(stdin.proofs)
        return ex


def load_elf(path: str) -> Program:
    with open(path, "rb") as fh:
        return Program.from_elf(fh.read())
