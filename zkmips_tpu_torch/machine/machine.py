"""MIPS core machine assembly: chip set, shard orchestration, verification.

The analog of MipsAir::machine() + prove/verify plumbing (reference:
crates/core/machine/src/mips/mod.rs:77-206, utils/prove.rs:128,
crates/prover/src/verify.rs:56): execute -> records -> per-shard proofs,
then shard-chain public-value checks and the cross-shard septic digest sum.

``setup`` and ``prove`` run on a CUDA device unless the caller passes another
(``device="cpu"``); without a GPU they raise.  ``verify`` runs on the host.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..executor.events import ExecutionRecord
from ..ops import field as ff, septic
from ..stark.chip import Chip
from ..stark.machine import StarkConfig, StarkMachine, VerificationError
from .alu import AddSubAir, BitwiseAir, LtAir
from .branch import BranchAir
from .byte import ByteAir
from .cpu import CpuAir
from .global_chip import START, GlobalAir
from .jump import JumpAir
from .memory_bridge import MemoryGlobalFinalizeAir, MemoryGlobalInitAir, MemoryLocalAir
from .program import ProgramAir
from .pv import (
    NUM_PV,
    PV_DEFERRED_DIGEST,
    PV_DIGEST,
    PV_EXECUTION_SHARD,
    PV_EXIT_CODE,
    PV_LAST_FINALIZE_ADDR,
    PV_LAST_INIT_ADDR,
    PV_NEXT_PC,
    PV_PREV_FINALIZE_ADDR,
    PV_PREV_INIT_ADDR,
    PV_SHARD,
    PV_START_PC,
)
from .shift import ShiftLeftAir, ShiftRightAir
from .syscall_instr import SyscallInstrAir

# lookup-multiplicity overflow bound on the Cpu trace height
# (reference crates/core/machine/src/lib.rs MAX_CPU_LOG_DEGREE)
MAX_CPU_LOG_DEGREE = 22

def core_chip_airs() -> list:
    """The reference's 49 chips in its order; byte-lookup producers must
    precede the Byte chip."""
    from .cloclz import CloClzAir
    from .divrem import DivRemAir
    from .keccak_chip import KeccakSpongeAir
    from .memory_instr import MemoryInstrAir
    from .misc import MiscInstrAir, MovCondAir
    from .mul import MulAir
    from .poseidon2_chip import Poseidon2ChipAir
    from .precompiles_ec import ec_precompile_airs
    from .sha_compress import ShaCompressAir
    from .sha_extend import ShaExtendAir
    from .sys_linux import SysLinuxAir
    from .syscall_chip import SyscallCoreAir, SyscallPrecompileAir

    return [
        CpuAir(),
        AddSubAir(),
        BitwiseAir(),
        LtAir(),
        ShiftLeftAir(),
        ShiftRightAir(),
        MulAir(),
        DivRemAir(),
        CloClzAir(),
        BranchAir(),
        JumpAir(),
        MemoryInstrAir(),
        MiscInstrAir(),
        MovCondAir(),
        SyscallInstrAir(),
        SyscallCoreAir(),
        SyscallPrecompileAir(),
        ShaExtendAir(),
        ShaCompressAir(),
        Poseidon2ChipAir(),
        KeccakSpongeAir(),
        SysLinuxAir(),
        *ec_precompile_airs(),
        MemoryLocalAir(),
        MemoryGlobalInitAir(),
        MemoryGlobalFinalizeAir(),
        GlobalAir(),
        ProgramAir(),
        ByteAir(),
    ]


def minimal_chip_airs() -> list:
    """The minimal machine: every opcode the mini-assembler's li/branch
    helpers emit has a receiving chip (Cpu dispatches unconditionally)."""
    return [
        CpuAir(), AddSubAir(), BitwiseAir(), LtAir(), ShiftLeftAir(),
        ShiftRightAir(), BranchAir(), JumpAir(), SyscallInstrAir(),
        MemoryLocalAir(), MemoryGlobalInitAir(), MemoryGlobalFinalizeAir(),
        GlobalAir(), ProgramAir(), ByteAir(),
    ]


class MipsMachine:
    def __init__(self, config: StarkConfig | None = None, chip_airs=None, use_shapes: bool | None = None):
        airs = chip_airs if chip_airs is not None else core_chip_airs()
        self.airs = airs
        chips = [Chip(a, num_public_values=NUM_PV) for a in airs]
        config = config or StarkConfig.core()
        if use_shapes is None:
            # default ON for sound configs (the production path: fixed shapes
            # give proofs one of finitely many layouts); OFF for the test
            # config so unit tests keep minimal pad areas
            use_shapes = config.fri.num_queries >= 28
        shape_config = None
        if use_shapes:
            from .shapes import ShapeConfig

            shape_config = ShapeConfig()
        self.machine = StarkMachine(
            config, chips, num_public_values=NUM_PV, shape_config=shape_config
        )

    def setup(self, program, device=None):
        return self.machine.setup(program, device=resolve_device(device))

    # ------------------------------------------------------------------ prove

    def generate_dependencies(self, record: ExecutionRecord):
        """Append derived events (nested ALU, global lookups) exactly once:
        repeated proves of the same record must not inflate trace heights."""
        if getattr(record, "_deps_done", False):
            return
        for a in self.airs:
            a.generate_dependencies(record, None)
        record._deps_done = True

    def shard_public_values(self, record: ExecutionRecord) -> np.ndarray:
        pv = np.zeros(NUM_PV, dtype=np.uint32)
        events = record.cpu_events
        rpv = record.public_values
        pv[PV_SHARD] = record.shard
        pv[PV_EXECUTION_SHARD] = rpv.execution_shard
        pv[PV_START_PC] = events[0].pc if events else 0
        pv[PV_NEXT_PC] = events[-1].next_pc if events else 0
        pv[PV_EXIT_CODE] = rpv.exit_code
        for i, word in enumerate(rpv.committed_value_digest[:8]):
            pv[PV_DIGEST + 2 * i] = word & 0xFFFF
            pv[PV_DIGEST + 2 * i + 1] = (word >> 16) & 0xFFFF
        for i, elt in enumerate(rpv.deferred_proofs_digest[:8]):
            pv[PV_DEFERRED_DIGEST + i] = elt % ff.P
        for base, addr in (
            (PV_PREV_INIT_ADDR, rpv.prev_init_addr),
            (PV_LAST_INIT_ADDR, rpv.last_init_addr),
            (PV_PREV_FINALIZE_ADDR, rpv.prev_finalize_addr),
            (PV_LAST_FINALIZE_ADDR, rpv.last_finalize_addr),
        ):
            pv[base] = addr & 0xFFFF
            pv[base + 1] = (addr >> 16) & 0xFFFF
        return pv

    def prove_record(self, pk, record: ExecutionRecord, device=None):
        from ..utils.logger import span

        device = resolve_device(device)
        with span(f"shard{record.shard}"):
            with span("prove.dependencies"):
                self.generate_dependencies(record)
            # trace generation repopulates the byte-lookup arrays; reset so a
            # re-prove of the same record sees identical multiplicities
            record.byte_lookups.pop("arrays", None)
            pv = self.shard_public_values(record)
            return self.machine.prove_shard(pk, record, pv, device=device)

    def split_deferred(self, records: list, split_threshold: int | None = None) -> list:
        """Carve large precompile event families into standalone deferred
        shards (reference record.rs:130 split + prove.rs deferred handling):
        deferred records are appended after the final execution shard with
        continuing shard numbers; cross-shard syscall/memory consistency rides
        the Global septic-curve argument (see machine/syscall_chip.py)."""
        if split_threshold is None:
            from ..utils.opts import ZKMCoreOpts

            split_threshold = ZKMCoreOpts.default().split_threshold
        deferred = []
        for r in records:
            deferred.extend(r.split(False, split_threshold))
        _chain_deferred(deferred, len(records), records[-1].public_values)
        return records + deferred

    def prove(self, pk, records: list, device=None, workers: int | None = None) -> list:
        """Prove all shards on ``device`` (CUDA unless the caller names
        another).  ``workers`` > 1 pipelines shards across threads (the
        analog of the reference's trace-gen/prove worker pool,
        crates/core/machine/src/utils/prove.rs:157-520 -- numpy and torch
        release the GIL, so host trace generation overlaps device proving);
        the default is one shard at a time, since two shards in flight
        double the peak device memory.  Proof bytes do not depend on the
        placement.  Shard-parallel proving across several GPUs is not
        ported yet."""
        device = resolve_device(device)
        records = self.split_deferred(records)
        if workers is None or workers <= 1 or len(records) <= 1:
            return [self.prove_record(pk, r, device=device) for r in records]
        from ..utils.pool import make_pool

        with make_pool(workers) as pool:
            futs = [pool.submit(self.prove_record, pk, r, device) for r in records]
            return [f.result() for f in futs]

    def prove_streaming(self, pk, record_iter, device=None, workers: int = 1,
                        max_inflight: int = 3, split_threshold: int | None = None) -> list:
        """Streaming prove: consume records as the executor produces them
        (``executor.stream_for_proving``) and prove them in a bounded worker
        pool -- the analog of the reference's checkpoint-channel pipeline
        (crates/core/machine/src/utils/prove.rs:157-520).  At most
        ``max_inflight`` unproven records are held at once, so peak host
        memory stays flat as the cycle count grows; precompile families
        split into deferred shards that are numbered and proved after the
        execution stream ends, with the public values ``split_deferred``
        gives them.  The proofs equal ``prove``'s.

        Shards are proved on ``device`` (CUDA unless the caller names
        another).  ``workers`` defaults to 1: one keccak shard peaks at about
        33 GiB of device memory and two in flight double it.  With one
        worker the executor, running in the caller's thread, still overlaps
        the proving in the pool."""
        import threading

        from ..utils.pool import make_pool

        device = resolve_device(device)
        if split_threshold is None:
            from ..utils.opts import ZKMCoreOpts

            split_threshold = ZKMCoreOpts.default().split_threshold
        sem = threading.Semaphore(max_inflight)

        def prove_one(r):
            try:
                return self.prove_record(pk, r, device=device)
            finally:
                sem.release()

        futures = []
        deferred: list = []
        tail = None
        with make_pool(max(workers, 1)) as pool:
            for r in record_iter:
                deferred.extend(r.split(False, split_threshold))
                tail = r
                sem.acquire()
                futures.append(pool.submit(prove_one, r))
            n_exec = len(futures)
            # deferred shards follow the final execution shard with chained
            # public values (the rules of split_deferred)
            if deferred:
                _chain_deferred(deferred, n_exec, tail.public_values)
            for d in deferred:
                sem.acquire()
                futures.append(pool.submit(prove_one, d))
            return [f.result() for f in futures]

    # ----------------------------------------------------------------- verify

    def verify(self, vk, proofs: list, program) -> bool:
        """Shard proofs + cross-shard chain + global septic digest sum.

        The chain rules are the full analog of the reference verifier
        (crates/prover/src/verify.rs:56-290): shard/execution-shard counting,
        the Cpu log-degree cap, pc chaining, committed/deferred digest
        set-once rules, and init/finalize address-endpoint chaining.
        """
        if not proofs:
            raise VerificationError("no shard proofs")
        if len(proofs) > 1 << 16:
            raise VerificationError("too many shards")
        for proof in proofs:
            self.machine.verify_shard(vk, proof)

        prev_next_pc = None
        execution_shard = 0
        zero16 = [0] * 16
        zero8 = [0] * 8
        prev_commit = zero16
        prev_deferred = zero8
        prev_last_init = (0, 0)
        prev_last_fin = (0, 0)
        for i, proof in enumerate(proofs):
            pv = [int(x) for x in proof.public_values.tolist()]
            has_cpu = "Cpu" in proof.chip_names
            if i == 0 and not has_cpu:
                raise VerificationError("first shard has no Cpu chip")
            if has_cpu:
                ld = self._chip_log_degree(proof, "Cpu")
                if ld > MAX_CPU_LOG_DEGREE:
                    raise VerificationError(f"cpu log degree {ld} exceeds cap")
            # shard / execution-shard counting
            if pv[PV_SHARD] != i + 1:
                raise VerificationError(f"shard index mismatch at proof {i}")
            if has_cpu:
                execution_shard += 1
                if pv[PV_EXECUTION_SHARD] != execution_shard:
                    raise VerificationError(
                        f"execution shard mismatch at shard {i + 1}"
                    )
            # pc chaining
            if i == 0 and pv[PV_START_PC] != program.pc_start:
                raise VerificationError("first shard does not start at pc_start")
            if prev_next_pc is not None and pv[PV_START_PC] != prev_next_pc:
                raise VerificationError(f"pc chain broken at shard {i + 1}")
            if not has_cpu and pv[PV_START_PC] != pv[PV_NEXT_PC]:
                raise VerificationError(f"cpu-less shard {i + 1} changes pc")
            if has_cpu and pv[PV_START_PC] == 0:
                raise VerificationError(f"cpu shard {i + 1} starts halted")
            prev_next_pc = pv[PV_NEXT_PC]
            # exit code must be zero in every shard (verify.rs:171-180)
            if pv[PV_EXIT_CODE] != 0:
                raise VerificationError(f"nonzero exit code in shard {i + 1}")
            # committed/deferred digest set-once + non-cpu frozen rules
            commit = pv[PV_DIGEST : PV_DIGEST + 16]
            deferred = pv[PV_DEFERRED_DIGEST : PV_DEFERRED_DIGEST + 8]
            if prev_commit != zero16 and commit != prev_commit:
                raise VerificationError(f"committed digest changed at shard {i + 1}")
            if prev_deferred != zero8 and deferred != prev_deferred:
                raise VerificationError(f"deferred digest changed at shard {i + 1}")
            if not has_cpu and (commit != prev_commit or deferred != prev_deferred):
                raise VerificationError(f"cpu-less shard {i + 1} changes digest")
            prev_commit, prev_deferred = commit, deferred
            # init/finalize address-endpoint chaining
            prev_init = (pv[PV_PREV_INIT_ADDR], pv[PV_PREV_INIT_ADDR + 1])
            last_init = (pv[PV_LAST_INIT_ADDR], pv[PV_LAST_INIT_ADDR + 1])
            prev_fin = (pv[PV_PREV_FINALIZE_ADDR], pv[PV_PREV_FINALIZE_ADDR + 1])
            last_fin = (pv[PV_LAST_FINALIZE_ADDR], pv[PV_LAST_FINALIZE_ADDR + 1])
            if prev_init != prev_last_init:
                raise VerificationError(f"init addr chain broken at shard {i + 1}")
            if prev_fin != prev_last_fin:
                raise VerificationError(f"finalize addr chain broken at shard {i + 1}")
            if "MemoryGlobalInit" not in proof.chip_names and prev_init != last_init:
                raise VerificationError(
                    f"init addr changes without MemoryGlobalInit in shard {i + 1}"
                )
            if "MemoryGlobalFinalize" not in proof.chip_names and prev_fin != last_fin:
                raise VerificationError(
                    f"finalize addr changes without MemoryGlobalFinalize in shard {i + 1}"
                )
            prev_last_init, prev_last_fin = last_init, last_fin
        if prev_next_pc != 0:
            raise VerificationError("final shard does not halt (next_pc != 0)")

        # global septic digest sum: sum over shards of (digest - START) == identity
        total = None  # None = point at infinity
        for proof in proofs:
            digest = self._proof_global_digest(proof)
            total = _complete_add(total, digest)
            total = _complete_add(total, _neg_point(_start_point()))
        if total is not None:
            raise VerificationError("global memory digest does not sum to zero")
        return True

    def _chip_log_degree(self, proof, name: str) -> int:
        for n, ov in zip(proof.chip_names, proof.opened):
            if n == name:
                return int(ov.log_degree)
        raise VerificationError(f"proof missing {name} chip")

    def _proof_global_digest(self, proof):
        for name, ov in zip(proof.chip_names, proof.opened):
            if name == "Global":
                if ov.global_sum is None:
                    raise VerificationError("missing global sum")
                gs = [int(v) for v in ov.global_sum.tolist()]
                return (gs[:7], gs[7:])
        raise VerificationError("proof missing Global chip")


def _chain_deferred(deferred: list, n_exec: int, tail):
    """Number the deferred shards after the ``n_exec`` execution shards:
    their chained public values (digests, addr endpoints) carry the final
    execution shard's ``tail`` unchanged (verify.rs non-cpu-shard
    transition rules)."""
    for j, d in enumerate(deferred):
        d.shard = n_exec + 1 + j
        pv = d.public_values
        pv.shard = d.shard
        pv.execution_shard = tail.execution_shard
        pv.exit_code = tail.exit_code
        pv.committed_value_digest = list(tail.committed_value_digest)
        pv.deferred_proofs_digest = list(tail.deferred_proofs_digest)
        pv.prev_init_addr = pv.last_init_addr = tail.last_init_addr
        pv.prev_finalize_addr = pv.last_finalize_addr = tail.last_finalize_addr


def _start_point():
    return ([int(c) for c in START[0]], [int(c) for c in START[1]])


def _neg_point(p):
    x, y = p
    return (list(x), [(ff.P - c) % ff.P for c in y])


def _complete_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            raise VerificationError("unexpected septic point doubling in digest sum")
        return None
    return septic.curve_add_int(p1, p2)


def mips_machine(config: StarkConfig | None = None, minimal: bool = False) -> MipsMachine:
    """The MIPS machine: the reference's 49 chips, or with ``minimal=True``
    the fifteen of ``minimal_chip_airs``."""
    if minimal:
        return MipsMachine(config, chip_airs=minimal_chip_airs())
    return MipsMachine(config)


def prove_program(program, stdin=(), config: StarkConfig | None = None,
                  machine: MipsMachine | None = None, shard_size: int = 1 << 20, device=None):
    """Execute ``program`` and prove every shard with ``machine`` (the full
    machine unless given): (machine, pk, proofs, info)."""
    from ..executor import execute_for_proving

    device = resolve_device(device)
    m = machine or MipsMachine(config)
    records, info = execute_for_proving(program, stdin_bufs=stdin, shard_size=shard_size)
    pk = m.setup(program, device=device)
    proofs = m.prove(pk, records, device=device)
    return m, pk, proofs, info


def verify_program(m: MipsMachine, vk, proofs, program) -> bool:
    return m.verify(vk, proofs, program)
