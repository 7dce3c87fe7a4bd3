"""Execution events + per-shard record container.

Mirrors the reference's event model (crates/core/executor/src/events/ and
record.rs:30-75): memory accesses carry (value, shard, timestamp) triples and
their previous values, the CPU event carries the full per-cycle context, and
the record buckets events per chip family.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .opcodes import Opcode


@dataclass(frozen=True, slots=True)
class MemoryRecord:
    value: int
    shard: int
    timestamp: int


@dataclass(frozen=True, slots=True)
class MemoryReadRecord:
    value: int
    shard: int
    timestamp: int
    prev_shard: int
    prev_timestamp: int

    @property
    def prev_value(self) -> int:
        return self.value


@dataclass(frozen=True, slots=True)
class MemoryWriteRecord:
    value: int
    shard: int
    timestamp: int
    prev_value: int
    prev_shard: int
    prev_timestamp: int


@dataclass(slots=True)
class MemoryAccessRecord:
    a: object = None  # read or write record
    b: object = None
    c: object = None
    hi: object = None
    memory: object = None
    memory_addr: int | None = None


@dataclass(frozen=True, slots=True)
class CpuEvent:
    clk: int
    pc: int
    next_pc: int
    next_next_pc: int
    instruction: object  # Instruction
    a: int
    b: int
    c: int
    hi_or_prev_a: int | None
    access: MemoryAccessRecord
    exit_code: int
    syscall_code: int
    is_delay_slot: bool


@dataclass(frozen=True, slots=True)
class AluEvent:
    opcode: Opcode
    a: int
    b: int
    c: int
    hi: int = 0


@dataclass(frozen=True, slots=True)
class SyscallEvent:
    shard: int
    clk: int
    syscall_id: int
    arg1: int
    arg2: int


@dataclass(frozen=True, slots=True)
class MemoryLocalEvent:
    addr: int
    initial: MemoryRecord  # record BEFORE first access in this shard
    final: MemoryRecord  # record AFTER last access in this shard


@dataclass(frozen=True, slots=True)
class MemoryInitFinalEvent:
    addr: int
    value: int
    shard: int
    timestamp: int
    used: int


@dataclass(slots=True)
class PublicValues:
    """Shard public values (full analog of air/public_values.rs:11-56)."""

    committed_value_digest: list = field(default_factory=lambda: [0] * 8)
    deferred_proofs_digest: list = field(default_factory=lambda: [0] * 8)
    shard: int = 1
    execution_shard: int = 1
    start_pc: int = 0
    next_pc: int = 0
    exit_code: int = 0
    # previous/last global memory init/finalize address endpoints (u32 each;
    # reference carries them as 32 bit columns, we carry 16-bit limb pairs
    # in the PV vector — see machine/pv.py)
    prev_init_addr: int = 0
    last_init_addr: int = 0
    prev_finalize_addr: int = 0
    last_finalize_addr: int = 0


@dataclass
class ExecutionRecord:
    shard: int = 1
    program: object = None
    cpu_events: list = field(default_factory=list)
    alu_events: list = field(default_factory=list)  # AluEvent (all ALU groups)
    memory_instr_events: list = field(default_factory=list)  # CpuEvent refs
    branch_events: list = field(default_factory=list)
    jump_events: list = field(default_factory=list)
    misc_events: list = field(default_factory=list)
    syscall_events: list = field(default_factory=list)
    local_memory_access: dict = field(default_factory=dict)  # addr -> MemoryLocalEvent
    # per-address chains closed out mid-shard (a precompile touched the addr,
    # splitting the CPU-side access chain; reference record.rs
    # cpu_local_memory_access)
    cpu_local_memory_access: list = field(default_factory=list)
    global_memory_initialize_events: list = field(default_factory=list)
    global_memory_finalize_events: list = field(default_factory=list)
    byte_lookups: dict = field(default_factory=dict)  # "arrays" -> [(op, a, b, c) arrays]
    deferred_proof_digests: list = field(default_factory=list)  # (vkey[8], pv_digest[8])
    global_lookup_events: list = field(default_factory=list)
    nested_alu_events: list = field(default_factory=list)
    precompile_events: dict = field(default_factory=dict)  # name -> [events]
    # parallel to precompile_events: per-event SyscallEvent and the memory
    # chains the syscall itself performed (move together on split())
    precompile_syscall_events: dict = field(default_factory=dict)  # name -> [SyscallEvent]
    precompile_local_mem: dict = field(default_factory=dict)  # name -> [[MemoryLocalEvent]]
    public_values: PublicValues = field(default_factory=PublicValues)

    def add_alu_event(self, e: AluEvent):
        self.alu_events.append(e)

    def all_local_memory_events(self) -> list:
        """Every shard-local memory chain this record anchors: the live
        per-address CPU chains, chains closed out by precompile syscalls, and
        the syscalls' own chains (for precompile events still in this record)."""
        out = list(self.local_memory_access.values())
        out.extend(self.cpu_local_memory_access)
        for lists in self.precompile_local_mem.values():
            for evs in lists:
                out.extend(evs)
        return out

    def split(self, last: bool, split_threshold: int, rows_per_event=None) -> list:
        """Carve large precompile event families into standalone deferred
        records (reference record.rs:110-146 ``split`` + opts.rs
        SPLIT_THRESHOLD): each deferred record holds only precompile events,
        their syscall events, and the memory chains the syscalls performed.
        Cross-shard consistency rides the Global chip: the core shard sends
        each syscall message onto the septic curve (SyscallCore chip) and the
        deferred shard receives it (SyscallPrecompile chip); memory chains use
        the same Global memory argument as ordinary shards.

        Mutates self (moves events out); returns the new deferred records.
        ``last`` forces every remaining precompile family out regardless of
        size, mirroring the reference's final-shard behavior.
        """
        rows_of = rows_per_event or DEFAULT_ROWS_PER_EVENT
        deferred = []
        for name in list(self.precompile_events):
            events = self.precompile_events[name]
            if not events:
                continue
            if name not in self.precompile_syscall_events:
                continue  # event family without a syscall bridge (e.g. sys_linux)
            rpe = rows_of.get(name, 1)
            if not last and len(events) * rpe < split_threshold:
                continue
            syscalls = self.precompile_syscall_events.get(name, [])
            locals_ = self.precompile_local_mem.get(name, [])
            assert len(syscalls) == len(events) and len(locals_) == len(events), (
                f"precompile bookkeeping out of sync for {name}: "
                f"{len(events)} events, {len(syscalls)} syscalls, {len(locals_)} locals"
            )
            chunk = max(1, split_threshold // rpe)
            for i in range(0, len(events), chunk):
                rec = ExecutionRecord(shard=self.shard, program=self.program)
                rec.precompile_events[name] = events[i : i + chunk]
                rec.precompile_syscall_events[name] = syscalls[i : i + chunk]
                rec.precompile_local_mem[name] = locals_[i : i + chunk]
                rec.public_values.committed_value_digest = list(
                    self.public_values.committed_value_digest
                )
                rec.public_values.exit_code = self.public_values.exit_code
                deferred.append(rec)
            del self.precompile_events[name]
            self.precompile_syscall_events.pop(name, None)
            self.precompile_local_mem.pop(name, None)
        return deferred


# row-count estimates used only to decide when a family is big enough to
# split out (soundness does not depend on them)
DEFAULT_ROWS_PER_EVENT = {
    "sha_extend": 48,
    "sha_compress": 80,
    "poseidon2": 1,
    "keccak_sponge": 24,
}


@dataclass(frozen=True, slots=True)
class ShaExtendEvent:
    """48 message-schedule iterations (reference sha256/extend.rs)."""

    shard: int
    clk: int  # clk of the syscall row; iteration i uses clk + (i - 16)
    w_ptr: int
    arg2: int
    reads_15: tuple  # 48 x MemoryReadRecord
    reads_2: tuple
    reads_16: tuple
    reads_7: tuple
    writes: tuple  # 48 x MemoryWriteRecord


@dataclass(frozen=True, slots=True)
class ShaCompressEvent:
    """SHA-256 compression (reference sha256/compress.rs): 8 h reads + 64 w
    reads at clk, 8 h writes at clk + 1."""

    shard: int
    clk: int
    w_ptr: int
    h_ptr: int
    h_reads: tuple
    w_reads: tuple
    h_writes: tuple
