"""MIPS32r2 interpreter with event recording and shard splitting.

Pure-Python reference implementation, semantics faithful to the reference
executor (crates/core/executor/src/executor.rs): delay slots via
(pc, next_pc, next_next_pc), clk += 5 per cycle with per-position access
timestamps (events/memory.rs:29-40), registers as memory addresses 0..35,
lexicographic (shard, timestamp) memory ordering with (0, 0) as the
initial-state sentinel, and HALT steering next_pc to 0.

Modes (executor.rs:175-182): Simple (no events), Trace (full events).
Checkpoint mode is subsumed by ``fork_state`` snapshots here.
"""

from __future__ import annotations

from dataclasses import dataclass

from .events import (
    AluEvent,
    CpuEvent,
    ExecutionRecord,
    MemoryAccessRecord,
    MemoryInitFinalEvent,
    MemoryLocalEvent,
    MemoryReadRecord,
    MemoryRecord,
    MemoryWriteRecord,
    SyscallEvent,
)
from .instruction import Instruction
from .native import ExecutionError
from .opcodes import (
    POS_A,
    POS_B,
    POS_C,
    POS_HI,
    POS_MEMORY,
    ALU_OPS,
    BRANCH_OPS,
    JUMP_OPS,
    LOAD_OPS,
    LO_HI_OPS,
    MISC_OPS,
    MOVCOND_OPS,
    ONE_OPERAND_BRANCH,
    STORE_OPS,
    Opcode,
    Register,
    SyscallCode,
)
from .program import MAX_MEMORY, Program
from . import syscalls as syscalls_mod

MASK32 = 0xFFFFFFFF


class ExecutorMode:
    Simple = 0
    Trace = 2


class Executor:
    def __init__(self, program: Program, shard_size: int = 1 << 20, mode: int = ExecutorMode.Trace,
                 max_lde_size: int | None = None):
        self.program = program
        self.mode = mode
        self.shard_size = shard_size  # max cycles (cpu events) per shard
        if max_lde_size is None:
            from ..utils.opts import ZKMCoreOpts

            max_lde_size = ZKMCoreOpts.default().max_lde_size
        self.max_lde_size = max_lde_size  # estimated LDE cells before shard bump
        self._shard_group_counts: dict = {}

        # state
        self.pc = program.pc_start
        self.next_pc = program.pc_start + 4
        self.clk = 0
        self.global_clk = 0
        self.shard = 1
        self.exited = False
        self.exit_code = 0
        self.next_is_delayslot = False

        # memory: addr -> MemoryRecord; registers are addrs 0..35
        self.memory: dict[int, MemoryRecord] = {}
        self.uninitialized_memory: dict[int, int] = {}
        self.touched_order: list[int] = []  # addresses in first-touch order

        # io
        self.input_stream: list[bytes] = []
        self.input_stream_ptr = 0
        self.public_values_stream = bytearray()
        self.stdout = bytearray()
        self.committed_value_digest = [0] * 8
        self.deferred_proofs_digest = [0] * 8
        # host-provided (proof, vk) pairs consumed by VERIFY_ZKM_PROOF; the
        # optional callback verifies them during execution (ZKMContext's
        # subproof verifier, reference context.rs)
        self.proof_stream: list = []
        self.proof_stream_ptr = 0
        self.subproof_verifier = None

        # unconstrained (hint-generation) mode: fork/rollback state
        self.unconstrained = False
        self._fork = None
        # active precompile-syscall memory scope (addr -> MemoryLocalEvent)
        self._syscall_local: dict | None = None

        # records
        self.record = ExecutionRecord(shard=1, program=program)
        self.records: list[ExecutionRecord] = []
        self.access: MemoryAccessRecord | None = None
        self.report_opcode_counts: dict = {}
        self.report_syscall_counts: dict = {}
        self.cycle_tracker: dict[str, int] = {}
        from .hooks import default_registry

        self.hook_registry = default_registry()
        self._io_buf: dict[int, str] = {}

    # ------------------------------------------------------------- io API

    def write_stdin(self, data: bytes):
        self.input_stream.append(bytes(data))

    # --------------------------------------------------------- mem access

    def _load_initial(self, addr: int) -> MemoryRecord:
        if addr in self.uninitialized_memory:
            value = self.uninitialized_memory[addr]
        else:
            value = self.program.image.get(addr, 0)
        rec = MemoryRecord(value, 0, 0)
        self.memory[addr] = rec
        self.touched_order.append(addr)
        return rec

    def _mr(self, addr: int, timestamp: int) -> MemoryReadRecord:
        prev = self.memory.get(addr)
        if prev is None:
            prev = self._load_initial(addr)
        rec = MemoryRecord(prev.value, self.shard, timestamp)
        self.memory[addr] = rec
        self._track_local(addr, prev, rec)
        return MemoryReadRecord(prev.value, self.shard, timestamp, prev.shard, prev.timestamp)

    def _mw(self, addr: int, value: int, timestamp: int) -> MemoryWriteRecord:
        prev = self.memory.get(addr)
        if prev is None:
            prev = self._load_initial(addr)
        rec = MemoryRecord(value, self.shard, timestamp)
        self.memory[addr] = rec
        self._track_local(addr, prev, rec)
        return MemoryWriteRecord(value, self.shard, timestamp, prev.value, prev.shard, prev.timestamp)

    def _track_local(self, addr: int, prev: MemoryRecord, new: MemoryRecord):
        # during a precompile syscall the accesses form their own chain,
        # recorded with the event so it can move to a deferred shard
        # (reference syscalls/context.rs:28,128)
        if self.unconstrained:
            return  # rolled back wholesale at exit_unconstrained
        target = self._syscall_local if self._syscall_local is not None else self.record.local_memory_access
        ev = target.get(addr)
        if ev is None:
            target[addr] = MemoryLocalEvent(addr, prev, new)
        else:
            target[addr] = MemoryLocalEvent(addr, ev.initial, new)

    def _postprocess_precompile_syscall(self, code, clk: int, b: int, c: int, before: dict, sc_local: dict):
        """Close out CPU-side chains for addresses the syscall touched and
        attach the syscall's own chains to its precompile event (reference
        syscalls/context.rs:128 postprocess)."""
        key = None
        for k, v in self.record.precompile_events.items():
            if len(v) != before.get(k, 0):
                key = k
                break
        if key is None:
            return  # event-less send (e.g. filtered in unconstrained replays)
        for addr in sc_local:
            prior = self.record.local_memory_access.pop(addr, None)
            if prior is not None:
                self.record.cpu_local_memory_access.append(prior)
        self.record.precompile_syscall_events.setdefault(key, []).append(
            SyscallEvent(self.shard, clk, int(code), b, c)
        )
        self.record.precompile_local_mem.setdefault(key, []).append(list(sc_local.values()))

    def _timestamp(self, pos: int) -> int:
        return self.clk + pos

    # register helpers
    def register(self, reg: int) -> int:
        """Peek a register without creating an access record."""
        rec = self.memory.get(reg)
        if rec is None:
            rec = self._load_initial(reg)
        return rec.value

    def word(self, addr: int) -> int:
        rec = self.memory.get(addr)
        if rec is None:
            if addr in self.uninitialized_memory:
                return self.uninitialized_memory[addr]
            return self.program.image.get(addr, 0)
        return rec.value

    def byte(self, addr: int) -> int:
        return (self.word(addr & ~3) >> ((addr % 4) * 8)) & 0xFF

    def rr_cpu(self, reg: int, pos: int) -> int:
        rec = self._mr(reg, self._timestamp(pos))
        if self.access is not None:
            if pos == POS_A:
                self.access.a = rec
            elif pos == POS_B:
                self.access.b = rec
            elif pos == POS_C:
                self.access.c = rec
        return rec.value

    def rw_cpu(self, reg: int, value: int, pos: int):
        if reg == Register.ZERO:
            value = 0
        rec = self._mw(reg, value & MASK32, self._timestamp(pos))
        if self.access is not None:
            if pos == POS_A:
                self.access.a = rec
            elif pos == POS_HI:
                self.access.hi = rec

    def mr_cpu(self, addr: int) -> int:
        rec = self._mr(addr, self._timestamp(POS_MEMORY))
        if self.access is not None:
            self.access.memory = rec
            self.access.memory_addr = addr
        return rec.value

    def mw_cpu(self, addr: int, value: int):
        rec = self._mw(addr, value & MASK32, self._timestamp(POS_MEMORY))
        if self.access is not None:
            self.access.memory = rec
            self.access.memory_addr = addr

    # ----------------------------------------------- unconstrained + forking

    def enter_unconstrained(self):
        """Fork the architectural state (reference ENTER_UNCONSTRAINED,
        syscalls/unconstrained.rs + ForkState): memory/registers diffs are
        rolled back on exit; no events are recorded meanwhile.  The ENTER
        row's own access record is stashed so the merged row emitted at exit
        carries the ENTER row's b/c register reads."""
        assert not self.unconstrained, "already unconstrained"
        self._fork = self.checkpoint()
        self._fork["access"] = self.access
        self.unconstrained = True

    def exit_unconstrained(self):
        assert self.unconstrained, "not in unconstrained mode"
        access = self._fork.get("access")
        self.restore(self._fork)
        self.access = access
        self._fork = None
        self.unconstrained = False

    def checkpoint(self) -> dict:
        """Minimal resumable snapshot (reference ExecutionState serialization,
        executor.rs:2330 execute_state): architectural state only — records
        are regenerated by re-execution from the snapshot."""
        return {
            "pc": self.pc, "next_pc": self.next_pc, "clk": self.clk,
            "global_clk": self.global_clk, "shard": self.shard,
            "next_is_delayslot": self.next_is_delayslot,
            "memory": dict(self.memory),
            "uninitialized_memory": dict(self.uninitialized_memory),
            "touched_order": list(self.touched_order),
            "input_stream_ptr": self.input_stream_ptr,
            "exit_code": self.exit_code, "exited": self.exited,
            "committed_value_digest": list(self.committed_value_digest),
            "deferred_proofs_digest": list(self.deferred_proofs_digest),
        }

    def checkpoint_bytes(self) -> bytes:
        """Byte-stable serialized checkpoint (the work-distribution unit the
        reference writes to disk between the execution and prove phases,
        executor.rs:2330): a versioned little-endian codec, no pickle, safe
        to ship to a remote prover worker."""
        import struct

        snap = self.checkpoint()
        out = [b"ZKCK\x01\x00"]
        out.append(struct.pack(
            "<QQQQQ?I?", snap["pc"], snap["next_pc"], snap["clk"],
            snap["global_clk"], snap["shard"], snap["next_is_delayslot"],
            snap["exit_code"] & 0xFFFFFFFF, snap["exited"],
        ))
        out.append(struct.pack("<Q", snap["input_stream_ptr"]))
        for key8 in ("committed_value_digest", "deferred_proofs_digest"):
            vals = snap[key8]
            out.append(struct.pack("<B", len(vals)))
            out.append(struct.pack(f"<{len(vals)}I", *[v & 0xFFFFFFFF for v in vals]))
        mem = snap["memory"]
        out.append(struct.pack("<Q", len(mem)))
        for addr in sorted(mem):
            r = mem[addr]
            out.append(struct.pack("<QIQQ", addr, r.value, r.shard, r.timestamp))
        um = snap["uninitialized_memory"]
        out.append(struct.pack("<Q", len(um)))
        for addr in sorted(um):
            out.append(struct.pack("<QI", addr, um[addr]))
        to = snap["touched_order"]
        out.append(struct.pack("<Q", len(to)))
        out.append(struct.pack(f"<{len(to)}Q", *to))
        return b"".join(out)

    def restore_bytes(self, data: bytes):
        """Inverse of ``checkpoint_bytes``."""
        import struct

        from .events import MemoryRecord

        if data[:6] != b"ZKCK\x01\x00":
            raise ValueError("bad checkpoint magic/version")
        off = 6
        (pc, next_pc, clk, global_clk, shard, delay, exit_code,
         exited) = struct.unpack_from("<QQQQQ?I?", data, off)
        off += struct.calcsize("<QQQQQ?I?")
        (isp,) = struct.unpack_from("<Q", data, off); off += 8
        digests = []
        for _ in range(2):
            (n,) = struct.unpack_from("<B", data, off); off += 1
            digests.append(list(struct.unpack_from(f"<{n}I", data, off)))
            off += 4 * n
        (nm,) = struct.unpack_from("<Q", data, off); off += 8
        memory = {}
        for _ in range(nm):
            addr, val, sh, ts = struct.unpack_from("<QIQQ", data, off)
            off += struct.calcsize("<QIQQ")
            memory[addr] = MemoryRecord(val, sh, ts)
        (nu,) = struct.unpack_from("<Q", data, off); off += 8
        um = {}
        for _ in range(nu):
            addr, val = struct.unpack_from("<QI", data, off); off += 12
            um[addr] = val
        (nt,) = struct.unpack_from("<Q", data, off); off += 8
        touched = list(struct.unpack_from(f"<{nt}Q", data, off))
        off += 8 * nt
        if off != len(data):
            raise ValueError("trailing bytes in checkpoint")
        self.restore({
            "pc": pc, "next_pc": next_pc, "clk": clk, "global_clk": global_clk,
            "shard": shard, "next_is_delayslot": delay, "memory": memory,
            "uninitialized_memory": um, "touched_order": touched,
            "input_stream_ptr": isp, "exit_code": exit_code, "exited": exited,
            "committed_value_digest": digests[0],
            "deferred_proofs_digest": digests[1],
        })

    def restore(self, snap: dict):
        self.pc = snap["pc"]
        self.next_pc = snap["next_pc"]
        self.clk = snap["clk"]
        self.global_clk = snap["global_clk"]
        self.shard = snap["shard"]
        self.next_is_delayslot = snap["next_is_delayslot"]
        self.memory = dict(snap["memory"])
        self.uninitialized_memory = dict(snap["uninitialized_memory"])
        self.touched_order = list(snap["touched_order"])
        self.input_stream_ptr = snap["input_stream_ptr"]
        self.exit_code = snap["exit_code"]
        self.exited = snap["exited"]
        self.committed_value_digest = list(snap["committed_value_digest"])
        self.deferred_proofs_digest = list(snap["deferred_proofs_digest"])

    # ------------------------------------------------------------ running

    def run(self, max_cycles: int | None = None):
        while not self.exited:
            if self.pc == 0:
                break
            self.execute_cycle()
            if max_cycles is not None and self.global_clk >= max_cycles:
                raise ExecutionError(f"exceeded max_cycles {max_cycles}")
        self._bump_record(final=True)
        self._postprocess()
        return self.records

    def run_stream(self, max_cycles: int | None = None):
        """Generator: yield each record the moment its shard boundary is
        crossed (the prove.rs:157-520 checkpoint-channel analog).  Records
        are fully formed at yield time — global memory init/finalize anchors
        on the final record (_postprocess) — and are dropped from
        ``self.records`` after yielding so host memory stays flat as the
        cycle count grows."""
        yielded = 0
        while not self.exited:
            if self.pc == 0:
                break
            self.execute_cycle()
            if max_cycles is not None and self.global_clk >= max_cycles:
                raise ExecutionError(f"exceeded max_cycles {max_cycles}")
            while len(self.records) > yielded:
                r = self.records[yielded]
                self.records[yielded] = None  # release event memory
                yielded += 1
                yield r
        self._bump_record(final=True)
        self._postprocess()
        while len(self.records) > yielded:
            r = self.records[yielded]
            self.records[yielded] = None
            yielded += 1
            yield r

    def execute_cycle(self):
        instruction = self.program.fetch(self.pc)
        in_delay_slot = self.next_is_delayslot
        self.execute_operation(instruction, in_delay_slot)
        self.global_clk += 1
        if not self.unconstrained:
            op = instruction.opcode
            self.report_opcode_counts[op] = self.report_opcode_counts.get(op, 0) + 1
            g = self._shard_group_counts
            g[op] = g.get(op, 0) + 1
        n = len(self.record.cpu_events)
        if not self.next_is_delayslot and (
            n >= self.shard_size or (n & 0xFFF) == 0 and n and self._lde_probe(n)
        ):
            self._bump_record()

    def _lde_probe(self, n_cpu: int) -> bool:
        """Shape probe (cost.rs usage, executor.rs:2183-2272): bump the shard
        early if its estimated LDE area exceeds the memory budget."""
        from . import cost

        counts = {
            "Cpu": n_cpu,
            "MemoryLocal": len(self.record.local_memory_access)
            + len(self.record.cpu_local_memory_access),
        }
        for op, n in self._shard_group_counts.items():
            name = cost.chip_group(op)
            if name is not None:
                counts[name] = counts.get(name, 0) + n
        return cost.estimate_lde_size(counts) > self.max_lde_size

    def _bump_record(self, final: bool = False):
        self._shard_group_counts = {}
        pv = self.record.public_values
        pv.shard = self.shard
        pv.execution_shard = self.shard
        pv.exit_code = self.exit_code
        pv.committed_value_digest = list(self.committed_value_digest)
        pv.deferred_proofs_digest = list(self.deferred_proofs_digest)
        if self.record.cpu_events or final:
            self.records.append(self.record)
        if not final:
            self.shard += 1
            self.clk = 0
            self.record = ExecutionRecord(shard=self.shard, program=self.program)

    def _postprocess(self):
        """Build global memory init/finalize events (executor.rs:2506).

        Both sets attach to the LAST record: the first-touch (init) set is
        only known once execution ends, so anchoring it at the tail keeps
        every earlier record fully formed the moment its shard boundary is
        crossed — the streaming prove pipeline (machine.prove_streaming)
        depends on that.  The global memory multiset argument is
        shard-agnostic; only the PV address-endpoint chain must match
        (zeros everywhere except the final shard)."""
        last = self.records[-1] if self.records else None
        if last is None:
            return
        for addr in self.touched_order:
            rec = self.memory[addr]
            if addr in self.uninitialized_memory:
                init_val = self.uninitialized_memory[addr]
            else:
                init_val = self.program.image.get(addr, 0)
            last.global_memory_initialize_events.append(
                MemoryInitFinalEvent(addr, init_val, 0, 0, 1)
            )
            last.global_memory_finalize_events.append(
                MemoryInitFinalEvent(addr, rec.value, rec.shard, rec.timestamp, 1)
            )
        if 0 not in self.memory:
            # the init/finalize chain must open at address 0 (register ZERO;
            # memory_bridge chain-opener rule mirrors reference global.rs:393)
            last.global_memory_initialize_events.append(
                MemoryInitFinalEvent(0, 0, 0, 0, 1)
            )
            last.global_memory_finalize_events.append(
                MemoryInitFinalEvent(0, 0, 0, 0, 1)
            )
        if len(last.global_memory_initialize_events) < 2:
            # the chain opener AIR needs >= 2 real rows when it opens at
            # address 0 (memory_bridge fr.when_not(fc).assert_one(nxt_real));
            # a guest touching no memory (or only address 0) would otherwise
            # be unprovable.  A balanced init+finalize pair at an untouched
            # address contributes zero to the septic multiset sum.
            pad_addr = 4
            while pad_addr in self.memory:
                pad_addr += 4
            last.global_memory_initialize_events.append(
                MemoryInitFinalEvent(pad_addr, 0, 0, 0, 1)
            )
            last.global_memory_finalize_events.append(
                MemoryInitFinalEvent(pad_addr, 0, 0, 0, 1)
            )
            self.touched_order.append(pad_addr)
        # init/finalize address endpoints (public_values.rs:47-57 chaining):
        # zeros for every shard except the final one, which carries both
        # chains from 0 to the maximum touched address
        max_addr = max((a for a in self.touched_order), default=0)
        pv = last.public_values
        pv.prev_init_addr = 0
        pv.last_init_addr = max_addr
        pv.prev_finalize_addr = 0
        pv.last_finalize_addr = max_addr

    # ----------------------------------------------------- the cycle body

    def execute_operation(self, instruction: Instruction, in_delay_slot: bool):
        pc = self.pc
        clk = self.clk
        exit_code = 0
        next_pc = self.next_pc
        next_next_pc = (self.next_pc + 4) & MASK32
        a = b = c = 0
        hi_or_prev_a = None
        syscall_code = 0
        self.next_is_delayslot = False
        op = instruction.opcode

        if self.mode == ExecutorMode.Trace:
            self.access = MemoryAccessRecord()

        if op in ALU_OPS:
            hi_or_prev_a, a, b, c = self._execute_alu(instruction)
        elif op in LOAD_OPS:
            hi_or_prev_a, a, b, c = self._execute_load(instruction)
        elif op in STORE_OPS:
            hi_or_prev_a, a, b, c = self._execute_store(instruction)
        elif op in BRANCH_OPS:
            a, b, c, next_next_pc = self._execute_branch(instruction, next_pc, next_next_pc)
            self.next_is_delayslot = True
        elif op in JUMP_OPS:
            if op == Opcode.Jump:
                a, b, c, next_next_pc = self._execute_jump(instruction)
            elif op == Opcode.Jumpi:
                a, b, c, next_next_pc = self._execute_jumpi(instruction)
            else:
                a, b, c, next_next_pc = self._execute_jump_direct(instruction)
            self.next_is_delayslot = True
        elif op in MOVCOND_OPS:
            hi_or_prev_a, a, b, c = self._execute_condmov(instruction)
        elif op in MISC_OPS:
            hi_or_prev_a, a, b, c = self._execute_misc(instruction)
        elif op == Opcode.SYSCALL:
            syscall_id = self.register(Register.V0)
            if not self.unconstrained:
                self.report_syscall_counts[syscall_id] = (
                    self.report_syscall_counts.get(syscall_id, 0) + 1
                )
            c = self.rr_cpu(Register.A1, POS_C)
            b = self.rr_cpu(Register.A0, POS_B)
            prev_a = syscall_id
            try:
                code = SyscallCode(syscall_id)
            except ValueError as e:
                raise ExecutionError(f"unsupported syscall {syscall_id:#x}") from e
            if self.unconstrained and code not in (
                SyscallCode.EXIT_UNCONSTRAINED, SyscallCode.WRITE
            ):
                raise ExecutionError(
                    f"syscall {syscall_id:#x} not allowed in unconstrained mode"
                )
            syscall_code = code.syscall_id
            scoped = (
                self.mode == ExecutorMode.Trace
                and not self.unconstrained
                and code.should_send != 0
            )
            if scoped:
                before = {k: len(v) for k, v in self.record.precompile_events.items()}
                self._syscall_local = {}
            try:
                res, s_next_pc, extra_cycles, returned_exit_code = syscalls_mod.dispatch(self, code, b, c)
            finally:
                if scoped:
                    sc_local, self._syscall_local = self._syscall_local, None
            if scoped:
                self._postprocess_precompile_syscall(code, clk, b, c, before, sc_local)
            if code == SyscallCode.EXIT_UNCONSTRAINED:
                # the merged row is the ENTER row returning 0: pc/clk and the
                # operand registers are re-read from the restored state
                # (reference executor.rs:1634-1643)
                b = self.register(Register.A0)
                c = self.register(Register.A1)
                prev_a = self.register(Register.V0)
                clk = self.clk
                pc = self.pc
            a = res if res is not None else syscall_id
            if code == SyscallCode.HALT:
                if returned_exit_code != 0:
                    raise ExecutionError(f"halt with nonzero exit code {returned_exit_code}")
                self.exited = True
            elif code == SyscallCode.SYS_EXT_GROUP:
                self.exited = True
                self.exit_code = returned_exit_code
            self.rw_cpu(Register.V0, a, POS_A)
            next_pc = s_next_pc
            next_next_pc = (s_next_pc + 4) & MASK32
            self.clk += extra_cycles
            exit_code = returned_exit_code
            hi_or_prev_a = prev_a
            if self.mode == ExecutorMode.Trace and code.should_send and not self.unconstrained:
                # store the full raw code word ($v0): the Syscall lookup
                # message carries both 16-bit limbs of it
                self.record.syscall_events.append(
                    SyscallEvent(self.shard, clk, int(code), b, c)
                )
        elif op == Opcode.UNIMPL:
            raise ExecutionError(f"unimplemented instruction {instruction.op_c:#010x} at pc {pc:#x}")
        else:
            raise AssertionError(f"unhandled opcode {op}")

        if next_next_pc == 0 and not self.exited:
            raise ExecutionError(f"null pointer reference at pc {pc:#x}")

        if self.mode == ExecutorMode.Trace:
            self._emit_events(
                clk, pc, next_pc, next_next_pc, instruction, a, b, c,
                hi_or_prev_a, self.access, exit_code, syscall_code, in_delay_slot,
            )

        self.pc = next_pc
        self.next_pc = next_next_pc
        self.clk += 5

    # -- ALU -----------------------------------------------------------------

    def _alu_rr(self, instruction: Instruction):
        if not instruction.imm_c:
            c = self.rr_cpu(instruction.op_c, POS_C)
            b = self.rr_cpu(instruction.op_b, POS_B)
            return instruction.op_a, b, c
        if not instruction.imm_b:
            return instruction.op_a, self.rr_cpu(instruction.op_b, POS_B), instruction.op_c
        return instruction.op_a, instruction.op_b, instruction.op_c

    def _execute_alu(self, instruction: Instruction):
        op = instruction.opcode
        rd, b, c = self._alu_rr(instruction)
        if op in (Opcode.DIV, Opcode.DIVU, Opcode.MOD, Opcode.MODU) and c == 0:
            raise ExecutionError("division by zero trap")
        hi = 0
        if op == Opcode.ADD:
            a = (b + c) & MASK32
        elif op == Opcode.SUB:
            a = (b - c) & MASK32
        elif op == Opcode.SLL:
            a = (b << (c & 0x1F)) & MASK32
        elif op == Opcode.SRL:
            a = b >> (c & 0x1F)
        elif op == Opcode.SRA:
            a = (_s32(b) >> (c & 0x1F)) & MASK32
        elif op == Opcode.ROR:
            s = c & 0x1F
            a = ((b >> s) | (b << (32 - s))) & MASK32 if s else b
        elif op == Opcode.MUL:
            a = (b * c) & MASK32
        elif op == Opcode.SLTU:
            a = 1 if b < c else 0
        elif op == Opcode.SLT:
            a = 1 if _s32(b) < _s32(c) else 0
        elif op == Opcode.MULT:
            out = (_s32(b) * _s32(c)) & 0xFFFFFFFFFFFFFFFF
            a, hi = out & MASK32, out >> 32
        elif op == Opcode.MULTU:
            out = b * c
            a, hi = out & MASK32, out >> 32
        elif op == Opcode.DIV:
            a = _div_s(b, c) & MASK32
            hi = _rem_s(b, c) & MASK32
        elif op == Opcode.DIVU:
            a, hi = b // c, b % c
        elif op == Opcode.MOD:
            a = _rem_s(b, c) & MASK32
        elif op == Opcode.MODU:
            a = b % c
        elif op == Opcode.AND:
            a = b & c
        elif op == Opcode.OR:
            a = b | c
        elif op == Opcode.XOR:
            a = b ^ c
        elif op == Opcode.NOR:
            a = (~(b | c)) & MASK32
        elif op == Opcode.CLZ:
            a = _clz(b)
        elif op == Opcode.CLO:
            a = _clz(~b & MASK32)
        else:
            raise AssertionError(op)
        # write destination (alu_rw, executor.rs:1430-1449)
        if op in LO_HI_OPS and op not in (Opcode.MOD, Opcode.MODU):
            self.rw_cpu(Register.LO, a, POS_A)
            self.rw_cpu(Register.HI, hi, POS_HI)
            return hi, a, b, c
        self.rw_cpu(rd, a, POS_A)
        return None, a, b, c

    # -- loads/stores ---------------------------------------------------------

    def _execute_load(self, instruction: Instruction):
        op = instruction.opcode
        rt_reg, rs_reg, offset = instruction.op_a, instruction.op_b, instruction.op_c
        rs_raw = self.rr_cpu(rs_reg, POS_B)
        rt = self.register(rt_reg)
        addr = (rs_raw + offset) & MASK32
        aligned = addr & 0xFFFFFFFC
        if aligned < 0x1000:
            raise ExecutionError(f"guest memory below 0x1000 is reserved ({addr:#x})")
        mem = self.mr_cpu(aligned)
        if aligned + 3 > MAX_MEMORY:
            raise ExecutionError(f"memory out of bounds {addr:#x}")
        i = addr & 3
        if op == Opcode.LW or op == Opcode.LL:
            if addr & 3:
                raise ExecutionError(f"unaligned LW at {addr:#x}")
            val = mem
        elif op == Opcode.LB:
            val = _sext8((mem >> (i * 8)) & 0xFF)
        elif op == Opcode.LBU:
            val = (mem >> (i * 8)) & 0xFF
        elif op == Opcode.LH:
            if addr & 1:
                raise ExecutionError(f"unaligned LH at {addr:#x}")
            val = _sext16((mem >> ((addr & 2) * 8)) & 0xFFFF)
        elif op == Opcode.LHU:
            if addr & 1:
                raise ExecutionError(f"unaligned LHU at {addr:#x}")
            val = (mem >> ((addr & 2) * 8)) & 0xFFFF
        elif op == Opcode.LWL:
            sh = 24 - i * 8
            mask = (0xFFFFFFFF << sh) & MASK32
            val = (rt & ~mask) | ((mem << sh) & MASK32 & mask)
        elif op == Opcode.LWR:
            sh = i * 8
            mask = 0xFFFFFFFF >> sh
            val = (rt & ~mask & MASK32) | (mem >> sh)
        else:
            raise AssertionError(op)
        self.rw_cpu(rt_reg, val, POS_A)
        return rt, val, rs_raw, offset

    def _execute_store(self, instruction: Instruction):
        op = instruction.opcode
        rt_reg, rs_reg, offset = instruction.op_a, instruction.op_b, instruction.op_c
        rs = self.rr_cpu(rs_reg, POS_B)
        if op == Opcode.SC:
            rt = self.register(rt_reg)
        else:
            rt = self.rr_cpu(rt_reg, POS_A)
        addr = (rs + offset) & MASK32
        aligned = addr & 0xFFFFFFFC
        mem = self.word(aligned)
        i = addr & 3
        if op == Opcode.SB:
            mask = MASK32 ^ (0xFF << (i * 8))
            val = (mem & mask) | ((rt & 0xFF) << (i * 8))
        elif op == Opcode.SH:
            if addr & 1:
                raise ExecutionError(f"unaligned SH at {addr:#x}")
            sh = (addr & 2) * 8
            mask = MASK32 ^ (0xFFFF << sh)
            val = (mem & mask) | ((rt & 0xFFFF) << sh)
        elif op == Opcode.SWL:
            sh = 24 - i * 8
            mask = 0xFFFFFFFF >> sh
            val = (mem & ~mask & MASK32) | (rt >> sh)
        elif op == Opcode.SW or op == Opcode.SC:
            if addr & 3:
                raise ExecutionError(f"unaligned SW at {addr:#x}")
            val = rt
        elif op == Opcode.SWR:
            sh = i * 8
            mask = (0xFFFFFFFF << sh) & MASK32
            val = (mem & ~mask & MASK32) | ((rt << sh) & MASK32 & mask)
        else:
            raise AssertionError(op)
        if aligned + 3 > MAX_MEMORY or aligned < 0x1000:
            raise ExecutionError(f"memory out of bounds {addr:#x}")
        self.mw_cpu(aligned, val)
        if op == Opcode.SC:
            self.rw_cpu(rt_reg, 1, POS_A)
            return rt, 1, rs, offset
        return rt, rt, rs, offset

    # -- branches/jumps -------------------------------------------------------

    def _execute_branch(self, instruction: Instruction, next_pc: int, next_next_pc: int):
        op = instruction.opcode
        if op in ONE_OPERAND_BRANCH:
            b = 0
        else:
            b = self.rr_cpu(instruction.op_b, POS_B)
        a = self.rr_cpu(instruction.op_a, POS_A)
        target = instruction.op_c
        if op == Opcode.BEQ:
            jump = a == b
        elif op == Opcode.BNE:
            jump = a != b
        elif op == Opcode.BGEZ:
            jump = _s32(a) >= 0
        elif op == Opcode.BLEZ:
            jump = _s32(a) <= 0
        elif op == Opcode.BGTZ:
            jump = _s32(a) > 0
        else:
            jump = _s32(a) < 0
        if jump:
            next_next_pc = (target + next_pc) & MASK32
        return a, b, target, next_next_pc

    def _execute_jump(self, instruction: Instruction):
        target_pc = self.rr_cpu(instruction.op_b, POS_B)
        return_pc = (self.next_pc + 4) & MASK32
        self.rw_cpu(instruction.op_a, return_pc, POS_A)
        return return_pc, target_pc, 0, target_pc

    def _execute_jumpi(self, instruction: Instruction):
        target_pc = instruction.op_b
        return_pc = (self.next_pc + 4) & MASK32
        self.rw_cpu(instruction.op_a, return_pc, POS_A)
        return return_pc, target_pc, 0, target_pc

    def _execute_jump_direct(self, instruction: Instruction):
        offset = instruction.op_b
        target_pc = (offset + self.next_pc) & MASK32
        return_pc = (self.next_pc + 4) & MASK32
        self.rw_cpu(instruction.op_a, return_pc, POS_A)
        return return_pc, offset, 0, target_pc

    # -- misc -----------------------------------------------------------------

    def _execute_condmov(self, instruction: Instruction):
        rd = instruction.op_a
        a = self.register(rd)
        prev_a = a
        c = self.rr_cpu(instruction.op_c, POS_C)
        b = self.rr_cpu(instruction.op_b, POS_B)
        mov = (c == 0) if instruction.opcode == Opcode.MEQ else (c != 0)
        if mov:
            a = b
        self.rw_cpu(rd, a, POS_A)
        return prev_a, a, b, c

    def _execute_misc(self, instruction: Instruction):
        op = instruction.opcode
        if op == Opcode.WSBH:
            b = self.rr_cpu(instruction.op_b, POS_B)
            a = (((b >> 16) & 0xFF) << 24) | (((b >> 24) & 0xFF) << 16) | ((b & 0xFF) << 8) | ((b >> 8) & 0xFF)
            self.rw_cpu(instruction.op_a, a, POS_A)
            return None, a, b, 0
        if op == Opcode.SEXT:
            b = self.rr_cpu(instruction.op_b, POS_B)
            c = instruction.op_c
            a = _sext16(b & 0xFFFF) if c > 0 else _sext8(b & 0xFF)
            self.rw_cpu(instruction.op_a, a, POS_A)
            return None, a, b, c
        if op == Opcode.EXT:
            b = self.rr_cpu(instruction.op_b, POS_B)
            c = instruction.op_c
            msbd, lsb = c >> 5, c & 0x1F
            mask = MASK32 if msbd + lsb + 1 == 32 else (1 << (msbd + lsb + 1)) - 1
            a = (b & mask) >> lsb
            self.rw_cpu(instruction.op_a, a, POS_A)
            return None, a, b, c
        if op == Opcode.INS:
            rd = instruction.op_a
            b = self.rr_cpu(instruction.op_b, POS_B)
            prev_a = self.register(rd)
            c = instruction.op_c
            msb, lsb = c >> 5, c & 0x1F
            mask = MASK32 if msb - lsb + 1 == 32 else (1 << (msb - lsb + 1)) - 1
            mask_field = (mask << lsb) & MASK32
            a = (prev_a & ~mask_field & MASK32) | ((b << lsb) & mask_field)
            self.rw_cpu(rd, a, POS_A)
            return prev_a, a, b, c
        if op == Opcode.TEQ:
            src2 = self.rr_cpu(instruction.op_b, POS_B)
            src1 = self.rr_cpu(instruction.op_a, POS_A)
            if src1 == src2:
                raise ExecutionError("TEQ trap")
            return None, src1, src2, 0
        if op in (Opcode.MADDU, Opcode.MSUBU, Opcode.MADD, Opcode.MSUB):
            c = self.rr_cpu(instruction.op_c, POS_C)
            b = self.rr_cpu(instruction.op_b, POS_B)
            lo_val = self.register(Register.LO)
            hi_val = self.register(Register.HI)
            addend = (hi_val << 32) | lo_val
            if op == Opcode.MADDU:
                out = (b * c + addend) & 0xFFFFFFFFFFFFFFFF
            elif op == Opcode.MSUBU:
                out = (addend - b * c) & 0xFFFFFFFFFFFFFFFF
            elif op == Opcode.MADD:
                out = (_s32(b) * _s32(c) + addend) & 0xFFFFFFFFFFFFFFFF
            else:
                out = (addend - _s32(b) * _s32(c)) & 0xFFFFFFFFFFFFFFFF
            out_lo, out_hi = out & MASK32, out >> 32
            self.rw_cpu(Register.LO, out_lo, POS_A)
            self.rw_cpu(Register.HI, out_hi, POS_HI)
            return lo_val, out_lo, b, c
        raise AssertionError(op)

    # -- event emission -------------------------------------------------------

    def _emit_events(self, clk, pc, next_pc, next_next_pc, instruction, a, b, c,
                     hi_or_prev_a, access, exit_code, syscall_code, in_delay_slot):
        if self.unconstrained:
            return  # the whole block is rolled back at exit_unconstrained
        ev = CpuEvent(
            clk, pc, next_pc, next_next_pc, instruction, a, b, c,
            hi_or_prev_a, access, exit_code, syscall_code, in_delay_slot,
        )
        self.record.cpu_events.append(ev)
        op = instruction.opcode
        if op in ALU_OPS:
            hi = hi_or_prev_a if hi_or_prev_a is not None else 0
            self.record.alu_events.append(AluEvent(op, a, b, c, hi))
        elif op in LOAD_OPS or op in STORE_OPS:
            self.record.memory_instr_events.append(ev)
        elif op in BRANCH_OPS:
            self.record.branch_events.append(ev)
        elif op in JUMP_OPS:
            self.record.jump_events.append(ev)
        elif op in MISC_OPS or op in MOVCOND_OPS:
            self.record.misc_events.append(ev)


def _s32(x: int) -> int:
    return x - 0x100000000 if x & 0x80000000 else x


def _sext8(x: int) -> int:
    return (x | 0xFFFFFF00) & MASK32 if x & 0x80 else x


def _sext16(x: int) -> int:
    return (x | 0xFFFF0000) & MASK32 if x & 0x8000 else x


def _clz(x: int) -> int:
    if x == 0:
        return 32
    return 32 - x.bit_length()


def _div_s(b: int, c: int) -> int:
    """C-style truncated signed division."""
    sb, sc = _s32(b), _s32(c)
    q = abs(sb) // abs(sc)
    return q if (sb < 0) == (sc < 0) else -q


def _rem_s(b: int, c: int) -> int:
    sb, sc = _s32(b), _s32(c)
    r = abs(sb) % abs(sc)
    return r if sb >= 0 else -r
