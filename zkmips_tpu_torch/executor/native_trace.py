"""ctypes bridge to the native trace-mode executor (csrc/trace_executor.c).

The native machine interprets MIPS32r2 emitting per-cycle event columns in
the exact ``columnar.CPU_DTYPE`` layout, plus per-shard local memory chains
and the whole-run init/finalize sets — replacing both the Python
interpreter's event loop and the per-event attribute extraction during
trace generation.  The reference package's Python interpreter is the semantic
reference; tests/test_torch_executor.py compares the two column-for-column.

Unsupported guests (precompile syscalls, hooks, unconstrained mode,
cycle-tracker prints) raise NativeUnsupported; ``execute_for_proving`` then
runs the Python ``Executor``.

The C source is the repository's ``csrc/trace_executor.c``, compiled where it
lies into ``build/native/`` at first use.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.cbuild import REPO_ROOT, build
from .columnar import CPU_DTYPE, ArrayCpuEvents, Columns
from .events import ExecutionRecord, MemoryInitFinalEvent, MemoryLocalEvent, MemoryRecord
from .native import ExecutionError, NativeUnsupported, _Insn

_LIB = None
_SRC = os.path.join(str(REPO_ROOT), "csrc", "trace_executor.c")

_NCOLS = len(CPU_DTYPE.names)

TR_OK, TR_DONE, TR_MAX_CYCLES, TR_UNSUPPORTED, TR_ERROR = 0, 1, 2, 3, 4


def available() -> bool:
    try:
        return _lib() is not None
    except Exception:
        return False


def library() -> str:
    """Path of the shared library, compiled from the C source at first use."""
    return build(_SRC)


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(library())
        _LIB.zkm_trace_new.restype = ctypes.c_void_p
        _LIB.zkm_trace_new.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
        ]
        _LIB.zkm_trace_shard.restype = ctypes.c_int
        _LIB.zkm_trace_touched_len.restype = ctypes.c_uint64
    return _LIB


def _u32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def run_trace(program, stdin=(), shard_size: int = 1 << 20, max_cycles: int = 1 << 40):
    """Execute in trace mode natively: (records, info).  See run_trace_stream."""
    stream = run_trace_stream(program, stdin=stdin, shard_size=shard_size, max_cycles=max_cycles)
    records = list(stream)
    return records, stream.info


class run_trace_stream:
    """Iterator yielding each shard's record as the native machine crosses
    its boundary (the streaming prove pipeline's producer); ``.info`` is
    available once exhausted.  Records are fully formed at yield time —
    global memory init/finalize anchors on the final record."""

    def __init__(self, program, stdin=(), shard_size: int = 1 << 20, max_cycles: int = 1 << 40):
        self.program = program
        self.stdin = stdin
        self.shard_size = shard_size
        self.max_cycles = max_cycles
        self.info = None
        self._gen = self._run()

    def __iter__(self):
        return self._gen

    def _run(self):
        program, stdin = self.program, self.stdin
        shard_size, max_cycles = self.shard_size, self.max_cycles
        lib = _lib()
        insns = (_Insn * len(program.instructions))()
        for i, ins in enumerate(program.instructions):
            insns[i] = _Insn(int(ins.opcode), ins.op_a, int(ins.imm_b), int(ins.imm_c), ins.op_b, ins.op_c)
        image = program.image
        addrs = np.fromiter(image.keys(), dtype=np.uint32, count=len(image))
        vals = np.fromiter(image.values(), dtype=np.uint32, count=len(image))
        bufs = [bytes(b) for b in stdin]
        HintArr = ctypes.c_char_p * max(len(bufs), 1)
        hints = HintArr(*[ctypes.c_char_p(b) for b in bufs]) if bufs else HintArr()
        hint_lens = (ctypes.c_uint64 * max(len(bufs), 1))(*[len(b) for b in bufs])

        tm = lib.zkm_trace_new(
            insns, len(program.instructions), program.pc_base, program.pc_start,
            _u32p(addrs), _u32p(vals), len(image),
            ctypes.cast(hints, ctypes.POINTER(ctypes.c_char_p)), hint_lens, len(bufs),
        )
        try:
            cap = shard_size + 8
            cap_local = 5 * cap + 64
            # one reusable buffer set per run: every row is (re)written by the
            # C side, and each shard's data is copied out before the next call
            cols = np.empty((cap, _NCOLS), dtype=np.uint32)
            local7 = np.empty((cap_local, 7), dtype=np.uint32)
            meta = np.zeros(8, dtype=np.uint64)
            digest = np.zeros(16, dtype=np.uint32)  # committed (8) + deferred (8)
            pending = None  # hold one record back: the last needs finalize
            while True:
                st = lib.zkm_trace_shard(
                    ctypes.c_void_p(tm), ctypes.c_uint64(shard_size), ctypes.c_uint64(max_cycles),
                    _u32p(cols), ctypes.c_uint64(cap), _u32p(local7), ctypes.c_uint64(cap_local),
                    meta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), _u32p(digest),
                )
                if st == TR_UNSUPPORTED:
                    raise NativeUnsupported("guest needs the Python trace executor")
                if st == TR_ERROR:
                    raise ExecutionError("native trace executor: guest fault")
                rows = int(meta[0])
                # Python's final _bump_record(final=True) appends the current
                # record even when empty (halt coinciding with a boundary)
                if rows or st == TR_DONE:
                    shard = int(meta[2])
                    trimmed = np.ascontiguousarray(cols[:rows])
                    struct = trimmed.view(CPU_DTYPE).reshape(rows)
                    columns = Columns(
                        {name: np.ascontiguousarray(struct[name]) for name in CPU_DTYPE.names}
                    )
                    rec = ExecutionRecord(shard=shard, program=program)
                    rec._cpu_struct = columns
                    rec.cpu_events = ArrayCpuEvents(columns, program, shard)
                    n_local = int(meta[1])
                    for j in range(n_local):
                        a7 = local7[j]
                        addr = int(a7[0])
                        rec.local_memory_access[addr] = MemoryLocalEvent(
                            addr,
                            MemoryRecord(int(a7[1]), int(a7[2]), int(a7[3])),
                            MemoryRecord(int(a7[4]), int(a7[5]), int(a7[6])),
                        )
                    rec.public_values.shard = shard
                    rec.public_values.execution_shard = shard
                    rec.public_values.exit_code = int(meta[3])
                    rec.public_values.committed_value_digest = [int(x) for x in digest[:8]]
                    rec.public_values.deferred_proofs_digest = [int(x) for x in digest[8:]]
                    if pending is not None:
                        yield pending
                    pending = rec
                if st != TR_OK:
                    final_status = st
                    break

            # whole-run touched set -> init/finalize events; both anchor on
            # the LAST record (as the reference interpreter's post-processing does: streamability)
            n_touched = int(lib.zkm_trace_touched_len(ctypes.c_void_p(tm)))
            fin = np.zeros((max(n_touched, 1), 6), dtype=np.uint32)
            lib.zkm_trace_finalize(ctypes.c_void_p(tm), _u32p(fin))
            last = pending
            assert last is not None, "native run produced no records"
            max_addr = 0
            saw_zero = False
            for j in range(n_touched):
                addr, init_val, f_val, f_shard, f_ts = (int(x) for x in fin[j, :5])
                last.global_memory_initialize_events.append(
                    MemoryInitFinalEvent(addr, init_val, 0, 0, 1)
                )
                last.global_memory_finalize_events.append(
                    MemoryInitFinalEvent(addr, f_val, f_shard, f_ts, 1)
                )
                max_addr = max(max_addr, addr)
                saw_zero = saw_zero or addr == 0
            if not saw_zero:
                # the chain must open at address 0 (register ZERO) — see
                # the memory_bridge chain-opener rule
                last.global_memory_initialize_events.append(
                    MemoryInitFinalEvent(0, 0, 0, 0, 1)
                )
                last.global_memory_finalize_events.append(
                    MemoryInitFinalEvent(0, 0, 0, 0, 1)
                )
            if len(last.global_memory_initialize_events) < 2:
                # the address-0 chain opener AIR needs >= 2 real rows; pad
                # with a balanced pair at an untouched address
                touched = {int(fin[j, 0]) for j in range(n_touched)}
                pad_addr = 4
                while pad_addr in touched:
                    pad_addr += 4
                last.global_memory_initialize_events.append(
                    MemoryInitFinalEvent(pad_addr, 0, 0, 0, 1)
                )
                last.global_memory_finalize_events.append(
                    MemoryInitFinalEvent(pad_addr, 0, 0, 0, 1)
                )
                max_addr = max(max_addr, pad_addr)
            lpv = last.public_values
            lpv.prev_init_addr = 0
            lpv.last_init_addr = max_addr
            lpv.prev_finalize_addr = 0
            lpv.last_finalize_addr = max_addr

            pv_len, so_len = int(meta[4]), int(meta[5])
            pv = np.zeros(max(pv_len, 1), dtype=np.uint8)
            so = np.zeros(max(so_len, 1), dtype=np.uint8)
            lib.zkm_trace_io(
                ctypes.c_void_p(tm),
                pv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                so.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                _u32p(digest),
            )
            self.info = {
                "global_clk": int(meta[6]) | (int(meta[7]) << 32),
                "exit_code": int(meta[3]),
                "public_values": bytes(pv[:pv_len].tobytes()),
                "stdout": bytes(so[:so_len].tobytes()),
                "digest": [int(x) for x in digest[:8]],
                "deferred_digest": [int(x) for x in digest[8:]],
                "hit_max_cycles": final_status == TR_MAX_CYCLES,
            }
            yield last
        finally:
            lib.zkm_trace_free(ctypes.c_void_p(tm))
