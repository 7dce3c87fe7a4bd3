"""ctypes bridge to the native simple-mode executor (``csrc/executor.c``),
and the types it shares with the trace-mode bridge (``native_trace``).

``run_native`` executes a guest to its end and returns the final state, not
records: the SDK's ``execute`` and shard planning use it.  The C source is
compiled where it lies into ``build/native/`` at first use; a failed build
raises.  Guests the native machine does not run raise ``NativeUnsupported``;
the Python interpreter (``executor.Executor``) is the semantic reference.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.cbuild import REPO_ROOT, build

_LIB = None
_SRC = os.path.join(str(REPO_ROOT), "csrc", "executor.c")


class NativeUnsupported(Exception):
    """The guest needs something the native machine does not do."""


class ExecutionError(Exception):
    """The guest faulted or ran past its cycle limit."""


class _Insn(ctypes.Structure):
    _fields_ = [
        ("opcode", ctypes.c_uint8), ("op_a", ctypes.c_uint8),
        ("imm_b", ctypes.c_uint8), ("imm_c", ctypes.c_uint8),
        ("op_b", ctypes.c_uint32), ("op_c", ctypes.c_uint32),
    ]


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(build(_SRC))
        _LIB.zkm_run.restype = ctypes.c_int
    return _LIB


def run_native(program, stdin=(), max_cycles=1 << 40):
    """Execute a Program natively: a dict of the final state (registers,
    committed digest, cycles, exit code, public values, stdout), or
    ``NativeUnsupported`` when the guest needs the Python interpreter."""
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
    out_regs = np.zeros(36, dtype=np.uint32)
    out_digest = np.zeros(8, dtype=np.uint32)
    out_counts = np.zeros(5, dtype=np.uint64)
    out_pv = ctypes.POINTER(ctypes.c_uint8)()
    out_stdout = ctypes.POINTER(ctypes.c_uint8)()
    status = lib.zkm_run(
        insns, len(program.instructions), program.pc_base, program.pc_start,
        addrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(image),
        ctypes.cast(hints, ctypes.POINTER(ctypes.c_char_p)), hint_lens, len(bufs),
        ctypes.c_uint64(max_cycles),
        out_regs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_digest.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.byref(out_pv),
        ctypes.byref(out_stdout),
    )
    pv_len = int(out_counts[3])
    pv = ctypes.string_at(out_pv, pv_len) if pv_len else b""
    lib.zkm_free(out_pv)
    so_len = int(out_counts[4])
    stdout = ctypes.string_at(out_stdout, so_len) if so_len else b""
    lib.zkm_free(out_stdout)
    if status == 2:
        raise NativeUnsupported("unsupported syscall in native executor")
    if status == 5:
        raise NativeUnsupported("unimplemented instruction in native executor")
    if status not in (0, 1):
        raise RuntimeError(f"native executor error status {status}")
    return {
        "regs": out_regs,
        "digest": [int(x) for x in out_digest],
        "global_clk": int(out_counts[0]),
        "exit_code": int(out_counts[2]),
        "public_values": pv,
        "stdout": stdout,
        "hit_max_cycles": status == 1,
    }
