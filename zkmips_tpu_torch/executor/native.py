"""Types shared by the ctypes bridges to the native C executors.

Only what the trace-mode bridge (``native_trace``) needs is kept here: the
instruction struct of the C interface and the exceptions.  The simple-mode
bridge to ``csrc/executor.c`` is not part of the port yet.
"""

from __future__ import annotations

import ctypes


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
