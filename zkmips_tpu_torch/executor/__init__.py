"""MIPS32r2 execution for the proving pipeline: programs, events, records.

The port runs guests on the native trace-mode executor
(``csrc/trace_executor.c`` through ``native_trace``).  The reference
package's Python interpreter, its syscalls and hooks, and ELF loading of
compiled guests are not ported yet: a guest the native machine cannot run
raises ``NativeUnsupported``.
"""

from .events import ExecutionRecord, MemoryAccessRecord, MemoryRecord
from .instruction import Instruction, decode_instruction
from .native import ExecutionError, NativeUnsupported
from .opcodes import Opcode, Register, SyscallCode
from .program import Program

__all__ = [
    "ExecutionError",
    "ExecutionRecord",
    "Instruction",
    "MemoryAccessRecord",
    "MemoryRecord",
    "NativeUnsupported",
    "Opcode",
    "Program",
    "Register",
    "SyscallCode",
    "decode_instruction",
    "execute_for_proving",
]


def execute_for_proving(program, stdin_bufs=(), proof_stream=(), shard_size: int = 1 << 20,
                        max_cycles: int | None = None):
    """Execute a program for the proving pipeline: (records, info).

    Runs the native trace-mode executor, which emits array-backed records.
    Guests it cannot run (precompile syscalls, hooks, unconstrained mode,
    deferred proofs) raise ``NativeUnsupported``: there is no other path.
    ``info`` carries global_clk, exit_code, public_values, stdout, and the
    committed digest.
    """
    from . import native_trace

    if proof_stream:
        raise NativeUnsupported(
            "deferred proofs need the Python interpreter, which is not ported yet"
        )
    records, info = native_trace.run_trace(
        program, stdin=stdin_bufs, shard_size=shard_size,
        max_cycles=max_cycles if max_cycles is not None else 1 << 40,
    )
    if info["hit_max_cycles"]:
        raise ExecutionError(f"exceeded max_cycles {max_cycles}")
    info["digest"] = list(info["digest"])
    return records, info
