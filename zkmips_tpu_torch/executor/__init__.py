"""MIPS32r2 executor: ELF loading, emulation, event recording, sharding.

Two executors emit the same records: the native trace-mode executor
(``csrc/trace_executor.c`` through ``native_trace``), which runs the guests
it can, and the Python interpreter (``executor.Executor``) with its syscalls
and hooks, which runs the rest.
"""

from .events import ExecutionRecord, MemoryAccessRecord, MemoryRecord
from .executor import Executor, ExecutorMode
from .instruction import Instruction, decode_instruction
from .native import ExecutionError, NativeUnsupported
from .opcodes import Opcode, Register, SyscallCode
from .program import Program

__all__ = [
    "ExecutionError",
    "ExecutionRecord",
    "Executor",
    "ExecutorMode",
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
    "stream_for_proving",
]


def execute_for_proving(program, stdin_bufs=(), proof_stream=(), shard_size: int = 1 << 20,
                        max_cycles: int | None = None):
    """Execute a program for the proving pipeline: (records, info).

    The native trace-mode executor emits array-backed records.  Guests it
    cannot run (precompile syscalls, hooks, unconstrained mode, deferred
    proofs) raise ``NativeUnsupported`` there and go to the Python
    interpreter; any other failure of the native path (a missing C
    toolchain included) raises.  ``info`` carries global_clk, exit_code,
    public_values, stdout, the committed digest, and ``executor``: which of
    the two ran (``"native"`` or ``"interpreter"``).
    """
    if not proof_stream:
        from . import native_trace

        try:
            records, info = native_trace.run_trace(
                program, stdin=stdin_bufs, shard_size=shard_size,
                max_cycles=max_cycles if max_cycles is not None else 1 << 40,
            )
        except NativeUnsupported:
            pass
        else:
            if info["hit_max_cycles"]:
                raise ExecutionError(f"exceeded max_cycles {max_cycles}")
            info["digest"] = list(info["digest"])
            info["executor"] = "native"
            return records, info

    ex = Executor(program, shard_size=shard_size)
    for buf in stdin_bufs:
        ex.write_stdin(buf)
    ex.proof_stream.extend(proof_stream)
    records = ex.run(max_cycles)
    info = {
        "global_clk": ex.global_clk,
        "exit_code": ex.exit_code,
        "public_values": bytes(ex.public_values_stream),
        "stdout": bytes(ex.stdout),
        "digest": list(ex.committed_value_digest),
        "hit_max_cycles": False,
        "executor": "interpreter",
    }
    return records, info


def stream_for_proving(program, stdin_bufs=(), shard_size: int = 1 << 20,
                       max_cycles: int | None = None):
    """Streaming twin of :func:`execute_for_proving`: an iterator of records
    for ``MipsMachine.prove_streaming``, each yielded the moment its shard
    boundary is crossed.

    The native trace-mode executor runs first.  If it raises
    ``NativeUnsupported``, the guest is executed again from the start by
    the Python interpreter, which skips the records already yielded (the
    two executors emit equal records up to the unsupported syscall).  Any
    other failure of the native path (a failed ``cc`` build included)
    raises.
    """
    from . import native_trace

    def python_stream(skip: int = 0):
        ex = Executor(program, shard_size=shard_size)
        for buf in stdin_bufs:
            ex.write_stdin(buf)
        for i, r in enumerate(ex.run_stream(max_cycles)):
            if i >= skip:
                yield r

    def hybrid():
        yielded = 0
        try:
            stream = native_trace.run_trace_stream(
                program, stdin=stdin_bufs, shard_size=shard_size,
                max_cycles=max_cycles if max_cycles is not None else 1 << 40,
            )
            for r in stream:
                yielded += 1
                yield r
            if stream.info["hit_max_cycles"]:
                raise ExecutionError(f"exceeded max_cycles {max_cycles}")
        except NativeUnsupported:
            yield from python_stream(skip=yielded)

    return hybrid()
