"""Cycle tracking: guests mark spans by writing cycle-tracker commands to
stdout; the executor aggregates them into the ExecutionReport
(examples/cycle-tracking in the reference, executor/src/syscalls/write.rs)."""

from ..executor import Opcode, Register, asm
from ._common import client_from_args

R, O = Register, Opcode


def _write_str(body, addr, text):
    data = text.encode() + b"\n"
    padded = data + b"\x00" * (-len(data) % 4)
    for i in range(0, len(padded), 4):
        w = int.from_bytes(padded[i : i + 4], "little")
        body += [*asm.li(R.T0, w), *asm.li(R.T1, addr + i), asm.sw(R.T0, R.T1)]
    # write(fd=1, buf, len)
    body += [*asm.li(R.V0, 0x02), *asm.li(R.A0, 1), *asm.li(R.A1, addr),
             *asm.li(R.A2, len(data)), asm.syscall()]


def tracked_guest():
    body = []
    _write_str(body, 0x2000, "cycle-tracker-start: busy-loop")
    body += [*asm.li(R.T2, 50)]
    body += [
        asm.addi(R.T2, R.T2, -1 & 0xFFFFFFFF),
        asm.branch(O.BGTZ, R.T2, 0, -8),
        asm.nop(),
    ]
    _write_str(body, 0x2100, "cycle-tracker-end: busy-loop")
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    program = tracked_guest()
    report = client.execute(program)
    print(f"total cycles: {report.total_instruction_count}")
    for name, cycles in report.cycle_tracker.items():
        print(f"  span {name}: {cycles} cycles")
    assert "busy-loop" in report.cycle_tracker
    print("ok")
    return {"cycles": report.total_instruction_count, "cycle_tracker": dict(report.cycle_tracker)}


if __name__ == "__main__":
    main()
