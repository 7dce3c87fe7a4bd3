"""Fibonacci: the canonical guest (examples/fibonacci in the reference).

Reads n from stdin (hint stream), computes fib(n) in a loop, commits the
result; the host proves and verifies the execution.
"""

from ..executor import Opcode, Register, asm
from ._common import ZKMStdin, client_from_args, timed

R, O = Register, Opcode


def fibonacci_guest():
    """Guest: n <- hint; (a, b) loop; commit b (one digest word)."""
    body = [
        # read the 4-byte input into 0x3000 (SYSHINTLEN/SYSHINTREAD)
        *asm.li(R.V0, 0xF0), asm.syscall(),
        *asm.li(R.V0, 0xF1), *asm.li(R.A0, 0x3000), *asm.li(R.A1, 4), asm.syscall(),
        *asm.li(R.T3, 0x3000), asm.lw(R.A0, R.T3),
        # fib loop
        *asm.li(R.T0, 0), *asm.li(R.T1, 1),
        asm.alu(O.ADD, R.T2, R.T0, R.T1),
        asm.alu(O.ADD, R.T0, R.T1, R.ZERO),
        asm.alu(O.ADD, R.T1, R.T2, R.ZERO),
        asm.addi(R.A0, R.A0, -1 & 0xFFFFFFFF),
        asm.branch(O.BNE, R.A0, R.ZERO, -5 * 4),
        asm.nop(),
        # commit fib word
        *asm.li(R.V0, 0x10), *asm.li(R.A0, 0),
        asm.alu(O.ADD, R.A1, R.T0, 0, imm_c=True), asm.syscall(),
    ]
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    n = 1000
    program = fibonacci_guest()
    stdin = ZKMStdin()
    stdin.write_u32(n)

    report = client.execute(program, stdin)
    print(f"executed {report.total_instruction_count} cycles")

    pk, vk = timed("setup", client.setup, program)
    proof = timed("prove", client.prove, pk, program, stdin)
    fib = proof.committed_value_digest[0]
    print(f"fib({n}) mod 2^32 = {fib:#010x}")
    expected = [0, 1]
    for _ in range(n):
        expected.append((expected[-1] + expected[-2]) & 0xFFFFFFFF)
    assert fib == expected[n], "committed value mismatch"
    assert timed("verify", client.verify, vk, proof, program)
    print("ok")
    return {"cycles": report.total_instruction_count, "fib": fib, "proof": proof, "vk": vk}


if __name__ == "__main__":
    main()
