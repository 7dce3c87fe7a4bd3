"""Trial-division primality test (the reference's examples/is-prime).

Reads n from stdin, checks divisibility by every d in [2, n), commits 1/0.
"""

from ..executor import Opcode, Register, asm
from ._common import ZKMStdin, client_from_args, timed

R, O = Register, Opcode

CASES = ((10007, 1), (10001, 0))


def is_prime_guest():
    body = [
        # n <- hint stream
        *asm.li(R.V0, 0xF0), asm.syscall(),
        *asm.li(R.V0, 0xF1), *asm.li(R.A0, 0x3000), *asm.li(R.A1, 4), asm.syscall(),
        *asm.li(R.T3, 0x3000), asm.lw(R.A0, R.T3),
        # result <- 1; d <- 2
        *asm.li(R.T0, 1), *asm.li(R.T1, 2),
        # loop: if d >= n stop
        asm.alu(O.SLTU, R.T2, R.T1, R.A0),          # t2 = d < n
        asm.branch(O.BEQ, R.T2, R.ZERO, 6 * 4),     # exit loop
        asm.nop(),
        asm.alu(O.MODU, R.T4, R.A0, R.T1),          # t4 = n % d
        asm.addi(R.T1, R.T1, 1),
        asm.branch(O.BNE, R.T4, R.ZERO, -6 * 4),    # not divisible: next d
        asm.nop(),
        *asm.li(R.T0, 0),                           # divisible -> composite
        # commit result word
        *asm.li(R.V0, 0x10), *asm.li(R.A0, 0),
        asm.alu(O.ADD, R.A1, R.T0, 0, imm_c=True), asm.syscall(),
    ]
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    program = is_prime_guest()
    out = {}
    for n, expected in CASES:
        stdin = ZKMStdin()
        stdin.write_u32(n)
        report = client.execute(program, stdin)
        print(f"is_prime({n}): executed {report.total_instruction_count} cycles")
        pk, vk = timed("setup", client.setup, program)
        proof = timed("prove", client.prove, pk, program, stdin)
        got = proof.committed_value_digest[0]
        assert got == expected, (n, got, expected)
        assert timed("verify", client.verify, vk, proof, program)
        print(f"is_prime({n}) = {got}  ok")
        out[n] = {"cycles": report.total_instruction_count, "is_prime": got}
    return out


if __name__ == "__main__":
    main()
