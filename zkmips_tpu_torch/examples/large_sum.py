"""Sum a large in-memory array and commit the result (the reference's
examples/large-sum): a memory-bandwidth-heavy guest exercising the
MemoryInstrs / MemoryLocal / global memory-consistency chips."""

from ..executor import Opcode, Register, asm
from ._common import ZKMStdin, client_from_args, timed

R, O = Register, Opcode

N = 50_000
BASE = 0x100000


def large_sum_guest():
    # array is preloaded into the memory image (values i+1); the guest sums it
    body = [
        *asm.li(R.T0, BASE), *asm.li(R.T1, N), *asm.li(R.T2, 0),
        asm.lw(R.T3, R.T0),
        asm.alu(O.ADD, R.T2, R.T2, R.T3),
        asm.addi(R.T0, R.T0, 4),
        asm.addi(R.T1, R.T1, -1 & 0xFFFFFFFF),
        asm.branch(O.BGTZ, R.T1, 0, -20),
        asm.nop(),
        # commit the sum
        *asm.li(R.V0, 0x10), *asm.li(R.A0, 0),
        asm.alu(O.ADD, R.A1, R.T2, 0, imm_c=True), asm.syscall(),
    ]
    image = {BASE + 4 * i: (i + 1) & 0xFFFFFFFF for i in range(N)}
    return asm.prog(body + asm.halt_sequence(), image=image)


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    program = large_sum_guest()
    report = client.execute(program, ZKMStdin())
    print(f"executed {report.total_instruction_count} cycles")
    pk, vk = timed("setup", client.setup, program)
    proof = timed("prove", client.prove, pk, program, ZKMStdin())
    got = proof.committed_value_digest[0]
    expected = (N * (N + 1) // 2) & 0xFFFFFFFF
    assert got == expected, (got, expected)
    assert timed("verify", client.verify, vk, proof, program)
    print(f"sum(1..{N}) mod 2^32 = {got:#010x}  ok")
    return {"cycles": report.total_instruction_count, "sum": got}


if __name__ == "__main__":
    main()
