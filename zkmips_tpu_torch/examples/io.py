"""Host <-> guest IO: hint-stream reads + committed public values
(examples/json / io in the reference: zkm_zkvm::io::{read, commit})."""

from ..executor import Opcode, Register, asm
from ._common import ZKMStdin, client_from_args, timed

R, O = Register, Opcode


def adder_guest():
    """Reads two u32 hints, commits their sum and difference."""
    body = []
    for slot, addr in enumerate((0x3000, 0x3100)):
        body += [
            *asm.li(R.V0, 0xF0), asm.syscall(),  # SYSHINTLEN
            *asm.li(R.V0, 0xF1), *asm.li(R.A0, addr), *asm.li(R.A1, 4), asm.syscall(),
        ]
    body += [
        *asm.li(R.T0, 0x3000), asm.lw(R.T1, R.T0),
        *asm.li(R.T0, 0x3100), asm.lw(R.T2, R.T0),
        asm.alu(O.ADD, R.T3, R.T1, R.T2),
        asm.alu(O.SUB, R.T4, R.T1, R.T2),
        *asm.li(R.V0, 0x10), *asm.li(R.A0, 0),
        asm.alu(O.ADD, R.A1, R.T3, 0, imm_c=True), asm.syscall(),
        *asm.li(R.V0, 0x10), *asm.li(R.A0, 1),
        asm.alu(O.ADD, R.A1, R.T4, 0, imm_c=True), asm.syscall(),
    ]
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    program = adder_guest()
    stdin = ZKMStdin()
    stdin.write_u32(1000)
    stdin.write_u32(58)

    pk, vk = timed("setup", client.setup, program)
    proof = timed("prove", client.prove, pk, program, stdin)
    assert proof.committed_value_digest[0] == 1058
    assert proof.committed_value_digest[1] == 942
    assert timed("verify", client.verify, vk, proof, program)
    print(f"committed: sum={proof.committed_value_digest[0]} diff={proof.committed_value_digest[1]}")
    print("ok")
    return {"sum": proof.committed_value_digest[0], "diff": proof.committed_value_digest[1],
            "proof": proof, "vk": vk}


if __name__ == "__main__":
    main()
