"""Unconstrained (hint-generation) blocks (examples/unconstrained in the
reference): everything between ENTER_UNCONSTRAINED and EXIT_UNCONSTRAINED
is rolled back and invisible to the proof — the whole block collapses to a
single merged row returning 0, exactly like the reference executor."""

from ..executor import Executor, Register, asm
from ..executor.opcodes import Opcode
from ._common import client_from_args, timed

R, O = Register, Opcode


def unconstrained_guest():
    body = [
        *asm.li(R.S0, 41),
        # enter unconstrained; the branch skips the block in the constrained
        # replay (the merged row returns 0)
        *asm.li(R.V0, 0x03), asm.syscall(),
        asm.branch(O.BEQ, R.V0, R.ZERO, 6 * 4),
        asm.nop(),
        *asm.li(R.S0, 999999),  # scratch work, rolled back
        *asm.li(R.V0, 0x04), asm.syscall(),  # exit unconstrained
        asm.addi(R.S0, R.S0, 1),
    ]
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, args = client_from_args(__doc__, argv)
    program = unconstrained_guest()
    ex = Executor(program)
    records = ex.run()
    assert ex.register(R.S0) == 42, ex.register(R.S0)
    print(f"s0 = {ex.register(R.S0)} (unconstrained writes rolled back)")
    m = client.machine
    pk = m.setup(program, device=args.device)
    proofs = timed("prove", m.prove, pk, records, device=args.device)
    assert m.verify(pk.vk, proofs, program)
    print("proof excludes the unconstrained block")
    return {"s0": ex.register(R.S0), "shards": len(proofs)}


if __name__ == "__main__":
    main()
