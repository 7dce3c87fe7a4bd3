"""Poseidon2 width-16 permutation via the precompile chip (the reference's
poseidon2 example; one syscall permutes 16 KoalaBear field elements)."""

from ..executor import Opcode, Register, asm
from ..ops import field as ff, poseidon2 as p2
from ._common import client_from_args, timed

R, O = Register, Opcode
POSEIDON2_PERMUTE = 0x00010030
VALS = [i * 7 + 1 for i in range(16)]


def poseidon2_guest(vals):
    body = []
    for i, v in enumerate(vals):
        body += [*asm.li(R.T0, v), *asm.li(R.T1, 0x2000 + 4 * i), asm.sw(R.T0, R.T1)]
    body += [*asm.li(R.V0, POSEIDON2_PERMUTE), *asm.li(R.A0, 0x2000), *asm.li(R.A1, 0), asm.syscall()]
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    vals = VALS
    program = poseidon2_guest(vals)

    pk, vk = timed("setup", client.setup, program)
    proof = timed("prove", client.prove, pk, program)
    assert timed("verify", client.verify, vk, proof, program)

    # cross-check against the host Poseidon2
    ex = client._executor(program, None)
    ex.run()
    got = [ex.word(0x2000 + 4 * i) for i in range(16)]
    want = [ff.from_monty_int(x) for x in p2.permute_ints([ff.to_monty_int(v) for v in vals])]
    assert got == want
    print("poseidon2 state[:4]:", [hex(x) for x in got[:4]])
    print("ok")
    return {"state": got}


if __name__ == "__main__":
    main()
