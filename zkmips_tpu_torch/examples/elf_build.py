"""Guest build tooling: assemble a guest, emit a real mipsel ELF, load it
back through the ELF loader, prove and verify (the cargo-ziren build +
fixture flow, with our asm DSL in place of rustc)."""

import os
import tempfile

from ..executor import Executor, Instruction, Opcode, Register, asm
from ..executor.program import Program
from ..guest import write_elf
from ._common import client_from_args, timed

R, O = Register, Opcode


def elf_build_guest():
    body = [
        *asm.li(R.T0, 0), *asm.li(R.T1, 1), *asm.li(R.T2, 64),
        asm.alu(O.ADD, R.T3, R.T0, R.T1),
        Instruction(O.ADD, R.T0, R.T1, 0, False, True),
        Instruction(O.ADD, R.T1, R.T3, 0, False, True),
        asm.addi(R.T2, R.T2, -1 & 0xFFFFFFFF),
        asm.branch(O.BGTZ, R.T2, 0, -20),
        asm.nop(),
    ]
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, args = client_from_args(__doc__, argv)
    program = elf_build_guest()
    elf = write_elf(program)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "guest.elf")
        with open(path, "wb") as fh:
            fh.write(elf)
        print(f"wrote {len(elf)} byte ELF to {path}")
        with open(path, "rb") as fh:
            loaded = Program.from_elf(fh.read())
    ex = Executor(loaded)
    records = ex.run()
    print(f"executed {ex.global_clk} cycles from the ELF")
    m = client.machine
    pk = m.setup(loaded, device=args.device)
    proofs = timed("prove", m.prove, pk, records, device=args.device)
    assert m.verify(pk.vk, proofs, loaded)
    print("ELF-built guest proven + verified")
    return {"elf_bytes": len(elf), "cycles": ex.global_clk, "shards": len(proofs)}


if __name__ == "__main__":
    main()
