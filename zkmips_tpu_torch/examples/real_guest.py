"""Prove the reference's shipped compiled guest ELF
(crates/prover/elf/mipsel-zkm-zkvm-elf — a Rust guest built with the
reference's own toolchain) end to end: execute, prove every shard, run the
full shard-chain verifier, and print the committed public values.  ``--elf``
names another compiled guest (e.g. one of ``tests/fixtures/guests``)."""

import os

from ..executor import Executor
from ..executor.program import Program
from ._common import client_from_args, parser, timed

# the upstream project's compiled guest, relative to a checkout of it
ELF = "crates/prover/elf/mipsel-zkm-zkvm-elf"


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--elf", default=ELF, help="the compiled guest to prove")
    client, args = client_from_args(__doc__, argv, ap)
    if not os.path.exists(args.elf):
        print("reference ELF not present; nothing to do")
        return {"elf": args.elf, "present": False}
    with open(args.elf, "rb") as fh:
        program = Program.from_elf(fh.read())
    ex = Executor(program)
    records = ex.run()
    print(f"executed {ex.global_clk} cycles, exit {ex.exit_code}")
    print(f"public values stream: {bytes(ex.public_values_stream)!r}")
    m = client.machine
    pk = m.setup(program, device=args.device)
    proofs = timed("prove", m.prove, pk, records, device=args.device)
    assert m.verify(pk.vk, proofs, program)
    print(f"verified {len(proofs)} shard(s); committed digest:",
          [hex(w) for w in ex.committed_value_digest])
    return {"elf": args.elf, "present": True, "cycles": ex.global_clk, "exit_code": ex.exit_code,
            "public_values": bytes(ex.public_values_stream), "shards": len(proofs),
            "committed_value_digest": list(ex.committed_value_digest)}


if __name__ == "__main__":
    main()
