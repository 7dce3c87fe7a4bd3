"""SHA-256 via the ShaExtend/ShaCompress precompile chips
(examples mirroring the reference's patched sha2 guest: one EXTEND + one
COMPRESS syscall per 64-byte block)."""

import hashlib
import struct

from ..executor import Opcode, Register, asm
from ._common import client_from_args, timed

R, O = Register, Opcode

SHA_EXTEND = 0x30010005
SHA_COMPRESS = 0x01010006
H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
MSG = b"zkMIPS on TPU"


def sha256_guest(msg: bytes):
    assert len(msg) <= 55, "single-block example"
    padded = msg + b"\x80" + b"\x00" * (55 - len(msg)) + struct.pack(">Q", len(msg) * 8)
    w = [int.from_bytes(padded[i : i + 4], "big") for i in range(0, 64, 4)]
    body = []
    for i, word in enumerate(w):
        body += [*asm.li(R.T0, word), *asm.li(R.T1, 0x2000 + 4 * i), asm.sw(R.T0, R.T1)]
    for i, h in enumerate(H0):
        body += [*asm.li(R.T0, h), *asm.li(R.T1, 0x3000 + 4 * i), asm.sw(R.T0, R.T1)]
    body += [*asm.li(R.V0, SHA_EXTEND), *asm.li(R.A0, 0x2000), *asm.li(R.A1, 0), asm.syscall()]
    body += [*asm.li(R.V0, SHA_COMPRESS), *asm.li(R.A0, 0x2000), *asm.li(R.A1, 0x3000), asm.syscall()]
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    msg = MSG
    program = sha256_guest(msg)

    report = client.execute(program)
    print(f"executed {report.total_instruction_count} cycles "
          f"({report.syscall_counts.get('SHA_EXTEND', 0)} extend, "
          f"{report.syscall_counts.get('SHA_COMPRESS', 0)} compress syscalls)")

    pk, vk = timed("setup", client.setup, program)
    proof = timed("prove", client.prove, pk, program)
    assert timed("verify", client.verify, vk, proof, program)

    ex = client._executor(program, None)
    ex.run()
    digest = b"".join(struct.pack(">I", ex.word(0x3000 + 4 * i)) for i in range(8))
    assert digest == hashlib.sha256(msg).digest()
    print(f"sha256({msg!r}) = {digest.hex()}")
    print("ok")
    return {"cycles": report.total_instruction_count, "sha256": digest.hex()}


if __name__ == "__main__":
    main()
