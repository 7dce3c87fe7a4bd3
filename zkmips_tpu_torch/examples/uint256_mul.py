"""256-bit modular multiplication via the UINT256_MUL precompile (the
reference's uint256 syscall, crates/core/executor/src/syscalls/precompiles/
uint256.rs): one syscall replaces hundreds of 32-bit mul/adc instructions."""

from ..executor import Opcode, Register, asm
from ._common import ZKMStdin, client_from_args, timed

R, O = Register, Opcode

UINT256_MUL = 0x01_01_00_1D

X = 0xDEADBEEF_12345678_9ABCDEF0_0FEDCBA9_87654321_FFFFFFFF_00000001_13371337
Y = 0x0BADF00D_CAFEBABE_00C0FFEE_12312312_45645645_78978978_ABCABCAB_CDECDECD
M = (1 << 255) - 19  # 2^255 - 19


def _store_words(value, addr):
    out = []
    for i in range(8):
        w = (value >> (32 * i)) & 0xFFFFFFFF
        out += [*asm.li(R.T0, w), *asm.li(R.T1, addr + 4 * i), asm.sw(R.T0, R.T1)]
    return out


def uint256_guest():
    body = []
    body += _store_words(X, 0x2000)          # x at 0x2000 (read/write)
    body += _store_words(Y, 0x3000)          # y at 0x3000
    body += _store_words(M, 0x3020)          # modulus at y+32
    body += [*asm.li(R.V0, UINT256_MUL), *asm.li(R.A0, 0x2000), *asm.li(R.A1, 0x3000),
             asm.syscall()]
    # commit the low result word
    body += [*asm.li(R.T2, 0x2000), asm.lw(R.T3, R.T2),
             *asm.li(R.V0, 0x10), *asm.li(R.A0, 0),
             asm.alu(O.ADD, R.A1, R.T3, 0, imm_c=True), asm.syscall()]
    return asm.prog(body + asm.halt_sequence())


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    program = uint256_guest()
    report = client.execute(program, ZKMStdin())
    print(f"executed {report.total_instruction_count} cycles, "
          f"syscalls: {dict(report.syscall_counts)}")
    pk, vk = timed("setup", client.setup, program)
    proof = timed("prove", client.prove, pk, program, ZKMStdin())
    got = proof.committed_value_digest[0]
    expected = (X * Y % M) & 0xFFFFFFFF
    assert got == expected, (hex(got), hex(expected))
    assert timed("verify", client.verify, vk, proof, program)
    print(f"(x*y mod 2^255-19) low word = {got:#010x}  ok")
    return {"cycles": report.total_instruction_count, "low_word": got}


if __name__ == "__main__":
    main()
