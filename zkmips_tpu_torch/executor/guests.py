"""Guest programs built with the port's mini-assembler.

* ``keccak_chain_program``: the keccak-chain benchmark guest of ``bench.py``
  (digest = keccak256(digest), one KECCAK_SPONGE syscall and 24
  KeccakSponge rows an iteration);
* ``all_ops_body``: every MIPS opcode the chips receive (the reference's
  ``tests/test_mips_e2e.py`` all-opcodes body);
* ``every_chip_program``: a guest that makes each of the 49 chips of the full
  machine non-empty: the all-opcodes body, the sha, keccak and Poseidon2
  syscalls, every EC / fp-tower / uint256 syscall and emulated Linux
  syscalls;
* ``keccak_message_program``, ``sha256_message_program``,
  ``poseidon2_program``: the reference's precompile examples
  (``examples/{keccak,sha256,poseidon2}_precompile.py``), one syscall each
  over a given input; the shape corpus (``machine/shape_gen.py``) runs them.

The bodies are lists of instructions; the ``*_program`` helpers append the
halt sequence.
"""

from __future__ import annotations

from . import asm, curves as cv
from .instruction import Instruction
from .opcodes import Opcode as O, Register as R, SyscallCode as C

K1_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
K1_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
R1_GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
R1_GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5
BLS_GX = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
BLS_GY = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
ED_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
ED_BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960

SHA256_H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
             0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def program(body: list):
    return asm.prog(list(body) + asm.halt_sequence())


def store(ptr: int, words) -> list:
    body = []
    for i, w in enumerate(words):
        body += [*asm.li(R.T0, int(w)), *asm.li(R.T1, ptr + 4 * i), asm.sw(R.T0, R.T1)]
    return body


def call(code, a0: int, a1: int) -> list:
    return [*asm.li(R.V0, int(code)), *asm.li(R.A0, a0), *asm.li(R.A1, a1), asm.syscall()]


# one 136-byte rate block + 2 state words = 36 words: a message of 32 zero
# bytes with its padding (byte 32 = 0x01, byte 135 = 0x80)
KECCAK_BLOCK = [0x01 if i == 8 else (0x80000000 if i == 33 else 0) for i in range(36)]


def keccak_body(in_ptr: int = 0x2000, out_ptr: int = 0x3000) -> list:
    """One keccak256 of 32 zero bytes through KECCAK_SPONGE."""
    return store(in_ptr, KECCAK_BLOCK) + store(out_ptr + 64, [36]) + \
        call(C.KECCAK_SPONGE, in_ptr, out_ptr)


def keccak_chain_program(n_iters: int):
    """Chain keccak256 over a 32-byte message, ``n_iters`` times (bench.py's
    keccak-chain guest, the reference's keccak-precompile example shape):
    the digest is copied back over the message after every sponge call."""
    IN, OUT = 0x2000, 0x3000
    body = store(IN, KECCAK_BLOCK) + store(OUT + 64, [36]) + [*asm.li(R.S0, n_iters)]
    loop = call(C.KECCAK_SPONGE, IN, OUT)
    for i in range(8):
        loop += [*asm.li(R.T1, OUT + 4 * i), asm.lw(R.T0, R.T1),
                 *asm.li(R.T2, IN + 4 * i), asm.sw(R.T0, R.T2)]
    loop += [asm.addi(R.S0, R.S0, -1 & 0xFFFFFFFF)]
    nloop = len(loop)
    loop += [asm.branch(O.BGTZ, R.S0, 0, -4 * (nloop + 1)), asm.nop()]
    return program(body + loop)


def all_ops_body() -> list:
    """Every opcode with a chip: ALU, shifts, multiplies and divides, clz/clo,
    loads and stores of every width, the misc and conditional-move ops,
    branches and a jump."""
    I = Instruction
    return [
        *asm.li(R.T0, 0x12345678), *asm.li(R.T1, 0xFFFF0000), *asm.li(R.S0, 0x2000),
        asm.alu(O.ADD, R.T2, R.T0, R.T1), asm.alu(O.SUB, R.T3, R.T0, R.T1),
        asm.alu(O.AND, R.T4, R.T0, R.T1), asm.alu(O.OR, R.T5, R.T0, R.T1),
        asm.alu(O.XOR, R.T6, R.T0, R.T1), asm.alu(O.NOR, R.T7, R.T0, R.T1),
        asm.alu(O.SLT, R.T2, R.T0, R.T1), asm.alu(O.SLTU, R.T2, R.T1, R.T0),
        asm.alu(O.SLL, R.T3, R.T0, 7, imm_c=True), asm.alu(O.SRL, R.T3, R.T0, 9, imm_c=True),
        asm.alu(O.SRA, R.T3, R.T1, 5, imm_c=True), asm.alu(O.ROR, R.T3, R.T0, 13, imm_c=True),
        asm.alu(O.MUL, R.T5, R.T0, R.T1),
        asm.alu(O.MULT, 32, R.T0, R.T1), asm.alu(O.MULTU, 32, R.T0, R.T1),
        *asm.li(R.T4, 0xFFFFFFF9), *asm.li(R.T5, 7),
        asm.alu(O.DIV, 32, R.T4, R.T5), asm.alu(O.DIVU, 32, R.T0, R.T5),
        asm.alu(O.MOD, R.T6, R.T4, R.T5), asm.alu(O.MODU, R.T6, R.T0, R.T5),
        asm.alu(O.CLZ, R.T7, R.T0, 0, imm_c=True), asm.alu(O.CLO, R.T7, R.T1, 0, imm_c=True),
        asm.sw(R.T0, R.S0, 0), asm.lw(R.T2, R.S0, 0),
        asm.mem_op(O.LB, R.T3, R.S0, 1), asm.mem_op(O.LBU, R.T3, R.S0, 3),
        asm.mem_op(O.LH, R.T3, R.S0, 0), asm.mem_op(O.LHU, R.T3, R.S0, 2),
        asm.mem_op(O.SB, R.T1, R.S0, 2), asm.mem_op(O.SH, R.T1, R.S0, 4),
        asm.mem_op(O.LWL, R.T3, R.S0, 1), asm.mem_op(O.LWR, R.T3, R.S0, 2),
        asm.mem_op(O.SWL, R.T0, R.S0, 5), asm.mem_op(O.SWR, R.T0, R.S0, 6),
        asm.mem_op(O.LL, R.T3, R.S0, 0), asm.mem_op(O.SC, R.T3, R.S0, 0),
        I(O.WSBH, R.T3, R.T0, 0, False, True),
        I(O.SEXT, R.T3, R.T0, 0, False, True), I(O.SEXT, R.T3, R.T0, 1, False, True),
        I(O.EXT, R.T3, R.T0, (7 << 5) | 4, False, True),
        *asm.li(R.T4, 0xCD), I(O.INS, R.T3, R.T4, (15 << 5) | 8, False, True),
        I(O.TEQ, R.T0, R.T1, 0, False, True),
        I(O.MADDU, 32, R.T0, R.T5, False, False), I(O.MADD, 32, R.T0, R.T5, False, False),
        I(O.MSUBU, 32, R.T0, R.T5, False, False), I(O.MSUB, 32, R.T0, R.T5, False, False),
        *asm.li(R.T4, 0), I(O.MEQ, R.T3, R.T0, R.T4, False, False),
        I(O.MNE, R.T3, R.T0, R.T5, False, False),
        asm.branch(O.BEQ, R.T0, R.T0, 8), asm.nop(), asm.nop(),
        asm.branch(O.BLTZ, R.T1, 0, 8), asm.nop(), asm.nop(),
        I(O.JumpDirect, R.RA, 8, 0, True, True), asm.nop(), asm.nop(),
    ]


def sha_body(w_ptr: int = 0x2000, h_ptr: int = 0x3000) -> list:
    """SHA-256 of "abc": the message schedule by SHA_EXTEND, one block by
    SHA_COMPRESS into the state at ``h_ptr``."""
    msg = b"abc"
    padded = msg + b"\x80" + b"\x00" * (55 - len(msg)) + (len(msg) * 8).to_bytes(8, "big")
    w_words = [int.from_bytes(padded[i:i + 4], "big") for i in range(0, 64, 4)]
    body = store(w_ptr, w_words) + store(h_ptr, SHA256_H0)
    body += call(C.SHA_EXTEND, w_ptr, 0)
    body += call(C.SHA_COMPRESS, w_ptr, h_ptr)
    return body


def poseidon2_body(ptr: int = 0x2000) -> list:
    """One Poseidon2 permutation of 16 field words in place."""
    return store(ptr, [(i * 0x9E3779B1 + 7) % 0x7F000001 for i in range(16)]) + \
        call(C.POSEIDON2_PERMUTE, ptr, 0)


def point_words(x, y, nw):
    return cv.int_to_words(x, nw) + cv.int_to_words(y, nw)


def wei_body(curve, add_code, dbl_code, dec_code, gx, gy) -> list:
    """Double, add and (where the curve has it) decompress on a Weierstrass curve."""
    nw = curve.nwords
    body = store(0x2000, point_words(gx, gy, nw))
    body += store(0x2100, point_words(gx, gy, nw))
    body += call(dbl_code, 0x2100, 0)
    body += call(add_code, 0x2000, 0x2100)
    if dec_code is not None:
        body += store(0x2300 + 4 * nw, cv.int_to_words(gx, nw))
        body += call(dec_code, 0x2300, gy & 1)
    return body


WEI_CURVES = {
    "secp256k1": (cv.SECP256K1, C.SECP256K1_ADD, C.SECP256K1_DOUBLE, C.SECP256K1_DECOMPRESS,
                  K1_GX, K1_GY),
    "secp256r1": (cv.SECP256R1, C.SECP256R1_ADD, C.SECP256R1_DOUBLE, C.SECP256R1_DECOMPRESS,
                  R1_GX, R1_GY),
    "bn254": (cv.BN254, C.BN254_ADD, C.BN254_DOUBLE, None, 1, 2),
    "bls12381": (cv.BLS12381, C.BLS12381_ADD, C.BLS12381_DOUBLE, C.BLS12381_DECOMPRESS,
                 BLS_GX, BLS_GY),
}


def ed_fp_u256_body() -> list:
    """Ed25519 add and decompress, bn254 fp and fp2 ops, uint256 products
    with and without a modulus."""
    body = store(0x2000, point_words(ED_BX, ED_BY, 8))
    body += store(0x2100, point_words(ED_BX, ED_BY, 8))
    body += call(C.ED_ADD, 0x2000, 0x2100)
    body += store(0x2200 + 32, cv.int_to_words(ED_BY, 8))
    body += call(C.ED_DECOMPRESS, 0x2200, ED_BX & 1)
    mod, nw = cv.FP_MOD["bn254"]
    a, b = 0x1234567890ABCDEF << 180, 0xFEDCBA0987654321 << 177
    body += store(0x3000, cv.int_to_words(a, nw))
    body += store(0x3100, cv.int_to_words(b, nw))
    body += call(C.BN254_FP_ADD, 0x3000, 0x3100)
    body += call(C.BN254_FP_SUB, 0x3000, 0x3100)
    body += call(C.BN254_FP_MUL, 0x3000, 0x3100)
    body += store(0x3200, cv.int_to_words(a % mod, nw) + cv.int_to_words(b % mod, nw))
    body += store(0x3300, cv.int_to_words(a * 3 % mod, nw) + cv.int_to_words(b * 7 % mod, nw))
    body += call(C.BN254_FP2_ADD, 0x3200, 0x3300)
    body += call(C.BN254_FP2_SUB, 0x3200, 0x3300)
    body += call(C.BN254_FP2_MUL, 0x3200, 0x3300)
    x, y, m256 = (1 << 255) - 19, 0xDEADBEEF << 200, (1 << 251) - 9
    body += store(0x4000, cv.int_to_words(x, 8))
    body += store(0x4100, cv.int_to_words(y, 8) + cv.int_to_words(m256, 8))
    body += call(C.UINT256_MUL, 0x4000, 0x4100)
    body += store(0x4200, cv.int_to_words(x, 8))
    body += store(0x4300, cv.int_to_words(y, 8) + [0] * 8)
    body += call(C.UINT256_MUL, 0x4200, 0x4300)
    return body


def bls_fp_body() -> list:
    """BLS12-381 fp and fp2 add, sub and mul."""
    mod, nw = cv.FP_MOD["bls12381"]
    a, b = BLS_GX * 7 % mod, BLS_GY * 11 % mod
    body = store(0x3000, cv.int_to_words(a, nw))
    body += store(0x3100, cv.int_to_words(b, nw))
    body += call(C.BLS12381_FP_ADD, 0x3000, 0x3100)
    body += call(C.BLS12381_FP_SUB, 0x3000, 0x3100)
    body += call(C.BLS12381_FP_MUL, 0x3000, 0x3100)
    body += store(0x3200, cv.int_to_words(a, nw) + cv.int_to_words(b, nw))
    body += store(0x3400, cv.int_to_words(b, nw) + cv.int_to_words(a, nw))
    body += call(C.BLS12381_FP2_ADD, 0x3200, 0x3400)
    body += call(C.BLS12381_FP2_SUB, 0x3200, 0x3400)
    body += call(C.BLS12381_FP2_MUL, 0x3200, 0x3400)
    return body


def u256x2048_body() -> list:
    """One 256 x 2048-bit product, low words to 0x5000, high to 0x6000."""
    a = (1 << 256) - 0x12345
    bv = ((1 << 2048) - 0xABCDE) // 3
    body = store(0x2000, cv.int_to_words(a, 8))
    body += store(0x3000, cv.int_to_words(bv, 64))
    body += [*asm.li(R.A2, 0x5000), *asm.li(R.A3, 0x6000)]
    return body + call(C.U256XU2048_MUL, 0x2000, 0x3000)


def linux_body() -> list:
    """Emulated Linux o32 syscalls: brk, mmap2, clone, read, write, fcntl, a nop."""
    return [
        *call(C.SYS_BRK, 0, 0), *call(C.SYS_MMAP2, 0, 0x1234), *call(C.SYS_CLONE, 0, 0),
        *call(C.SYS_READ, 0, 0), *asm.li(R.A2, 0), *call(C.SYS_WRITE, 1, 0x2000),
        *call(C.SYS_FCNTL, 1, 3), *call(C.SYS_GETTID, 0, 0),
    ]


def ec_body() -> list:
    """Every EC, fp-tower and uint256 syscall."""
    body = []
    for args in WEI_CURVES.values():
        body += wei_body(*args)
    return body + ed_fp_u256_body() + bls_fp_body() + u256x2048_body()


def every_chip_program():
    """A guest for which every chip of the full machine has rows."""
    return program(all_ops_body() + sha_body(0x8000, 0x9000) + keccak_body(0xA000, 0xB000)
                   + poseidon2_body(0xC000) + ec_body() + linux_body())


def keccak_message_program(data: bytes):
    """keccak256 of ``data`` in one KECCAK_SPONGE call: the message padded
    to 136-byte rate blocks, each followed by two state words."""
    padded = bytearray(data) + bytearray(136 - len(data) % 136)
    padded[len(data)] = 0x01
    padded[-1] |= 0x80
    words = []
    for blk in range(0, len(padded), 136):
        words += [int.from_bytes(padded[blk + i : blk + i + 4], "little")
                  for i in range(0, 136, 4)] + [0, 0]
    body = store(0x2000, words) + store(0x3000 + 64, [len(words)])
    body += call(C.KECCAK_SPONGE, 0x2000, 0x3000)
    return program(body)


def sha256_message_program(msg: bytes):
    """SHA-256 of a one-block ``msg`` (at most 55 bytes): SHA_EXTEND, then
    SHA_COMPRESS into the state at 0x3000."""
    assert len(msg) <= 55, "single-block message"
    padded = msg + b"\x80" + b"\x00" * (55 - len(msg)) + (len(msg) * 8).to_bytes(8, "big")
    w_words = [int.from_bytes(padded[i : i + 4], "big") for i in range(0, 64, 4)]
    body = store(0x2000, w_words) + store(0x3000, SHA256_H0)
    body += call(C.SHA_EXTEND, 0x2000, 0) + call(C.SHA_COMPRESS, 0x2000, 0x3000)
    return program(body)


def poseidon2_program(vals):
    """One POSEIDON2_PERMUTE of the 16 words ``vals`` in place at 0x2000."""
    return program(store(0x2000, vals) + call(C.POSEIDON2_PERMUTE, 0x2000, 0))
