"""keccak256 via the KeccakSponge precompile chip (the reference's
keccak-precompile example: sha3 hashing at ~1 syscall per message)."""

from ..executor import Opcode, Register, asm
from ._common import client_from_args, timed

R, O = Register, Opcode
KECCAK_SPONGE = 0x01010009
DATA = b"The quick brown fox jumps over the lazy dog"


def keccak_guest(data: bytes):
    padded = bytearray(data) + bytearray(136 - len(data) % 136)
    padded[len(data)] = 0x01
    padded[-1] |= 0x80
    words = []
    for blk in range(0, len(padded), 136):
        words += [int.from_bytes(padded[blk + i : blk + i + 4], "little")
                  for i in range(0, 136, 4)] + [0, 0]
    body = []
    for i, w in enumerate(words):
        body += [*asm.li(R.T0, w), *asm.li(R.T1, 0x2000 + 4 * i), asm.sw(R.T0, R.T1)]
    body += [*asm.li(R.T0, len(words)), *asm.li(R.T1, 0x3000 + 64), asm.sw(R.T0, R.T1)]
    body += [*asm.li(R.V0, KECCAK_SPONGE), *asm.li(R.A0, 0x2000), *asm.li(R.A1, 0x3000), asm.syscall()]
    return asm.prog(body + asm.halt_sequence())


def _keccak256(data: bytes) -> bytes:
    """Independent Python keccak256 for the cross-check."""
    RC = [0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
          0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
          0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
          0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
          0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
          0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008]
    ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
           [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]

    def rol(x, n):
        return ((x << n) | (x >> (64 - n))) & (2**64 - 1)

    st = [[0] * 5 for _ in range(5)]
    padded = bytearray(data) + bytearray(136 - len(data) % 136)
    padded[len(data)] = 0x01
    padded[-1] |= 0x80
    for blk in range(0, len(padded), 136):
        for i in range(17):
            lane = int.from_bytes(padded[blk + 8 * i : blk + 8 * i + 8], "little")
            st[i % 5][i // 5] ^= lane
        for rnd in range(24):
            c = [st[x][0] ^ st[x][1] ^ st[x][2] ^ st[x][3] ^ st[x][4] for x in range(5)]
            d = [c[(x - 1) % 5] ^ rol(c[(x + 1) % 5], 1) for x in range(5)]
            for x in range(5):
                for y in range(5):
                    st[x][y] ^= d[x]
            b = [[0] * 5 for _ in range(5)]
            for x in range(5):
                for y in range(5):
                    b[y][(2 * x + 3 * y) % 5] = rol(st[x][y], ROT[x][y])
            for x in range(5):
                for y in range(5):
                    st[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
            st[0][0] ^= RC[rnd]
    out = b""
    for i in range(4):
        out += st[i % 5][i // 5].to_bytes(8, "little")
    return out


def main(argv=None) -> dict:
    client, _ = client_from_args(__doc__, argv)
    data = DATA
    program = keccak_guest(data)

    pk, vk = timed("setup", client.setup, program)
    proof = timed("prove", client.prove, pk, program)
    assert timed("verify", client.verify, vk, proof, program)

    ex = client._executor(program, None)
    ex.run()
    digest = b"".join(ex.word(0x3000 + 4 * i).to_bytes(4, "little") for i in range(8))
    assert digest == _keccak256(data)
    print(f"keccak256 = {digest.hex()}")
    print("ok")
    return {"keccak256": digest.hex()}


if __name__ == "__main__":
    main()
