"""Plain Keccak-f[1600] and Keccak-256 on Python integers.

Written from the Keccak reference (FIPS 202, section 3, with the original
Keccak padding 0x01 .. 0x80 that Ethereum's keccak256 uses).  Lanes are
indexed x + 5 y.  Nothing here is shared with the program under test.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1
RATE_BYTES = 136  # Keccak-256: capacity 512 bits


def _round_constants() -> list:
    """RC[i] from the degree-8 LFSR of FIPS 202, algorithm 5."""
    out = []
    r = 1
    bits = []
    for _ in range(255):
        bits.append(r & 1)
        r <<= 1
        if r & 0x100:
            r ^= 0x171
    for i in range(24):
        rc = 0
        for j in range(7):
            if bits[(j + 7 * i) % 255]:
                rc |= 1 << ((1 << j) - 1)
        out.append(rc)
    return out


def _rotation_offsets() -> list:
    """rho offsets by lane index x + 5 y (FIPS 202, algorithm 2)."""
    rot = [0] * 25
    x, y = 1, 0
    for t in range(24):
        rot[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return rot


RC = _round_constants()
ROT = _rotation_offsets()


def _rol(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & MASK64 if r else v


def keccak_f(lanes: list) -> list:
    """The 24-round permutation of 25 64-bit lanes (index x + 5 y)."""
    a = list(lanes)
    for rc in RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], ROT[x + 5 * y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & MASK64 & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Keccak-256 with the original padding (Ethereum's keccak256)."""
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % RATE_BYTES:
        padded.append(0)
    padded[-1] |= 0x80
    state = [0] * 25
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off:off + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = keccak_f(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))
