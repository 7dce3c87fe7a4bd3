"""The plain Keccak-f[1600] and Keccak-256 against published vectors."""

from zkbench.reference import keccak


def test_keccak_f_of_the_zero_state():
    # the Keccak team's KeccakF-1600 intermediate values: lane 0 after one permutation of zero
    out = keccak.keccak_f([0] * 25)
    assert out[0] == 0xF1258F7940E1DDE7
    assert out[1] == 0x84D5CCF933C0478A


def test_keccak256_vectors():
    assert keccak.keccak256(b"").hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak.keccak256(b"abc").hex() == \
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    assert keccak.keccak256(b"The quick brown fox jumps over the lazy dog").hex() == \
        "4d741b6f1eb29cb2a9b9911c82f56fa8d73b04959d3d9d222895df6c0b28aa15"


def test_round_constants():
    assert keccak.RC[0] == 1 and keccak.RC[1] == 0x8082 and keccak.RC[23] == 0x8000000080008008
