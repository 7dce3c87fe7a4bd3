"""KECCAK_SPONGE (Ziren's keccak/sponge.rs): absorb the input's 36-word
blocks (18 lanes each: the 17 rate lanes and one of the capacity) with the
plain Keccak-f, then write the first 16 words of the state at the result
pointer.  The input length in words lies at result + 64."""

from .. import keccak

CODE = 0x01_01_00_09


def run(mem: dict, in_ptr: int, out_ptr: int):
    n_words = mem.get(out_ptr + 64, 0)
    if n_words % 36:
        raise ValueError("keccak sponge input is not a whole number of 36-word blocks")
    words = [mem.get(in_ptr + 4 * i, 0) for i in range(n_words)]
    state = [0] * 25
    for blk in range(0, n_words, 36):
        for i in range(18):
            state[i] ^= words[blk + 2 * i] | (words[blk + 2 * i + 1] << 32)
        state = keccak.keccak_f(state)
    for i in range(8):
        mem[out_ptr + 8 * i] = state[i] & 0xFFFFFFFF
        mem[out_ptr + 8 * i + 4] = state[i] >> 32
