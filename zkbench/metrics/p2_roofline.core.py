"""The Poseidon2 kernels' share of their roofline, in %: the least time one
card needs for the permutations of every proof made in the window (counted
from the proofs' shapes by ``work``) over the device time of K1
(``hash_rows_kernel``), K2 and the grind (``permute_kernel``)."""


def read(ctx):
    if ctx.device is None:
        return None
    return ctx.work.p2_roofline(ctx.proofs, ctx.device["kernel_s"], ctx.peak)
