"""Quotient polynomial evaluation over the disjoint coset.

Every trace segment is extended onto the chip's quotient domain (size
H << lqd, shift g) from its commit-stage coefficients, the alpha-folded
constraint sum is evaluated pointwise and divided by the vanishing
polynomial, and the result is split into 2^lqd stride-interleaved chunks
(each an (H, 4) base matrix).

On a CUDA device the fold is one launch of the fold kernel
(``ops/quotient_cuda.py``) over the chip's tape (``quotient_tape.py``, compiled
once a chip), which reads the LDEs in place, computes the selectors per row
and writes the chunks.  On the CPU the DAG is evaluated eagerly over row
blocks of the quotient domain, so that each value ``air.fold_constraints``
holds (a node's, until its last reader) covers one block, not the whole
domain.  The next-row view of a block is the circular slice ``step`` rows
further on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field as f, ntt, quotient_cuda
from ..utils.logger import note
from . import air, quotient_tape
from .air import EvalContext, Selector, fold_constraints
from .domain import Domain

BLOCK_ROWS = 1 << 19


def coset_selectors(log_h: int, lqd: int, device) -> dict:
    """Selectors and 1/Z_H over the quotient domain g * <w_{H << lqd}>."""
    n = 1 << (log_h + lqd)
    pts = f.mul(f.batch_powers(f.two_adic_generator_int(log_h + lqd), n, device),
                f.to_monty_int(f.GENERATOR))
    zh = f.sub(f.pow_const(pts, 1 << log_h), f.ONE)
    last = f.to_monty_int(f.inv_int(f.two_adic_generator_int(log_h)))
    x_min_last = f.sub(pts, last)
    return {
        Selector.FIRST: f.mul(zh, f.inv(f.sub(pts, f.ONE))),
        Selector.LAST: f.mul(zh, f.inv(x_min_last)),
        Selector.TRANSITION: x_min_last,
        "inv_zeroifier": f.inv(zh),
    }


# The reference's device-side twin of ``coset_selectors``; here that one
# already runs on the device it is given.
coset_selectors_dev = coset_selectors


def pow_mod_vec(x: np.ndarray, e: int) -> np.ndarray:
    """x ** e mod p for uint64 canonical numpy arrays (square-and-multiply)."""
    r = np.ones_like(x)
    b = x % f.P
    while e:
        if e & 1:
            r = r * b % f.P
        b = b * b % f.P
        e >>= 1
    return r


def lde_onto_quotient_domain(trace, log_h: int, lqd: int, coeffs=None) -> torch.Tensor:
    """(H, w) evaluations on <w_H> -> (H << lqd, w) on g * <w_N>, natural
    order.  ``coeffs``: the trace's iNTT if the commit stage already has it."""
    if coeffs is None:
        coeffs = ntt.ntt(trace, inverse=True)
    return ntt.extend_coeffs(coeffs, f.GENERATOR, lqd)


def _rows_circular(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    n = t.shape[0]
    if hi <= n:
        return t[lo:hi]
    return torch.cat([t[lo:], t[: hi - n]], dim=0)


def quotient_chunks(chip, main, prep, perm_flat, publics, challenges, cum_sum, global_sum,
                    alpha, main_coeffs=None, prep_coeffs=None, perm_coeffs=None, plain: bool = False):
    """Returns (chunk_domains, chunk_matrices (H, 4) int32 each).  ``plain``
    takes the eager fold on a CUDA device too (a replay that launches no
    kernel)."""
    h = main.shape[0]
    log_h = h.bit_length() - 1
    lqd = chip.log_quotient_degree
    main_q = lde_onto_quotient_domain(main, log_h, lqd, main_coeffs)
    prep_q = None if prep is None else lde_onto_quotient_domain(prep, log_h, lqd, prep_coeffs)
    perm_q = (lde_onto_quotient_domain(perm_flat, log_h, lqd, perm_coeffs)
              if perm_flat.shape[1] else None)
    fold = fold_chunks_kernel if main.is_cuda and not plain else fold_chunks_eager
    chunks = fold(chip, main_q, prep_q, perm_q, log_h, publics, challenges, cum_sum, global_sum, alpha)
    qdom = Domain(log_h, 1).create_disjoint_domain(h << lqd)
    return qdom.split_domains(1 << lqd), chunks


def fold_chunks_kernel(chip, main_q, prep_q, perm_q, log_h, publics, challenges, cum_sum,
                       global_sum, alpha) -> list:
    """The chunks of the quotient from the LDEs onto the quotient domain, by
    one launch of the fold kernel over the chip's tape (CUDA tensors)."""
    tape = quotient_tape.chip_tape(chip)
    for seg, t, what in ((air.PREPROCESSED, prep_q, "preprocessed"), (air.PERM, perm_q, "permutation")):
        if seg in tape.reads and (t is None or t.shape[1] == 0):
            raise ValueError(f"quotient fold: the {chip.name} tape reads the {what} trace, none given")
    uni = quotient_tape.uniforms(tape, log_h, publics, challenges, cum_sum, global_sum, alpha)
    note(f"quotient.tape.{chip.name}", tape.n_instr)
    return list(quotient_cuda.fold_chunks(
        tape.code_on(main_q.device), main_q, prep_q, perm_q, uni, log_h=log_h, lqd=tape.lqd,
        n_base=tape.n_base, n_ext=tape.n_ext, inv_zh=tape.INV_ZH, invert=tape.invert,
        **quotient_tape.coset_params(log_h, tape.lqd)))


def fold_chunks_eager(chip, main_q, prep_q, perm_q, log_h, publics, challenges, cum_sum,
                      global_sum, alpha) -> list:
    """The same chunks by ``air.fold_constraints`` over blocks of rows, on
    any device: the plain version."""
    dev = main_q.device
    lqd = chip.log_quotient_degree
    step = 1 << lqd
    big_n = main_q.shape[0]
    sels = coset_selectors(log_h, lqd, dev)

    q_blocks = []
    for lo in range(0, big_n, BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, big_n)
        segs = {air.MAIN: main_q, air.PREPROCESSED: prep_q, air.PERM: perm_q}
        local = {k: None if v is None else v[lo:hi] for k, v in segs.items()}
        nxt = {k: None if v is None else _rows_circular(v, lo + step, hi + step)
               for k, v in segs.items()}

        def var_fn(segment, col, offset, local=local, nxt=nxt):
            arr = (local if offset == 0 else nxt)[segment]
            if segment == air.PERM:
                return arr[:, 4 * col : 4 * col + 4]
            return arr[:, col]

        ctx = EvalContext(
            var_fn,
            selectors={k: sels[k][lo:hi] for k in (Selector.FIRST, Selector.LAST, Selector.TRANSITION)},
            publics=publics, challenges=challenges, cum_sum=cum_sum, global_sum=global_sum,
            device=dev,
        )
        folded = fold_constraints(chip.constraints, alpha, ctx)
        q_blocks.append(f.mul(folded, sels["inv_zeroifier"][lo:hi, None]))
        del ctx, folded
    qvals = torch.cat(q_blocks, dim=0)
    return [qvals[i::step].contiguous() for i in range(step)]
