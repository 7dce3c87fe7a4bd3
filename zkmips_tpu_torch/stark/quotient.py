"""Quotient polynomial evaluation over the disjoint coset.

Every trace segment is extended onto the chip's quotient domain (size
H << lqd, shift g) from its commit-stage coefficients, the alpha-folded
constraint sum is evaluated pointwise and divided by the vanishing
polynomial, and the result is split into 2^lqd stride-interleaved chunks
(each an (H, 4) base matrix).

The DAG is evaluated over row blocks of the quotient domain, so that each
value ``air.fold_constraints`` holds (a node's, until its last reader) covers
one block, not the whole domain.  The next-row view of a block is the
circular slice ``step`` rows further on.
"""

from __future__ import annotations

import torch

from ..ops import field as f, ntt
from . import air
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
                    alpha, main_coeffs=None, prep_coeffs=None, perm_coeffs=None):
    """Returns (chunk_domains, chunk_matrices (H, 4) int32 each)."""
    h = main.shape[0]
    dev = main.device
    log_h = h.bit_length() - 1
    lqd = chip.log_quotient_degree
    step = 1 << lqd
    big_n = h << lqd

    main_q = lde_onto_quotient_domain(main, log_h, lqd, main_coeffs)
    prep_q = None if prep is None else lde_onto_quotient_domain(prep, log_h, lqd, prep_coeffs)
    perm_q = (lde_onto_quotient_domain(perm_flat, log_h, lqd, perm_coeffs)
              if perm_flat.shape[1] else None)
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

    qdom = Domain(log_h, 1).create_disjoint_domain(big_n)
    return qdom.split_domains(step), [qvals[i::step].contiguous() for i in range(step)]
