"""LogUp permutation argument: trace generation + constraint generation.

  * fingerprint D = alpha + kind + sum_i beta^{i+1} * value_i
  * perm column j = sum over batch j of (+-) mult / D
  * last column = inclusive prefix sum of the batch-column row sums
  * constraints: entry * prod(D) = sum m_i * prod_{j!=i} D_j;
    phi_first = row_sum; phi_next - phi_local = row_sum_next;
    phi_last = claimed local cumulative sum
  * global-scope chips bind their last-row trailing 14 main columns to the
    claimed global septic digest

The denominators are inverted with the reference's batch inversion (one ext
inverse over a running product when there are more than 2 lookups), so a
zero denominator zeroes the same fractions as there.  On a CUDA device the
trace of a chip is three launches of the LogUp kernels
(``ops/logup_cuda.py``) over the chip's tape (``logup_tape.py``, compiled
once a chip), which write the chunk columns and the running sum in place and
the cumulative sum into a device tensor of the shard, read back once for
every chip.  On the CPU, and in a replay that launches no kernel
(``plain``), the eager path evaluates every row at once with torch.
"""

from __future__ import annotations

import torch

from ..ops import bits, ext4, field as f, logup_cuda
from ..utils.logger import note
from . import air, logup_tape
from .air import AirBuilder, Challenge, Const, CumSumLocal, EvalContext, GlobalSumCoord, Scope, Var, eval_expr

BATCH_SIZE = 2


def perm_width(n_lookups: int, batch_size: int = BATCH_SIZE) -> int:
    """Width in ext elements."""
    if n_lookups == 0:
        return 0
    return -(-n_lookups // batch_size) + 1


def local_lookups(chip) -> tuple[list, list]:
    sends = [l for l in chip.sends if l.scope == Scope.Local]
    receives = [l for l in chip.receives if l.scope == Scope.Local]
    return sends, receives


def _lookup_chunks(sends, receives, batch_size):
    items = [(l, True) for l in sends] + [(l, False) for l in receives]
    return [items[i : i + batch_size] for i in range(0, len(items), batch_size)]


def generate_permutation_trace(chip, prep, main, alpha, beta, batch_size: int = BATCH_SIZE,
                               plain: bool = False):
    """Returns (perm_flat (H, 4*width) int32 on main's device, local
    cumulative sum (4,) CPU int32).  ``plain`` takes the eager path on a CUDA
    device too."""
    (flat,), (cum,) = generate_permutation_traces([(chip, prep, main, batch_size)], alpha, beta, plain)
    return flat, cum


def generate_permutation_traces(jobs, alpha, beta, plain: bool = False) -> tuple[list, list]:
    """The permutation traces of a shard's chips, ``jobs`` a list of (chip,
    prep, main, batch_size): (perm_flats, local cumulative sums (4,) CPU
    int32).  On CUDA traces (and not ``plain``) every chip goes through the
    kernels and the host waits once, for the cumulative sums of all."""
    if plain or not any(main.is_cuda for _, _, main, _ in jobs):
        out = [generate_permutation_trace_eager(c, p, m, alpha, beta, bs) for c, p, m, bs in jobs]
        return [flat for flat, _ in out], [cum for _, cum in out]
    dev = jobs[0][2].device
    tapes = [logup_tape.chip_logup(c, bs) if any(local_lookups(c)) else None for c, _, _, bs in jobs]
    n_pows = max((t.n_pows for t in tapes if t is not None), default=1)
    chal = logup_tape.challenge_table(alpha, beta, n_pows).pin_memory().to(dev, non_blocking=True)
    totals = torch.zeros((len(jobs), 4), dtype=torch.int32, device=dev)
    flats = [generate_permutation_trace_kernel(c, tape, p, m, chal, totals[i])
             for i, ((c, p, m, _), tape) in enumerate(zip(jobs, tapes))]
    return flats, [t.clone() for t in totals.cpu()]


def generate_permutation_trace_kernel(chip, tape, prep, main, chal, total) -> torch.Tensor:
    """A chip's perm_flat by the LogUp kernels over its ``tape`` (None: no
    local lookups, an empty trace), its cumulative sum written to ``total``
    (a (4,) view on main's device, left as it is without lookups)."""
    if tape is None:
        return torch.zeros((main.shape[0], 0), dtype=torch.int32, device=main.device)
    if air.PREPROCESSED in tape.reads and prep is None:
        raise ValueError(f"logup: the {chip.name} tape reads the preprocessed trace, none given")
    note(f"perm.tape.{chip.name}", tape.n_instr)
    code, consts = tape.on(main.device)
    return logup_cuda.permutation_trace(
        code, consts, main, prep, chal, total, n_base=tape.n_base, n_lookups=tape.n_lookups,
        batch_size=tape.batch_size)


def generate_permutation_trace_eager(chip, prep, main, alpha, beta, batch_size: int = BATCH_SIZE):
    """The plain version, on any device: every row at once, an int64 torch
    launch or more per lookup and step.  Returns what
    ``generate_permutation_trace`` does."""
    sends, receives = local_lookups(chip)
    h = main.shape[0]
    dev = main.device
    if not sends and not receives:
        return torch.zeros((h, 0), dtype=torch.int32, device=dev), ext4.zero()

    def var_fn(segment, col, offset):
        assert offset == 0, "lookup exprs may only reference the local row"
        if segment == air.MAIN:
            return main[:, col]
        if segment == air.PREPROCESSED:
            return prep[:, col]
        raise ValueError("lookups cannot reference the permutation trace")

    ctx = EvalContext(var_fn, selectors=None, device=dev)
    chunks = _lookup_chunks(sends, receives, batch_size)
    alpha, beta = alpha.to(dev), beta.to(dev)
    beta_pows = ext4.powers(beta, 2 + max(len(l.values) for l in sends + receives))

    def as_col(v):
        return v.expand(h) if v.dim() == 0 else v

    denoms, mults = [], []
    for lookup, is_send in (lk for chunk in chunks for lk in chunk):
        d0 = ext4.add(alpha, ext4.scalar(lookup.argument_index, device=dev))
        if lookup.values:
            nv = len(lookup.values)
            vmat = torch.stack([as_col(eval_expr(v, ctx).arr) for v in lookup.values], dim=1)
            prod = f.mul(vmat[:, :, None], beta_pows[1 : nv + 1][None, :, :])  # (H, nv, 4)
            d = ext4.add(d0[None, :], bits.sum_mod(prod, dim=1))
        else:
            d = d0[None, :].expand(h, 4)
        denoms.append(d)
        mult = as_col(eval_expr(lookup.multiplicity, ctx).arr)
        mults.append(mult if is_send else f.neg(mult))

    # batch inversion over the lookup axis (the reference's algorithm)
    n_lk = len(denoms)
    if n_lk > 2:
        prefix = [denoms[0]]
        for d in denoms[1:]:
            prefix.append(ext4.mul(prefix[-1], d))
        inv_p = ext4.inv(prefix[-1])
        inv_list = [None] * n_lk
        for i in range(n_lk - 1, 0, -1):
            inv_list[i] = ext4.mul(inv_p, prefix[i - 1])
            inv_p = ext4.mul(inv_p, denoms[i])
        inv_list[0] = inv_p
        del prefix
    else:
        inv_list = list(ext4.inv(torch.stack(denoms, dim=0)))
    del denoms

    cols, li = [], 0
    for chunk in chunks:
        col = None
        for _ in chunk:
            frac = f.mul64(inv_list[li], mults[li][:, None])
            li += 1
            col = frac if col is None else col + frac
        cols.append(col % f.P)
    row_sum = torch.stack(cols, dim=0).sum(dim=0) % f.P
    phi = torch.cumsum(row_sum, dim=0) % f.P  # inclusive prefix sum
    flat = f.narrow(torch.cat(cols + [phi], dim=1))
    return flat, f.narrow(phi[-1]).cpu()


def eval_permutation_constraints(chip, builder: AirBuilder, batch_size: int = BATCH_SIZE):
    """Append the LogUp constraints to the chip's builder."""
    sends, receives = local_lookups(chip)
    n = len(sends) + len(receives)
    if n > 0:
        chunks = _lookup_chunks(sends, receives, batch_size)
        width = len(chunks) + 1
        alpha, beta = Challenge(0), Challenge(1)

        # beta^k as a balanced tree of shared Mul nodes (the reference's DAG)
        _bpow_cache = {1: beta}

        def bpow(k: int):
            node = _bpow_cache.get(k)
            if node is None:
                half = k // 2
                node = bpow(half) * bpow(k - half)
                _bpow_cache[k] = node
            return node

        def perm(col, offset=0):
            return Var(air.PERM, col, offset)

        for j, chunk in enumerate(chunks):
            rlcs, mults = [], []
            for lookup, is_send in chunk:
                rlc = alpha + Const(lookup.argument_index)
                for vi, v in enumerate(lookup.values):
                    rlc = rlc + bpow(vi + 1) * v
                rlcs.append(rlc)
                mults.append(lookup.multiplicity if is_send else -lookup.multiplicity)
            product = rlcs[0]
            for r in rlcs[1:]:
                product = product * r
            numerator = None
            for i, m in enumerate(mults):
                others = None
                for k, r in enumerate(rlcs):
                    if k != i:
                        others = r if others is None else others * r
                term = m if others is None else m * others
                numerator = term if numerator is None else numerator + term
            builder.assert_zero(perm(j) * product - numerator)

        sum_local = perm(0)
        sum_next = perm(0, 1)
        for j in range(1, width - 1):
            sum_local = sum_local + perm(j)
            sum_next = sum_next + perm(j, 1)
        phi_local = perm(width - 1)
        phi_next = perm(width - 1, 1)
        builder.when_first_row().assert_zero(phi_local - sum_local)
        builder.when_transition().assert_zero(phi_next - phi_local - sum_next)
        builder.when_last_row().assert_zero(phi_local - CumSumLocal())

    if chip.commit_scope == Scope.Global:
        w = chip.main_width
        for i in range(14):
            builder.when_last_row().assert_zero(builder.main(w - 14 + i) - GlobalSumCoord(i))
