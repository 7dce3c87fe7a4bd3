"""Debug oracles: row-level constraint checker + lookup multiset balance.

The development sanitizers for chip authoring (reference:
crates/stark/src/debug.rs:30,128 ``debug_constraints`` and
crates/stark/src/lookup/debug.rs:62,134 ``debug_lookups``).  They operate on
raw (canonical) traces *before* proving, on the CPU, and pinpoint the
failing constraint index / row or the unbalanced lookup values.  Traces may
be numpy uint32 arrays (as the chips' fills return them) or int32 tensors
with the same bits.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..ops import field as f
from . import air
from .air import EvalContext, Selector, eval_expr


def _canonical_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return np.ascontiguousarray(t.detach().cpu().to(torch.int32).numpy()).view(np.uint32)
    return np.ascontiguousarray(np.asarray(t).astype(np.uint32))


def _monty(t) -> torch.Tensor:
    """Canonical trace -> Montgomery int32 tensor on the CPU."""
    return f.to_monty(torch.from_numpy(_canonical_np(t).view(np.int32).copy()))


def debug_constraints(
    chip,
    main_canonical,
    prep_canonical=None,
    publics=None,
    perm_flat=None,  # Montgomery (H, 4W): pass to also check LogUp constraints
    perm_challenges=None,
    cum_sum=None,
    global_sum=None,
):
    """Evaluate every constraint on every row; raise with (constraint, row) on failure.

    Traces, publics and ``global_sum`` are canonical; ``perm_flat``,
    ``perm_challenges`` and ``cum_sum`` are Montgomery int32 tensors, as
    ``permutation.generate_permutation_trace`` returns them."""
    main_np = _canonical_np(main_canonical)
    h = main_np.shape[0]
    main = _monty(main_np)
    prep = _monty(prep_canonical) if prep_canonical is not None else None

    def roll1(a):
        return torch.roll(a, -1, dims=0)

    def var_fn(segment, col, offset):
        if segment == air.MAIN:
            arr = main if offset == 0 else roll1(main)
            return arr[:, col]
        if segment == air.PREPROCESSED:
            arr = prep if offset == 0 else roll1(prep)
            return arr[:, col]
        if segment == air.PERM:
            if perm_flat is None:
                raise ValueError("perm trace not supplied")
            arr = perm_flat if offset == 0 else roll1(perm_flat)
            return arr[:, 4 * col : 4 * col + 4]
        raise ValueError(segment)

    first = torch.zeros(h, dtype=torch.int32)
    first[0] = f.MONTY_ONE
    last = torch.zeros(h, dtype=torch.int32)
    last[-1] = f.MONTY_ONE
    transition = torch.full((h,), f.MONTY_ONE, dtype=torch.int32)
    transition[-1] = 0

    ctx = EvalContext(
        var_fn,
        selectors={Selector.FIRST: first, Selector.LAST: last, Selector.TRANSITION: transition},
        publics=_monty(publics) if publics is not None else None,
        challenges=perm_challenges,
        cum_sum=cum_sum,
        global_sum=_monty(global_sum) if global_sum is not None else None,
    )
    constraints = chip.constraints if perm_flat is not None else [
        c for c in chip.constraints if not _mentions_perm(c)
    ]
    for ci, c in enumerate(constraints):
        arr = eval_expr(c, ctx).arr
        if arr.dim() == 0:
            arr = arr.expand(h)
        bad = torch.nonzero(arr.reshape(h, -1).any(dim=-1)).flatten()
        if bad.numel():
            row = int(bad[0])
            raise AssertionError(
                f"chip {chip.name}: constraint #{ci} fails at row {row} "
                f"(first of {bad.numel()} failing rows); local row = "
                f"{main_np[row].tolist()}"
            )
    return True


def _mentions_perm(e, cache=None):
    if cache is None:
        cache = {}
    k = id(e)
    if k in cache:
        return cache[k]
    if isinstance(e, air.Var):
        r = e.segment == air.PERM
    elif isinstance(e, (air.CumSumLocal, air.Challenge)):
        r = True
    elif isinstance(e, (air.Add, air.Sub, air.Mul)):
        r = _mentions_perm(e.a, cache) or _mentions_perm(e.b, cache)
    elif isinstance(e, air.Neg):
        r = _mentions_perm(e.a, cache)
    else:
        r = False
    cache[k] = r
    return r


def debug_lookups(chips_traces, scope=air.Scope.Local, max_report: int = 10):
    """Check global multiset balance of all lookups across chips.

    chips_traces: list of (chip, main_canonical, prep_canonical_or_None).
    Returns {} if balanced, else {kind: [(values, net_mult), ...]}.
    """
    balance: dict = defaultdict(lambda: defaultdict(int))
    for chip, main_c, prep_c in chips_traces:
        main = _monty(main_c)
        h = main.shape[0]
        prep = _monty(prep_c) if prep_c is not None else None

        def var_fn(segment, col, offset, main=main, prep=prep):
            assert offset == 0
            return (main if segment == air.MAIN else prep)[:, col]

        ctx = EvalContext(var_fn, selectors=None)

        def column(e, ctx=ctx, h=h):
            return f.from_monty(eval_expr(e, ctx).arr).expand(h).tolist()

        for lookup, sign in [(l, 1) for l in chip.sends] + [(l, -1) for l in chip.receives]:
            if lookup.scope != scope:
                continue
            vals = [column(v) for v in lookup.values]
            mult = column(lookup.multiplicity)
            table = balance[lookup.kind]
            for r, m in enumerate(mult):
                if m:
                    key = tuple(v[r] for v in vals)
                    table[key] = (table[key] + sign * m) % f.P
    problems = {}
    for kind, table in balance.items():
        bad = [(k, v) for k, v in table.items() if v != 0]
        if bad:
            problems[kind] = bad[:max_report]
    return problems
