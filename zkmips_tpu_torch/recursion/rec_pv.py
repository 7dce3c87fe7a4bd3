"""Recursion public-values record: the O(1) aggregation state.

The analog of the reference's ``RecursionPublicValues``
(crates/recursion/core/src/air/public_values.rs:79-145): every recursion
proof (lift / compress / shrink / wrap) commits this flat felt record
instead of an opaque digest, and the compress programs enforce the shard
chain rules IN-CIRCUIT (crates/recursion/circuit/src/machine/compress.rs:
94-480), so the final proof's public values alone authenticate the whole
execution — proof size and verify cost stop growing with the shard count.

Layout (canonical felts):
"""

from __future__ import annotations

import torch

from ..machine import pv as core_pv
from ..ops import field as ff, septic

_o = 0


def _span(n):
    global _o
    s = (_o, _o + n)
    _o += n
    return s

COMMITTED_DIGEST = _span(16)          # 16 halfwords (8 u32 words lo/hi)
DEFERRED_DIGEST = _span(8)
START_PC = _span(1)
NEXT_PC = _span(1)
EXIT_CODE = _span(1)
START_SHARD = _span(1)
NEXT_SHARD = _span(1)
START_EXECUTION_SHARD = _span(1)
NEXT_EXECUTION_SHARD = _span(1)
CONTAINS_EXECUTION_SHARD = _span(1)
PREV_INIT_ADDR = _span(2)             # 16-bit limb pairs (core pv layout)
LAST_INIT_ADDR = _span(2)
PREV_FINALIZE_ADDR = _span(2)
LAST_FINALIZE_ADDR = _span(2)
START_RECONSTRUCT_DEFERRED = _span(8)
END_RECONSTRUCT_DEFERRED = _span(8)
CORE_VK_DIGEST = _span(8)             # canonical felts of the core vk root
GLOBAL_SUM = _span(14)                # septic curve point (x, y)

NUM_REC_PV = _o


def canonical_digest(root) -> list:
    """A KoalaBear digest held in Montgomery form (an int32 tensor or a
    uint32 array) as canonical ints."""
    vals = root.tolist() if isinstance(root, torch.Tensor) else [int(x) for x in root]
    return [ff.from_monty_int(int(v) & 0xFFFFFFFF) for v in vals]


def get(rec, span):
    lo, hi = span
    return [int(x) for x in rec[lo:hi]]


def _set(rec, span, vals):
    lo, hi = span
    assert hi - lo == len(vals)
    rec[lo:hi] = [int(v) % ff.P for v in vals]


def lift_record(core_vk, pv, global_sum, has_cpu: bool) -> list:
    """Host-side expected record for a lifted core shard (the in-circuit
    mapping of ShardVerifierCircuit; used for assertions and tests).

    ``pv``: the 37-felt core shard public values; ``global_sum``: the
    shard's 14-felt septic digest; ``has_cpu``: whether the proof shape
    contains the Cpu chip (static per lift program)."""
    pv = [int(x) for x in pv]
    rec = [0] * NUM_REC_PV
    _set(rec, COMMITTED_DIGEST, pv[core_pv.PV_DIGEST : core_pv.PV_DIGEST + 16])
    _set(rec, DEFERRED_DIGEST,
         pv[core_pv.PV_DEFERRED_DIGEST : core_pv.PV_DEFERRED_DIGEST + 8])
    _set(rec, START_PC, [pv[core_pv.PV_START_PC]])
    _set(rec, NEXT_PC, [pv[core_pv.PV_NEXT_PC]])
    _set(rec, EXIT_CODE, [pv[core_pv.PV_EXIT_CODE]])
    _set(rec, START_SHARD, [pv[core_pv.PV_SHARD]])
    _set(rec, NEXT_SHARD, [pv[core_pv.PV_SHARD] + 1])
    _set(rec, START_EXECUTION_SHARD, [pv[core_pv.PV_EXECUTION_SHARD]])
    _set(rec, NEXT_EXECUTION_SHARD,
         [pv[core_pv.PV_EXECUTION_SHARD] + (1 if has_cpu else 0)])
    _set(rec, CONTAINS_EXECUTION_SHARD, [1 if has_cpu else 0])
    for span, base in (
        (PREV_INIT_ADDR, core_pv.PV_PREV_INIT_ADDR),
        (LAST_INIT_ADDR, core_pv.PV_LAST_INIT_ADDR),
        (PREV_FINALIZE_ADDR, core_pv.PV_PREV_FINALIZE_ADDR),
        (LAST_FINALIZE_ADDR, core_pv.PV_LAST_FINALIZE_ADDR),
    ):
        _set(rec, span, pv[base : base + 2])
    _set(rec, CORE_VK_DIGEST, canonical_digest(core_vk.prep_root))
    _set(rec, GLOBAL_SUM, [int(x) for x in global_sum])
    return rec


def fold_records(left: list, right: list) -> list:
    """Host-side expected parent record (the in-circuit fold of
    CompressVerifierCircuit; mirrors machine/compress.rs:94-480).

    Raises AssertionError when the chain rules are violated — the circuit
    enforces the same rules with constraints.
    """
    l, r = [int(x) for x in left], [int(x) for x in right]
    rec = [0] * NUM_REC_PV
    # consistency rules (the circuit asserts these)
    assert get(l, NEXT_PC) == get(r, START_PC), "pc chain"
    assert get(l, NEXT_SHARD) == get(r, START_SHARD), "shard chain"
    assert get(l, CORE_VK_DIGEST) == get(r, CORE_VK_DIGEST), "vk digest"
    assert get(l, LAST_INIT_ADDR) == get(r, PREV_INIT_ADDR), "init addr chain"
    assert get(l, LAST_FINALIZE_ADDR) == get(r, PREV_FINALIZE_ADDR), "finalize addr chain"
    assert get(l, END_RECONSTRUCT_DEFERRED) == get(r, START_RECONSTRUCT_DEFERRED), \
        "deferred reconstruct chain"
    # digest set-once rules (reference compress.rs:330-397: every nonzero
    # element of the left digest pins elementwise equality; fold = right)
    lc, rc = get(l, COMMITTED_DIGEST), get(r, COMMITTED_DIGEST)
    if any(lc):
        assert lc == rc, "committed digest changed"
    ld, rd = get(l, DEFERRED_DIGEST), get(r, DEFERRED_DIGEST)
    if any(ld):
        assert ld == rd, "deferred digest changed"
    # execution shard rules (linearized 2-child form of compress.rs:277-315):
    #   first_seen = r_has * (1 - l_has)
    #   start_ex   = l_start_ex + first_seen * (r_start_ex - l_start_ex)
    #   next_ex    = l_next_ex + r_has * (r_next_ex - l_next_ex)
    #   constraint: l_has * r_has * (l_next_ex - r_start_ex) == 0
    l_has, r_has = get(l, CONTAINS_EXECUTION_SHARD)[0], get(r, CONTAINS_EXECUTION_SHARD)[0]
    l_start_ex = get(l, START_EXECUTION_SHARD)[0]
    l_next_ex = get(l, NEXT_EXECUTION_SHARD)[0]
    r_start_ex = get(r, START_EXECUTION_SHARD)[0]
    r_next_ex = get(r, NEXT_EXECUTION_SHARD)[0]
    if l_has and r_has:
        assert l_next_ex == r_start_ex, "execution shard chain"
    first_seen = r_has * (1 - l_has)
    start_ex = (l_start_ex + first_seen * (r_start_ex - l_start_ex)) % ff.P
    next_ex = (l_next_ex + r_has * (r_next_ex - l_next_ex)) % ff.P
    # fold
    _set(rec, COMMITTED_DIGEST, rc)
    _set(rec, DEFERRED_DIGEST, rd)
    _set(rec, START_PC, get(l, START_PC))
    _set(rec, NEXT_PC, get(r, NEXT_PC))
    _set(rec, EXIT_CODE, get(r, EXIT_CODE))
    _set(rec, START_SHARD, get(l, START_SHARD))
    _set(rec, NEXT_SHARD, get(r, NEXT_SHARD))
    _set(rec, START_EXECUTION_SHARD, [start_ex])
    _set(rec, NEXT_EXECUTION_SHARD, [next_ex])
    _set(rec, CONTAINS_EXECUTION_SHARD, [1 if (l_has or r_has) else 0])
    _set(rec, PREV_INIT_ADDR, get(l, PREV_INIT_ADDR))
    _set(rec, LAST_INIT_ADDR, get(r, LAST_INIT_ADDR))
    _set(rec, PREV_FINALIZE_ADDR, get(l, PREV_FINALIZE_ADDR))
    _set(rec, LAST_FINALIZE_ADDR, get(r, LAST_FINALIZE_ADDR))
    _set(rec, START_RECONSTRUCT_DEFERRED, get(l, START_RECONSTRUCT_DEFERRED))
    _set(rec, END_RECONSTRUCT_DEFERRED, get(r, END_RECONSTRUCT_DEFERRED))
    _set(rec, CORE_VK_DIGEST, get(l, CORE_VK_DIGEST))
    _set(rec, GLOBAL_SUM, sum_digests(get(l, GLOBAL_SUM), get(r, GLOBAL_SUM)))
    return rec


def sum_digests(dl: list, dr: list) -> list:
    """Septic digest sum: dl + (dr - START), START being the zero digest
    (machine/global_chip.START) — digests are START + partial-sum, so the
    result stays in that representation and never hits infinity for
    generic inputs."""
    from ..machine.global_chip import START

    start = ([int(c) for c in START[0]], [int(c) for c in START[1]])
    pl = (dl[:7], dl[7:])
    pr_ = (dr[:7], dr[7:])
    neg_start = (list(start[0]), [(ff.P - c) % ff.P for c in start[1]])
    d = septic.curve_add_int(pr_, neg_start)
    out = septic.curve_add_int(pl, d)
    return list(out[0]) + list(out[1])
