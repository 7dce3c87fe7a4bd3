"""The prover's shard-parallel stage over a ('shard', 'col') grid of devices.

The counterpart of the reference's ``parallel/kernels.py``, with its names
and values.  The proving workload is shard-parallel (each execution shard's
STARK is independent until the host-side transcript chain), so the grid has
two axes:

* 'shard' -- data-parallel over execution shards: shard i is dealt to row
  ``i % rows`` (reference analog: the worker pool of
  crates/core/machine/src/utils/prove.rs:157-520);
* 'col' -- over trace columns inside one shard's commit: the LDE's NTT runs
  along rows, column by column, so each device of the row extends its block
  of columns where it lies; the blocks are then copied onto the row's first
  device and row-hashed there.

The reference runs this as XLA ``shard_map`` programs over a JAX mesh with
an in-kernel duplex challenger.  Here the mesh is single-process: a grid of
``torch.device`` (which may repeat a device: ``["cpu"] * 8``, or one card
eight times), an all-gather is a copy of the blocks onto one device and a
concatenation, and the transcript is the host ``DuplexChallenger`` started
from each shard's prefix state.  Its values are those of the reference's
``absorb8`` / ``_HI`` / ``_LO`` sampling: observing an 8-felt digest is one
duplex that overwrites the rate, and each ext4 challenge reads lanes
[7, 6, 5, 4] and then [3, 2, 1, 0] of the refreshed state.  Rows whose first
devices differ run side by side in threads; rows on one device run in turn.

The protocol is the reference's, not ``prove_shard``'s open phase: one
matrix opened at zeta alone, no proof of work and no queries; the fold chain
runs from log2(H) + 1 down to 2 with one Merkle root per layer.  Poseidon2
runs through K1 (``hash_rows``) and K2 (``compress`` / ``compress_layer``)
on a CUDA device, so every commit and every fold root launches them.

Full shard proofs over several devices go through
``MipsMachine.prove(devices=...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import current
from ..ops import ext4, field as f, ntt, poseidon2 as p2, septic
from ..stark import pcs, permutation, quotient
from ..stark.challenger import DuplexChallenger
from ..stark.domain import Domain
from ..stark.machine import ChipOpenedValues
from ..utils.logger import span


def _as_int32(a) -> torch.Tensor:
    """A numpy uint32 array or an int32 tensor (any shape) as an int32
    tensor with the same bits (a CPU tensor for numpy input)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.int32)
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy())


def _tree_root(mat: torch.Tensor, plain: bool) -> torch.Tensor:
    """Merkle root (8,) of one matrix's rows, on its device: through K1 and
    K2 on a CUDA device, or with ``plain`` through their plain torch
    versions wherever the matrix lies."""
    layer = p2.hash_matrix_rows_plain(mat) if plain else p2.hash_matrix_rows(mat)
    while layer.shape[0] > 1:
        layer = p2.compress_plain(layer[0::2], layer[1::2]) if plain else p2.compress_layer(layer)
    return layer[0]


def commit_root(trace) -> torch.Tensor:
    """(H, W) Montgomery trace -> (8,) Merkle root of the blowup-2 coset LDE,
    rows bit-reversed, on the trace's device."""
    return _commit(trace, plain=False)


def _commit(trace, plain: bool) -> torch.Tensor:
    return _tree_root(ntt.coset_lde_bitrev(_as_int32(trace), log_blowup=1), plain)


def septic_identity_host(all_digests) -> bool:
    """Cross-shard septic digest identity on the gathered (S, 14) Montgomery
    digests: T = the sum of the shards' digests must equal U = S * START
    (the verifier's sum(digest_i - START) == infinity, in
    ``MipsMachine.verify``).  The chain is S sequential 14-word curve
    additions on the host, as in the reference."""
    d = _as_int32(all_digests).cpu().numpy().view(np.uint32)
    n = d.shape[0]
    xs, ys = d[:, :7], d[:, 7:]
    ax, ay = xs[0].copy(), ys[0].copy()
    for i in range(1, n):
        ax, ay = septic.curve_add(ax, ay, xs[i], ys[i])
    sx, sy = septic.START_X, septic.START_Y
    if n == 1:
        return bool(np.array_equal(ax, sx) and np.array_equal(ay, sy))
    ux, uy = septic.curve_double(sx, sy)  # 2 * START, the only addition of equal points
    for _ in range(n - 2):
        ux, uy = septic.curve_add(ux, uy, sx, sy)
    return bool(np.array_equal(ax, ux) and np.array_equal(ay, uy))


def transcript_prefix_state(pv_canonical) -> torch.Tensor:
    """A shard's transcript prefix: a fresh duplex challenger that observed
    the shard's canonical public values, with any pending felts absorbed by
    one permutation.  Returns the (16,) Montgomery sponge state (int32)."""
    ch = DuplexChallenger()
    ch.observe_slice(np.asarray(pv_canonical, dtype=np.uint32))
    if ch.input_buffer:
        ch._duplexing()
    return torch.tensor(ch.state, dtype=torch.int32)


def _challenger_at(state) -> DuplexChallenger:
    """A challenger whose sponge is ``state`` (16 Montgomery felts) with
    empty buffers: the reference's in-kernel challenger at a prefix state."""
    ch = DuplexChallenger()
    ch.state = [int(x) & 0xFFFFFFFF for x in _as_int32(state).reshape(-1).tolist()]
    return ch


def _grid(mesh) -> list:
    """The mesh as a list of equal rows of ``torch.device``."""
    rows = [[torch.device(d) for d in row] for row in (mesh.tolist() if isinstance(mesh, np.ndarray) else mesh)]
    if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
        raise ValueError("the mesh must be a non-empty 2-D grid of devices ('shard', 'col')")
    return rows


def _mesh_lde(trace: torch.Tensor, row: list) -> torch.Tensor:
    """The blowup-2 coset LDE of ``trace`` with bit-reversed rows: each
    device of ``row`` extends its block of columns, and the blocks are
    gathered onto the row's first device (the all_gather over 'col')."""
    blocks = [b for b in torch.tensor_split(trace, len(row), dim=1) if b.shape[1]]  # empty ones last
    ldes = [ntt.coset_lde_bitrev(b.to(dev), log_blowup=1) for b, dev in zip(blocks, row)]
    return torch.cat([lde.to(row[0]) for lde in ldes], dim=1)


def _openings(trace, prep, flat, doms, chunks, cum, zeta) -> ChipOpenedValues:
    """The openings of a stage's committed matrices as ``prove_shard``'s open
    phase computes them: the main, preprocessed and LogUp traces at zeta and
    zeta * g, and each quotient chunk at zeta on its own domain."""
    dom = Domain(trace.shape[0].bit_length() - 1, 1)
    pts = [zeta, dom.next_point_ext(zeta)]

    def at(mat, d, points):
        return pcs.eval_at_ext_points(ntt.ntt(mat, inverse=True), d, points)

    main, perm = at(trace, dom, pts), at(flat, dom, pts)
    pre = [None, None] if prep is None else at(prep, dom, pts)
    return ChipOpenedValues(
        preprocessed_local=pre[0], preprocessed_next=pre[1], main_local=main[0], main_next=main[1],
        perm_local=perm[0], perm_next=perm[1], quotient=[at(c, d, [zeta])[0] for d, c in zip(doms, chunks)],
        local_cumulative_sum=cum.cpu(), global_sum=None, log_degree=dom.log_n)


def _stage(chip, prep, trace, lde, root, pv, ch: DuplexChallenger, batch_size: int,
           plain: bool) -> dict:
    """Stage a and stage b of one shard on its device, with the transcript
    ``ch`` at the shard's prefix: the main ``root`` (of ``lde``) observed,
    alpha and beta, the LogUp trace and its commit, the folding challenge,
    the quotient and its commit; then the evaluations at zeta, the reduced
    vector and the fold chain.  Also returns the final sponge state and the
    challenges.  ``plain`` (the replay) hashes every tree with the plain
    Poseidon2, takes the eager LogUp trace, folds the quotient with the eager
    ``air.fold_constraints``,
    keeps the LogUp trace and the quotient chunks to the end and
    also returns the openings at zeta (``_openings``) as ``opened``."""
    dev = trace.device
    h, w = trace.shape
    log_h = h.bit_length() - 1
    log_max = log_h + 1
    ch.observe_digest(root)
    alpha, beta = ch.sample_ext(), ch.sample_ext()
    flat, cum = permutation.generate_permutation_trace(chip, prep, trace, alpha, beta, batch_size, plain)
    perm_root = _commit(flat, plain)
    ch.observe_digest(perm_root)
    ch.observe_slice(ext4.to_canonical(cum))
    alpha_q = ch.sample_ext()
    pv_monty = f.to_monty(_as_int32(pv).reshape(-1))
    doms, chunks = quotient.quotient_chunks(
        chip, trace, prep, flat, pv_monty, [alpha, beta], cum, None, alpha_q, plain=plain)
    kept = (flat, doms, chunks) if plain else None
    del flat
    q_root = _commit(torch.cat(chunks, dim=1), plain)
    del chunks
    ch.observe_digest(q_root)
    zeta, fri_alpha = ch.sample_ext(), ch.sample_ext()

    ys = pcs.eval_at_ext_point(ntt.ntt(trace, inverse=True), Domain(log_h, 1), zeta)
    apows = ext4.powers(fri_alpha.to(dev), w)
    cur = pcs._reduce_height([(lde, zeta, ys, apows)], log_max)
    fold_roots = []
    for lh in range(log_max, 1, -1):
        r = _tree_root(torch.cat([cur[0::2], cur[1::2]], dim=1), plain)  # the layer's [even | odd] rows
        fold_roots.append(r)
        ch.observe_digest(r)
        cur = pcs._fold_step(cur, ch.sample_ext(), None, lh)
    out = {
        "perm_root": perm_root, "quotient_root": q_root, "fold_roots": torch.stack(fold_roots),
        "final_poly": cur[0], "cum_sum": cum, "state": torch.tensor(ch.state, dtype=torch.int32),
        "challenges": {"alpha": alpha, "beta": beta, "alpha_q": alpha_q, "zeta": zeta,
                       "fri_alpha": fri_alpha},
    }
    if kept is not None:
        with span("replay.openings"):
            out["opened"] = _openings(trace, prep, *kept, cum, zeta)
    return out


def make_multichip_step(mesh, chip=None, prep=None, batch_size: int = 2):
    """The per-shard proving stage over a ('shard', 'col') grid of devices.

    ``mesh``: rows of ``torch.device`` (or names), one row per 'shard'
    slot, one column per 'col' slot.  Returns ``step(traces, digests,
    pvs=None, states0=None)`` with

      traces  (S, H, W)  Montgomery main traces (numpy uint32 or int32)
      digests (S, 14)    per-shard septic global digests (Montgomery)
      pvs     (S, NPV)   per-shard canonical public values (zeros of width
                         1 when None)
      states0 (S, 16)    per-shard transcript prefix states
                         (``transcript_prefix_state``; that of a zero public
                         value when None)

    and returns a dict on the mesh's first device: ``main_roots`` (S, 8)
    and the gathered ``all_digests`` (S, 14) (feed them to
    ``septic_identity_host``); with a chip also ``perm_roots``,
    ``quotient_roots`` (S, 8), ``fold_roots`` (S, log2(H), 8),
    ``final_polys`` (S, 4), ``cum_sums`` (S, 4) and the final sponge
    ``states`` (S, 16).  ``prep`` is the chip's preprocessed trace, if any.
    Every value equals the reference's (``host_stage_reference``)."""
    grid = _grid(mesh)
    gather = grid[0][0]
    prep_t = None if prep is None else _as_int32(prep)

    def shard(i: int, trace, digest, pv, state0) -> dict:
        row = grid[i % len(grid)]
        home = row[0]
        with current(home):
            lde = _mesh_lde(trace, row)
            out = {"main_root": _tree_root(lde, plain=False), "digest": digest.to(home)}
            if chip is not None:
                out.update(_stage(chip, None if prep_t is None else prep_t.to(home), trace.to(home),
                                  lde, out["main_root"], pv, _challenger_at(state0), batch_size, plain=False))
            return out

    def step(traces, digests, pvs=None, states0=None) -> dict:
        traces = _as_int32(traces)
        digests = _as_int32(digests)
        s = traces.shape[0]
        if chip is not None:
            if pvs is None:
                pvs = np.zeros((s, 1), dtype=np.uint32)
            if states0 is None:
                states0 = torch.stack([transcript_prefix_state(np.zeros(1, dtype=np.uint32))] * s)
        homes: dict = {}  # the shards of each distinct row device, proved in turn
        for i in range(s):
            homes.setdefault(grid[i % len(grid)][0], []).append(i)

        def run(idx: list) -> list:
            return [(i, shard(i, traces[i], digests[i], None if pvs is None else pvs[i],
                              None if states0 is None else states0[i])) for i in idx]

        if len(homes) == 1:
            done = run(next(iter(homes.values())))
        else:
            from ..utils.pool import make_pool

            with make_pool(len(homes)) as pool:
                done = [r for fut in [pool.submit(run, idx) for idx in homes.values()] for r in fut.result()]
        res = [r for _i, r in sorted(done, key=lambda ir: ir[0])]

        def gathered(key):
            return torch.stack([r[key].to(gather) for r in res])

        out = {"main_roots": gathered("main_root"), "all_digests": gathered("digest")}
        if chip is not None:
            out.update(perm_roots=gathered("perm_root"), quotient_roots=gathered("quotient_root"),
                       fold_roots=gathered("fold_roots"), final_polys=gathered("final_poly"),
                       cum_sums=gathered("cum_sum"), states=gathered("state"))
        return out

    return step


def host_stage_reference(chip, trace, pv, prep=None, batch_size: int = 2) -> dict:
    """Replay of ``make_multichip_step``'s per-shard protocol on one device
    (the trace's): the transcript from ``pv``, the main commit with no
    column split, no thread.  Holds the mesh step to the reference's values
    shard by shard.  Every Merkle tree (the three commits and the fold
    roots) is hashed by the plain torch Poseidon2 (``hash_matrix_rows_plain``,
    ``compress_plain``), the LogUp trace taken by the eager path and the
    quotient folded by the eager walk: on a card the replay launches no
    kernel, and so holds K1, K2, the LogUp kernels and the fold kernel at the
    step's own shapes against their plain versions.

    Also returns ``opened``, the ``ChipOpenedValues`` of the committed main,
    LogUp and quotient matrices at zeta (and zeta * g): with the
    ``challenges`` and the public values in Montgomery form, the verifier's
    ``_verify_chip_constraints`` holds the LogUp trace and the quotient to
    the chip's constraints at zeta, on a path that shares no code with
    ``permutation`` or ``quotient``."""
    trace = _as_int32(trace)
    prep = None if prep is None else _as_int32(prep).to(trace.device)
    lde = ntt.coset_lde_bitrev(trace, log_blowup=1)
    root = _tree_root(lde, plain=True)
    ch = _challenger_at(transcript_prefix_state(pv))
    return {"main_root": root, **_stage(chip, prep, trace, lde, root, pv, ch, batch_size, plain=True)}
