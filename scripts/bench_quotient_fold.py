#!/usr/bin/env python3
"""Time the quotient's fold kernel against the eager fold on one card.

    python3 scripts/bench_quotient_fold.py [--chips Cpu AddSub ...] [--log-h 20 20 ...]
        [--reps 5] [--no-eager] [--budgets MIB ...] [--out FILE]

For each chip of the full MIPS machine (default: the four of the fib2
benchmark guest at their fixed heights) the script makes random Montgomery
traces on the card, extends them onto the quotient domain as the prover does,
and times ``quotient.fold_chunks_kernel`` (one launch, CUDA events, the mean
of ``--reps`` after a warm launch) and ``quotient.fold_chunks_eager`` (the
node-by-node torch walk, once), checks that their chunks are equal, and
prints one JSON line per chip (also appended to ``--out``).  ``bound_ms`` is
the least time for the kernel's work on an H100 SXM, as ``chip_smoke.py``
computes it (``quotient_fold_bound``): the larger of the bytes it must move
(the LDEs read once, the chunks written once) over 3.35 TB/s and its
Montgomery products (three 32-bit multiplies each) over the 32-bit integer
multiply rate, 132 SMs x 64 lanes x 1.98 GHz.  ``--budgets`` times the
kernel again with each scratch budget (MiB) in place of ``SCRATCH_BYTES``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import FIB2_FOLD_HEIGHTS, quotient_fold_bound  # noqa: E402
from zkmips_tpu_torch.machine.machine import mips_machine  # noqa: E402
from zkmips_tpu_torch.ops import field as f, quotient_cuda  # noqa: E402
from zkmips_tpu_torch.stark import quotient, quotient_tape as qt  # noqa: E402


def _rand(shape, dev) -> torch.Tensor:
    return torch.randint(0, f.P, shape, dtype=torch.int64, device=dev).to(torch.int32)


def _ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_chip(chip, log_h: int, reps: int, eager: bool, budgets, dev) -> dict:
    h = 1 << log_h
    lqd = chip.log_quotient_degree
    main = _rand((h, chip.main_width), dev)
    prep = _rand((h, chip.preprocessed_width), dev) if chip.preprocessed_width else None
    perm = _rand((h, 4 * chip.perm_width_ext), dev)
    lde = lambda t: quotient.lde_onto_quotient_domain(t, log_h, lqd)
    main_q, prep_q = lde(main), None if prep is None else lde(prep)
    perm_q = lde(perm) if perm.shape[1] else None
    del main, prep, perm
    uniform = (_rand((64,), "cpu"), [_rand((4,), "cpu"), _rand((4,), "cpu")], _rand((4,), "cpu"),
               _rand((14,), "cpu"), _rand((4,), "cpu"))
    args = (chip, main_q, prep_q, perm_q, log_h, *uniform)
    tape = qt.chip_tape(chip)
    n = h << lqd
    got = quotient.fold_chunks_kernel(*args)  # warm: the build, the tape's copy
    torch.cuda.synchronize()
    out = {
        "chip": chip.name, "log_h": log_h, "lqd": lqd, "rows": n, "n_instr": tape.n_instr,
        "slots": [tape.n_base, tape.n_ext], "rows_in_flight": quotient_cuda.rows_in_flight(tape.n_base, tape.n_ext, n),
        "kernel_ms": _ms(lambda: quotient.fold_chunks_kernel(*args), reps),
    }
    if budgets:
        keep = quotient_cuda.SCRATCH_BYTES
        try:
            times = {}
            for mib in budgets:
                quotient_cuda.SCRATCH_BYTES = mib << 20
                times[mib] = round(_ms(lambda: quotient.fold_chunks_kernel(*args), reps), 4)
            out["kernel_ms_by_budget_mib"] = times
        finally:
            quotient_cuda.SCRATCH_BYTES = keep
    out.update(quotient_fold_bound(chip, n))
    out["roofline_pct"] = 100 * out["bound_ms"] / out["kernel_ms"]
    if eager:
        want = None

        def run():
            nonlocal want
            want = quotient.fold_chunks_eager(*args)

        out["eager_ms"] = _ms(run, 1)
        out["equal"] = all(torch.equal(g, w) for g, w in zip(got, want))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", nargs="*", default=list(FIB2_FOLD_HEIGHTS))
    ap.add_argument("--log-h", nargs="*", type=int, default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-eager", action="store_true")
    ap.add_argument("--budgets", nargs="*", type=int, default=[])
    ap.add_argument("--out", default="build/quotient_fold.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda")
    log_hs = args.log_h or [FIB2_FOLD_HEIGHTS.get(c, 16) for c in args.chips]
    chips = {c.name: c for c in mips_machine().machine.chips}
    print(json.dumps({"card": torch.cuda.get_device_name(0), "lib": quotient_cuda.build().name}), flush=True)
    for line in quotient_cuda.build().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for name, log_h in zip(args.chips, log_hs):
        res = bench_chip(chips[name], log_h, args.reps, not args.no_eager, args.budgets, dev)
        line = json.dumps(res)
        print(line, flush=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
        if res.get("equal") is False:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
