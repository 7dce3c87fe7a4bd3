#!/usr/bin/env python3
"""Pooled against serial trace fills of one shard, on the host that drives the card.

    python3 scripts/compare_fill_pool.py [--keccak-iters 2730] [--pairs 2]

Executes ``chip_smoke.py``'s keccak-chain guest (2,730 iterations: one
2^20-cycle shard with KeccakSponge at 65,520 rows and Global at 382,412)
on the interpreter, appends the derived events once, then fills every
included chip's trace of the 49-chip machine in turns: serially (each
chip's ``generate_trace`` in the order ``prove_shard`` used before the pool:
producers, then the Byte chip) and pooled (``StarkMachine.fill_traces``, up
to 8 threads), as serial, pooled, pooled, serial for each pair.  Every run
must give the same traces, array for array.  Prints the host's CPU count,
the card (``nvidia-smi`` name and power limit, where there is one), each
run's wall and the medians.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keccak-iters", type=int, default=2730)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()

    from zkmips_tpu_torch.executor import execute_for_proving, guests
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.stark.machine import StarkConfig

    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        card = "no card"
    print(f"host: {os.cpu_count()} CPUs; {card}", flush=True)
    program = guests.keccak_chain_program(args.keccak_iters)
    t0 = time.perf_counter()
    record = execute_for_proving(program, shard_size=1 << 20)[0][0]
    m = mips_machine(StarkConfig.core())
    m.generate_dependencies(record)
    chips = [c for c in m.machine.chips if c.air.included(record)]
    print(f"{args.keccak_iters} iterations, {len(record.cpu_events)} cycles, {len(chips)} chips, "
          f"executed in {time.perf_counter() - t0:.3f} s", flush=True)

    def serial():
        order = sorted(chips, key=lambda c: bool(getattr(c.air, "trace_consumes_fills", False)))
        return {c.name: np.asarray(c.air.generate_trace(record, None), dtype=np.uint32) for c in order}

    def pooled():
        return m.machine.fill_traces(chips, record)

    walls = {"serial": [], "pooled": []}
    first = None
    for _ in range(args.pairs):
        for name, fn in (("serial", serial), ("pooled", pooled), ("pooled", pooled), ("serial", serial)):
            record.byte_lookups.pop("arrays", None)
            t0 = time.perf_counter()
            traces = fn()
            wall = time.perf_counter() - t0
            walls[name].append(wall)
            if first is None:
                first = traces
            elif traces.keys() != first.keys() or any(not np.array_equal(traces[k], first[k]) for k in first):
                raise AssertionError(f"the {name} fills gave other traces")
            print(f"fills {name}: {wall:.3f} s", flush=True)
            del traces
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"fills median: serial {med['serial']:.3f} s, pooled {med['pooled']:.3f} s, "
          f"saved {med['serial'] - med['pooled']:.3f} s; every run's traces equal [host of {card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
