"""The control of the benchmark's check: the program run one guarantee short.

    python3 zkbench/control.py --workload <name> --seeds <n> [<n> ...] [--seconds 1]

Each seed is one window of the cell, as ``run.py`` makes it, after one
set-up that the seeds share, except that the program proves at half the
configuration's FRI queries (42 of 84: the cut that would tempt a change
after speed) while the check still holds every proof to the
configuration's stated parameters.  A sound check reads
``config_mismatches`` above its limit, and ``correct`` false, on every seed.
One JSON line a seed on standard output.  The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def weaken_queries(config: dict):
    """A client hook: the client's machine at half the stated queries."""
    def hook(client):
        from zkmips_tpu_torch.machine.machine import MipsMachine
        from zkmips_tpu_torch.stark.machine import StarkConfig
        from zkmips_tpu_torch.stark.pcs import FriConfig

        fri = dict(config["fri"], num_queries=config["fri"]["num_queries"] // 2)
        client.machine = MipsMachine(StarkConfig(FriConfig(**fri)), chip_airs=client.machine.airs)
    return hook


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    from zkbench import harness, spec

    import torch

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("zkbench control: no CUDA card", file=sys.stderr)
        return 2
    session = harness.Session(cell, "cuda", client_hook=weaken_queries(cell.config))
    session.warm(args.seeds[0])
    for seed in args.seeds:
        r = session.window(seed, args.seconds, False, time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "jobs": r["window"]["jobs"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
