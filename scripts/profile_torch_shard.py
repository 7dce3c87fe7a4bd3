#!/usr/bin/env python3
"""Where the device time of one ``prove_shard`` goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_shard.py [--log-rows 20] [--seed 0] [--top 25]
    python3 scripts/profile_torch_shard.py --mips [--fib-iters 200000]

Proves the ``chip_smoke.py`` workload (the synthetic shard, or with ``--mips``
the fib guest through ``MipsMachine.prove``, every shard) once to warm up,
then once more under ``torch.profiler`` and prints: the card (``nvidia-smi`` name and power
limit), the wall time of the profiled prove, the device time summed over
all kernels and its share of the wall time (the rest is the device idle,
waiting on the host), the Poseidon2 kernels' share, and the kernels with
the most device time.  The full table goes to
``chiprun_out/profile_shard.txt``.
With ``--mips`` the file beside it is ``profile_mips.txt``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the workload lives beside the smoke run)


def _self_device_us(ev) -> float:
    return float(ev.self_device_time_total)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-rows", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--mips", action="store_true",
                    help="profile MipsMachine.prove of the fib guest, not the synthetic shard")
    ap.add_argument("--fib-iters", type=int, default=200_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_shard: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    if args.mips:
        from zkmips_tpu_torch.executor import execute_for_proving
        from zkmips_tpu_torch.machine.machine import mips_machine
        from zkmips_tpu_torch.stark.machine import StarkConfig

        program = chip_smoke.fib_program(args.fib_iters)
        records, info = execute_for_proving(program, shard_size=chip_smoke.MIPS_SHARD_CYCLES)
        machine = mips_machine(StarkConfig.core(), minimal=True)
        pk = machine.setup(program)
        what = f"MipsMachine.prove, {info['global_clk']} cycles in {len(records)} shards"

        def prove():
            machine.prove(pk, records)
    else:
        machine = chip_smoke.build_machine()
        record, pv = chip_smoke.build_record(args.log_rows, args.seed)
        pk = machine.setup(None)
        what = f"prove_shard 2^{args.log_rows} rows"

        def prove():
            machine.prove_shard(pk, record, pv)

    prove()  # warm-up: kernel build, allocator, tables
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    # device-side events only (the kernels), so an op and its kernel are not both counted
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and _self_device_us(ev) > 0]
    kernels.sort(key=_self_device_us, reverse=True)
    device_s = sum(_self_device_us(ev) for ev in kernels) / 1e6
    p2_s = sum(_self_device_us(ev) for ev in kernels
               if "hash_rows_kernel" in ev.key or "permute_kernel" in ev.key) / 1e6
    print(f"profiled {what}: wall {wall_s:.3f} s, device busy "
          f"{device_s:.3f} s ({100 * device_s / wall_s:.1f}% of wall), Poseidon2 kernels "
          f"{p2_s:.4f} s ({100 * p2_s / wall_s:.2f}% of wall) [{card}]", flush=True)
    print("note: the profiler adds host time per op, so the wall time and idle share "
          "here are above an unprofiled run's", flush=True)
    for ev in kernels[: args.top]:
        print(f"  {_self_device_us(ev) / 1e3:10.3f} ms  x{ev.count:<6d} {ev.key[:100]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / ("profile_mips.txt" if args.mips else "profile_shard.txt")).write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=200)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
