#!/usr/bin/env python3
"""Build and run ``int_pipe_microbench.cu`` on this machine's card.

    python3 scripts/int_pipe_microbench.py

Prints the card (name and power limit), one JSON line per case (lane
operations per clock per SM) and, for each case's kernel, the machine
instructions ptxas chose for it, so that a rate is read against the opcode
that really ran.  The executable goes into the git-ignored ``build/``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from zkmips_tpu_torch.ops import poseidon2_cuda  # noqa: E402


def main() -> int:
    src = Path(__file__).with_suffix(".cu")
    exe = ROOT / "build" / "int_pipe_microbench"
    exe.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([poseidon2_cuda._nvcc(), "-gencode=arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rc = subprocess.run([str(exe)]).returncode
    for kernel, rec in (poseidon2_cuda.sass_counts(exe) or {}).items():
        print(json.dumps({"kernel": kernel, "by_op": rec["by_op"]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
