#!/usr/bin/env python3
"""Compare versions of the Poseidon2 CUDA source on one card, in one process.

    python3 scripts/bench_poseidon2_sources.py [SOURCE.cu ...] [--out FILE] [--sass-dir DIR]

Each source (default: the package's own ``csrc/poseidon2.cu``) must export
the C interface that ``zkmips_tpu_torch/ops/poseidon2_cuda.py`` binds.  For
each one the script builds it, prints the compiler's register and spill
lines and the machine instructions per kernel, holds all three kernels bit
for bit against the plain torch versions (edge vectors and random words),
and times them at the prover's shapes: ``hash_rows`` at (2^21, 85),
``compress_layer`` at 2^20 pairs, ``permute`` at 2^18 states.  The sources
are timed in turns, forwards then backwards, so that a drifting clock shows
as a difference between a source's two times.  One JSON line per source,
also appended to ``--out`` (default ``build/poseidon2_sources.jsonl``);
``--sass-dir`` keeps each source's whole disassembly there.  All sources are
compiled at once, one ``nvcc`` each.

To compare the working tree with an earlier commit, extract that commit's
source first:  ``git show REV:zkmips_tpu_torch/csrc/poseidon2.cu > build/REV.cu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from zkmips_tpu_torch.ops import poseidon2 as p2, poseidon2_cuda as k  # noqa: E402


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Bound:
    """One built version of the source behind its own library handle: the
    package's wrappers, and the handle they use, stay as they are."""

    def __init__(self, lib_path: Path):
        self.lib = k.load(lib_path)
        rc = p2.kernel_constants()  # kept alive until the copy has been made
        self._call(self.lib.zkm_p2_set_constants, rc.ctypes.data)

    def _call(self, fn, *args):
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA error {err} ({self.lib.zkm_p2_error_string(err).decode()})")

    def _launch(self, fn, out: torch.Tensor, *args) -> torch.Tensor:
        self._call(fn, *args, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        return out

    def hash_rows(self, mat: torch.Tensor) -> torch.Tensor:
        n, w = mat.shape
        return self._launch(self.lib.zkm_p2_hash_rows, mat.new_empty((n, 8)), mat.data_ptr(), n, w)

    def compress(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        n = left.shape[0]
        return self._launch(self.lib.zkm_p2_compress, left.new_empty((n, 8)),
                            left.data_ptr(), right.data_ptr(), left.stride(0), n)

    def compress_layer(self, layer: torch.Tensor) -> torch.Tensor:
        return self.compress(layer[0::2], layer[1::2])

    def permute(self, states: torch.Tensor) -> torch.Tensor:
        return self._launch(self.lib.zkm_p2_permute, torch.empty_like(states), states.data_ptr(), states.shape[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=[str(k.SOURCE)])
    ap.add_argument("--out", default="build/poseidon2_sources.jsonl")
    ap.add_argument("--sass-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_poseidon2_sources: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def field(shape):
        return torch.from_numpy(rng.integers(0, p2._p, size=shape, dtype=np.int64).astype(np.int32)).to(dev)

    # inputs and the plain versions' answers, once for all sources
    hash_cases = [torch.from_numpy(p2.edge_matrix(w, 100 + w, 503).astype(np.int32)).to(dev) for w in (1, 8, 13, 85)]
    hash_cases += [field((1000, 21)), field((4096, 63))]
    hash_want = [p2.hash_matrix_rows_plain(m) for m in hash_cases]
    states = torch.cat([
        torch.from_numpy(p2.edge_matrix(16, 116, 4087).astype(np.int32)).to(dev), field((1 << 16, 16))])
    states_want = p2.permute_plain(states)
    big, grind = field((1 << 21, 85)), field((1 << 18, 16))
    big_want = p2.hash_matrix_rows_plain(big)
    level_want = p2.compress_plain(big_want[0::2], big_want[1::2])

    results = {}
    sources = [Path(s) for s in args.sources]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(k.build, sources))
    print(f"built {len(sources)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
    bound = {str(src): Bound(lib) for src, lib in zip(sources, libs)}
    for src, lib in zip(sources, libs):
        b = bound[str(src)]
        rec = results[str(src)] = {"source": str(src), "card": card, "ms": {}}
        rec["ptxas"] = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
        rec["sass"] = k.sass_counts(lib)
        if args.sass_dir:
            Path(args.sass_dir).mkdir(parents=True, exist_ok=True)
            (Path(args.sass_dir) / f"{src.stem}.sass").write_text(k.disassemble(lib) or "")
        bad = [f"hash_rows {tuple(m.shape)}" for m, want in zip(hash_cases, hash_want)
               if not torch.equal(b.hash_rows(m), want)]
        got = b.permute(states)
        if not torch.equal(got, states_want):
            bad.append(f"permute: {int((got != states_want).any(dim=1).sum())} of {states.shape[0]} rows")
        halves = states[:, :8].contiguous(), states[:, 8:].contiguous()
        if not torch.equal(b.compress(*halves), states_want[:, :8]):
            bad.append("compress")
        if not torch.equal(b.compress_layer(states.view(-1, 8)), states_want[:, :8]):
            bad.append("compress_layer")
        leaves = b.hash_rows(big)
        if not torch.equal(leaves, big_want):
            bad.append("hash_rows (2^21, 85)")
        if not torch.equal(b.compress_layer(leaves), level_want):
            bad.append("compress_layer 2^20 pairs")
        rec["disagrees"] = bad
        print(f"{src}: {'bit-exact' if not bad else 'DISAGREES: ' + '; '.join(bad)}", flush=True)

    for src in sources + sources[::-1]:
        b = bound[str(src)]
        ms = results[str(src)]["ms"]
        for name, fn, reps in (("hash_rows", lambda: b.hash_rows(big), 5),
                               ("compress", lambda: b.compress_layer(big_want), 20),
                               ("permute", lambda: b.permute(grind), 20)):
            ms.setdefault(name, []).append(cuda_ms(fn, reps))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as fh:
        for rec in results.values():
            line = json.dumps(rec)
            print(line, flush=True)
            fh.write(line + "\n")
    return 1 if any(r["disagrees"] for r in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
