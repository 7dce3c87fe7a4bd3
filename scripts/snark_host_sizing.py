#!/usr/bin/env python3
"""Size the SNARK link on the host, without a card.

    python3 scripts/snark_host_sizing.py [--iters N] [--plonk]

Proves the fib guest of the reference's MIPS -> SNARK test at the test
config (``--iters`` iterations, default 25: two shards of 128 cycles) on
the CPU through ``ProverClient``'s ladder (core, compress, shrink, wrap),
then builds the outer verifier circuit of the wrap proof and prints its
size (constraints, variables, PLONK gates and domain) and, for Groth16
(and with ``--plonk`` for PLONK), the seconds of each ``snark.*`` stage and
the process's resident memory after each.  Every figure is host time and
host memory: no device number comes from this script.
"""

from __future__ import annotations

import argparse
import json
import random
import resource
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def rss_gib() -> dict:
    with open("/proc/self/status") as fh:
        now = next(int(line.split()[1]) for line in fh if line.startswith("VmRSS:"))
    return {"now": round(now / 2**20, 3),
            "peak": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 3)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--plonk", action="store_true", help="also set up and prove PLONK (hours, tens of GiB)")
    args = ap.parse_args()

    from zkmips_tpu_torch.executor import Opcode as O, Register as R, asm
    from zkmips_tpu_torch.sdk import ProverClient, ZKMStdin
    from zkmips_tpu_torch.snark import groth16, outer_circuit, plonk
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.utils import logger

    body = [
        asm.addi(R.A0, 0, args.iters), asm.addi(R.T0, 0, 0), asm.addi(R.T1, 0, 1),
        asm.alu(O.ADD, R.T2, R.T0, R.T1), asm.alu(O.ADD, R.T0, R.T1, R.ZERO),
        asm.alu(O.ADD, R.T1, R.T2, R.ZERO), asm.addi(R.A0, R.A0, -1),
        asm.branch(O.BNE, R.A0, R.ZERO, -5 * 4), asm.nop(),
    ]
    program = asm.prog(body + asm.halt_sequence())
    client = ProverClient(config=StarkConfig.test(), device="cpu")
    t0 = time.perf_counter()
    pk, vk = client.setup(program)
    cp = client.prove(pk, program, ZKMStdin(), shard_size=128, mode="compressed").proofs[0]
    rp = client._recursion_prover()
    wrapped = rp.wrap(rp.shrink(cp, device="cpu"), device="cpu")
    out = {"ladder_seconds": round(time.perf_counter() - t0, 3), "shards": cp.num_shards}

    logger.configure(enabled=True, echo=True)
    circ, _key = outer_circuit._outer_circuit(rp, wrapped)
    out["constraints"], out["variables"] = len(circ.cs.constraints), len(circ.cs.values)
    out["rss_after_circuit_gib"] = rss_gib()
    with logger.span("snark.gates"):
        gates = plonk.gates_from_r1cs(circ.cs)
    out["gates"], out["plonk_domain"] = gates.num_gates, plonk._domain_size(gates)
    out["rss_after_gates_gib"] = rss_gib()
    gen = random.Random(0)

    def rng(n):
        return gen.randrange(n)

    with logger.span("snark.setup"):
        g16_pk, g16_vk = groth16.setup(circ.cs, rng=rng)
    with logger.span("snark.prove"):
        proof = groth16.prove(g16_pk, circ.cs, rng=rng)
    with logger.span("snark.verify"):
        assert groth16.verify(g16_vk, proof, circ.packed_pv)
    out["rss_after_groth16_gib"] = rss_gib()
    del g16_pk
    if args.plonk:
        with logger.span("snark.plonk_setup"):
            p_pk, p_vk = plonk.setup(gates, rng=rng)
        with logger.span("snark.plonk_prove"):
            p_proof = plonk.prove(p_pk, gates, rng=rng)
        assert plonk.verify(p_vk, p_proof, circ.packed_pv)
        out["rss_after_plonk_gib"] = rss_gib()
    out["seconds"] = {k: round(v[0], 3) for k, v in logger.spans_report().items() if k.startswith("snark.")}
    print("snark host sizing (CPU): " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
