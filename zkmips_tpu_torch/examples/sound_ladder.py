"""Run the FULL sound ladder once and record wall times + artifact sizes.

core(84q/16bit) -> compress(84q) -> shrink(blowup2/42q) -> wrap(outer 4/21)
-> Groth16 (and optionally PLONK) on a real compiled guest — the reference's
test_e2e_prover (crates/prover/src/lib.rs:1269) at production parameters.

The core and recursion proofs run on the CUDA card (``--cpu``: on the CPU);
the SNARK is host code.  Artifact sizes are the port's proof bytes
(``verifier.stark_codec``) and the Groth16 proof's bytes.

Usage: python -m zkmips_tpu_torch.examples.sound_ladder [--plonk] [--elf PATH] [--cpu]
Prints one JSON line per stage and a final summary JSON.
"""

import argparse
import json
import os
import time

from ..device import resolve_device
from ..executor import execute_for_proving
from ..executor.program import Program
from ..machine.machine import MipsMachine
from ..recursion.compress import RecursionProver
from ..snark.outer_circuit import verify_groth16, verify_plonk, wrap_groth16, wrap_plonk
from ..stark.machine import StarkConfig
from ..verifier import encode_groth16_proof, stark_codec

# the upstream project's compiled guest, relative to a checkout of it
REF_ELF = "crates/prover/elf/mipsel-zkm-zkvm-elf"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plonk", action="store_true")
    ap.add_argument("--elf", default=REF_ELF)
    ap.add_argument("--cpu", action="store_true", help="prove on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    stages = {}

    def timed(name, fn, *a, **kw):
        t0 = time.time()
        out = fn(*a, **kw)
        stages[name] = round(time.time() - t0, 2)
        print(json.dumps({"stage": name, "wall_s": stages[name]}), flush=True)
        return out

    with open(args.elf, "rb") as fh:
        program = Program.from_elf(fh.read())
    records, info = execute_for_proving(program)
    cycles = info["global_clk"]
    print(json.dumps({"stage": "execute", "cycles": cycles}), flush=True)

    m = MipsMachine(StarkConfig.core())
    pk = timed("setup", m.setup, program, device=dev)
    core_proofs = timed("prove_core", m.prove, pk, records, device=dev)
    assert timed("verify_core", m.verify, pk.vk, core_proofs, program)
    sizes = {"core": len(stark_codec.encode_core_proof(core_proofs))}

    rp = RecursionProver(m)
    cp = timed("compress", rp.compress, pk.vk, core_proofs, device=dev)
    assert rp.verify_compressed(pk.vk, program, cp)
    sizes["compressed"] = len(stark_codec.encode_compressed_proof(cp))

    sp = timed("shrink", rp.shrink, cp, device=dev)
    wp = timed("wrap", rp.wrap, sp, device=dev)
    sizes["wrapped"] = len(stark_codec.encode_compressed_proof(wp))

    wg = timed("groth16", wrap_groth16, rp, wp)
    sizes["groth16_proof_bytes"] = len(encode_groth16_proof(wg.proof))
    assert timed("verify_groth16", verify_groth16, pk.vk, program, wg)

    if args.plonk:
        wpl = timed("plonk", wrap_plonk, rp, wp)
        assert timed("verify_plonk", verify_plonk, pk.vk, program, wpl)

    summary = {
        "summary": "sound_ladder",
        "elf": os.path.basename(args.elf),
        "cycles": cycles,
        "stages_s": stages,
        "artifact_bytes": sizes,
        "total_s": round(sum(stages.values()), 2),
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
