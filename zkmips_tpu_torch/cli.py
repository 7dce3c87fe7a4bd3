"""Command-line tool: the analog of cargo-ziren (crates/cli) plus the remote
prover service's entry point.  The counterpart of the reference's ``cli.py``.

  python -m zkmips_tpu_torch.cli execute  <guest.elf> [--stdin-hex ...]
  python -m zkmips_tpu_torch.cli prove    <guest.elf> -o proof.bin [--config test]
                                          [--mode core|compressed|groth16]
                                          [--endpoint http://host:port]
  python -m zkmips_tpu_torch.cli verify   <guest.elf> proof.bin
  python -m zkmips_tpu_torch.cli vkey     <guest.elf>
  python -m zkmips_tpu_torch.cli serve    [--port 9090] [--host 127.0.0.1] [--config core]
  python -m zkmips_tpu_torch.cli warmup   [--quick]   build the native and CUDA
                                          libraries and prove the shape corpus
  python -m zkmips_tpu_torch.cli solidity-verifier <groth16_vk.bin> [-o out.sol]
                                          render the on-chain Groth16 verifier

Every subcommand that proves or sets up runs on ``--device`` (default
``cuda``; ``cpu`` or ``cuda:N`` otherwise) and raises when that device is
CUDA and there is no GPU.  ``prove --endpoint`` proves on a remote
``serve``, on its device and at its config, and takes neither here.  ``--shapes`` forces fixed-shape
padding (on by default at the core config).  ``verify`` and ``warmup`` exit
with 1 when a proof is rejected or a guest fails.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkmips")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("execute", "prove", "verify", "vkey", "serve", "warmup", "solidity-verifier"):
        c = sub.add_parser(name)
        if name not in ("serve", "warmup", "solidity-verifier"):
            c.add_argument("elf")
        if name == "solidity-verifier":
            c.add_argument("vk_bin", help="gnark-format Groth16 vk bytes")
            c.add_argument("-o", "--output", default="ZKMVerifier.sol")
        if name == "prove":
            c.add_argument("-o", "--output", default="proof.bin")
            c.add_argument("--mode", default="core", choices=["core", "compressed", "groth16"])
            c.add_argument("--endpoint", default=None, help="remote prover service URL")
        if name == "verify":
            c.add_argument("proof")
        if name == "serve":
            c.add_argument("--port", type=int, default=9090)
            c.add_argument("--host", default="127.0.0.1")
        if name == "warmup":
            c.add_argument("--quick", action="store_true",
                           help="small workloads only (skip the full-shard guests)")
        c.add_argument("--stdin-hex", action="append", default=[], help="hint buffer (hex)")
        c.add_argument("--config", default=None, choices=["core", "test"],
                       help="FRI parameter set (default core; prove --endpoint proves at the server's)")
        c.add_argument("--device", default="cuda", help="device to set up and prove on (cuda, cuda:N, cpu)")
        c.add_argument("--shapes", action="store_true", help="fixed-shape padding")
    args = ap.parse_args(argv)

    from .sdk import ProverClient, ZKMStdin
    from .sdk.client import ProofWithPublicValues, load_elf
    from .stark.machine import StarkConfig

    config = StarkConfig.test() if args.config == "test" else StarkConfig.core()

    def local_client():
        from .device import resolve_device
        from .machine.machine import MipsMachine

        client = ProverClient.new(config=config, device=resolve_device(args.device))
        if args.shapes:
            client.machine = MipsMachine(config, use_shapes=True)
        return client

    if args.cmd == "warmup":
        return _warmup(config, args.device, quick=args.quick)

    if args.cmd == "solidity-verifier":
        from .verifier.solidity import render_groth16_verifier

        with open(args.vk_bin, "rb") as fh:
            src = render_groth16_verifier(fh.read())
        with open(args.output, "w") as fh:
            fh.write(src)
        print(f"wrote {args.output} ({len(src):,} bytes)")
        return 0

    if args.cmd == "serve":
        from .sdk.network import ProverServer

        server = ProverServer(client=local_client(), host=args.host, port=args.port)
        print(f"prover service listening on http://{args.host}:{server.port}", flush=True)
        try:
            server.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0

    program = load_elf(args.elf)
    stdin = ZKMStdin()
    for h in args.stdin_hex:
        stdin.write_bytes(bytes.fromhex(h))

    if args.cmd == "execute":
        rep = ProverClient.new(config=config).execute(program, stdin)
        print(f"cycles={rep.total_instruction_count} exit={rep.exit_code}")
        if rep.public_values:
            print("public_values:", rep.public_values.hex())
        return 0
    if args.cmd == "prove" and args.endpoint:
        if args.config is not None:
            ap.error("prove --endpoint proves at the server's config: --config does not apply")
        client = ProverClient.new(backend="network", endpoint=args.endpoint)
    else:
        client = local_client()
    if args.cmd == "vkey":
        _pk, vk = client.setup(program)
        root = vk.prep_root
        print("vk:", "-".join(f"{int(x):08x}" for x in root) if root is not None else "(no preprocessed)")
        return 0
    if args.cmd == "prove":
        pk, _vk = client.setup(program)
        proof = client.prove(pk, program, stdin, mode=args.mode)
        proof.save(args.output)
        print(f"proof written to {args.output} ({proof.size_bytes():,} bytes)")
        return 0
    if args.cmd == "verify":
        from .stark.machine import VerificationError
        from .verifier.stark_codec import CodecError

        _pk, vk = client.setup(program)
        try:
            ok = client.verify(vk, ProofWithPublicValues.load(args.proof), program)
        except (VerificationError, CodecError) as e:
            print(f"verification: FAILED ({e})")
            return 1
        print("verification:", "OK" if ok else "FAILED")
        return 0 if ok else 1
    return 1


def _warmup(config, device, quick: bool = False) -> int:
    """Build what the port compiles on first use -- the Poseidon2 kernels
    (``csrc/poseidon2.cu``, on a CUDA device), the trace executor, the
    recursion runtime and the BN254 library -- into ``build/``, then prove
    and verify each guest of ``shape_gen.corpus_programs()`` on ``device``
    (``quick``: without the fib200000 and keccak_chain12000 guests).  A
    failed guest is reported and the rest still run; the exit code is then
    1."""
    import time

    from .device import resolve_device
    from .executor import execute_for_proving, native_trace
    from .machine import shape_gen
    from .machine.machine import MipsMachine
    from .ops import bn254_native
    from .recursion import native_runtime
    from .utils.cbuild import build

    dev = resolve_device(device)
    t0 = time.perf_counter()
    libs = [native_trace.library(), build(native_runtime._SRC), build(bn254_native._SRC, ("-fopenmp",))]
    if dev.type == "cuda":
        from .ops import poseidon2_cuda

        libs.insert(0, str(poseidon2_cuda.build()))
    for lib in libs:
        print(f"built {lib}", flush=True)
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)

    progs = [(n, p) for n, p in shape_gen.corpus_programs()
             if not quick or ("200" not in n and "12_000" not in n and "12000" not in n)]
    m = MipsMachine(config)
    failed = []
    for name, prog in progs:
        t0 = time.perf_counter()
        try:
            records, _ = execute_for_proving(prog, shard_size=1 << 20)
            pk = m.setup(prog, device=dev)
            proofs = m.prove(pk, records, device=dev)
            if not m.verify(pk.vk, proofs, prog):
                raise AssertionError("the proofs were not accepted")
            print(f"warm {name}: {time.perf_counter() - t0:.1f}s ({len(proofs)} shards)", flush=True)
        except Exception as e:  # warm the rest; the exit code reports it
            failed.append(name)
            print(f"warm {name}: FAILED ({e!r})", flush=True)
    if failed:
        print(f"warmup: {len(failed)} of {len(progs)} guests failed: {', '.join(failed)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
