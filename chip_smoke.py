#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--log-rows K] [--fib-iters N] [--stream-fib-iters N]
                          [--keccak-iters N] [--ladder-fib-iters N]
                          [--only-kernels | --only-full | --only-recursion | --only-snark [--plonk-full]
                           | --only-sdk {groth16,plonk} | --only-mesh | --only-network | --only-cli
                           | --only-examples NAME [NAME ...]]

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the Poseidon2 CUDA kernels from ``zkmips_tpu_torch/csrc`` and
   prints what the compiler made of them: registers and spills (``ptxas``)
   and the machine instructions of each kernel (``sass``, by opcode);
3. holds every kernel bit for bit against its plain torch version on the
   card, first at edge vectors (the field's ends, middle and powers of two),
   then at the shapes the prover gives them, and times both there;
   ``--only-kernels`` stops here, after the ``kernels`` line, with exit
   code 0 and without the last line;
4. proves one STARK shard at the core FRI config (blowup 2, 84 queries,
   16 PoW bits) through ``StarkMachine.setup`` / ``prove_shard`` on the card
   and checks it with ``verify_shard``, then requires a tampered proof to
   be rejected; the shard's chips have the widths of the largest chips of a
   2^20-cycle core shard (Cpu-, AddSub- and Byte-shaped, see below), with
   traces made from ``--seed``, 2^``--log-rows`` rows (default 2^18);
5. proves a small shard of the same chips on the card and on the CPU and
   requires the two proofs to be equal field by field;
6. the fib phase: assembles the fib guest (``--fib-iters`` iterations,
   default 60,000, about 360,000 cycles), builds the native trace executor
   from ``csrc/trace_executor.c`` and runs the guest in 2^18-cycle shards
   (two shards), proves every shard with ``MipsMachine.prove`` at the core
   config on the card (fifteen-chip minimal machine, fixed shapes), and
   checks the proofs, the shard chain and the septic digest sum with
   ``MipsMachine.verify``; a flipped word of a global digest and two
   swapped proofs must be rejected; the same guest streamed
   (``stream_for_proving`` -> ``MipsMachine.prove_streaming``) must give
   the batch proofs byte for byte through the port's codec; a small fib
   proved on the card and on the CPU must give equal proofs;
7. the streaming phase, at full size: the fib guest (``--stream-fib-iters``
   iterations, default 200,000, about 1,200,000 cycles: two 2^20-cycle
   shards) streamed from the native executor into ``prove_streaming`` (one
   worker, pooled trace fills) on the card with the 49-chip machine at the
   core config; the proofs are encoded by the port's ``encode_core_proof``
   and ``encode_vk`` and accepted by ``verify_core`` on the bytes, and a
   flipped byte must be rejected; the kernels' launches over this prove are
   printed.  Then a small keccak chain with two execution shards and a
   deferred one is proved in batch and streamed with one and two workers:
   the bytes must be equal.  Then the synthetic shard of step 4 at the
   KoalaBear recursion configs (``FriConfig.compressed`` and
   ``ultra_compressed``, log blowup 2 and 3): proved on the card at 2^16
   rows and verified, a tampered proof rejected, and at 2^13 rows the
   card's proof must equal the CPU's;
8. the full-machine phase, at full size: the keccak-chain guest of
   ``bench.py`` (``--keccak-iters`` iterations, default 1,365: 32,760
   KeccakSponge rows, about 79,000 cycles in one 2^20-cycle shard) runs
   through ``execute_for_proving`` (the Python interpreter: the native
   executor has no precompiles), is proved by ``mips_machine()`` (the 49
   chips, core config, fixed shapes) on the card and verified; a flipped
   word of KeccakSponge's opened values must be rejected; K1 is held
   against its plain version at the widest leaf shape this prove gave it.
   The kernels' launch counts of the ``kernels`` line are those of this
   prove; each shard's pooled trace fills are printed in thread seconds
   beside the wall of ``prove.trace_gen``.  Then (in the whole run, in the
   side process of step 14) the six fixture ELFs of ``tests/fixtures/guests`` are
   loaded, executed, proved on the card at the core config and verified;
   and a guest that gives every one of the 49 chips rows is proved at the
   test config on the card and on the CPU, and the two proofs must be equal.
   ``--only-full`` runs the card line, the build and this phase alone
   (exit code 0, no ``kernels`` line and no last line);
9. the recursion phase, at full width: the fib guest (``--ladder-fib-iters``
   iterations, default 180,000: two 2^20-cycle shards) proved by the
   49-chip machine at the core config, then each shard lifted, the pair
   joined by a compress program, shrunk (log blowup 2, 42 queries) and
   wrapped (the BN254 outer config: log blowup 4, 21 queries, 16 PoW bits)
   by ``RecursionProver`` on the card; every stage is accepted by
   ``verify_compressed`` before and after its bytes
   (``encode_compressed_proof``) are decoded; a flipped byte and a tampered
   public value of the final record must be rejected.  Each stage prints
   its parts (circuit build, setup, execute on the C runtime, fills,
   prove), the recursion proofs' chip heights, peak device memory, proof
   bytes and the kernels' launches (the wrap's BN254 Merkle hashing and
   grind run on the host, in C and Python, as in the reference).  Then, at
   the test config, a two-shard guest's lifts and compress pair proved on
   the card and on the CPU must give equal bytes, and the deferred chain
   (guest A compressed, guest B verifying it in the VM,
   ``prove_deferred`` -> ``verify_deferred``) runs on the card.
   ``--only-recursion`` runs the card line, the build and this phase alone
   (exit code 0, no ``kernels`` line and no last line).  ``--only-snark``
   runs the ladder (without the CPU process, the small ladder and the
   deferred chain) and then the SNARK link over the ladder's own
   full-width wrap proof: ``wrap_groth16`` (what
   ``ProverClient.prove(mode="groth16")`` calls after the wrap: the outer
   verifier circuit built as an R1CS on the host, Groth16 setup and prove
   with ``csrc/bn254.c``'s MSMs and FFTs) and ``verify_groth16``, then
   every byte API (``check_groth16_bytes``), printing ``snark groth16
   (full width):`` with the constraint and variable counts, the
   ``snark.*`` spans' seconds (circuit, setup, prove, verify), the bytes,
   the host's resident memory and the kernels' launches (zero: host code).
   It takes about 23 minutes, so it is not part of the whole run.  With
   ``--plonk-full`` it proves PLONK over that wrap proof instead, and stops
   before setup when the packed prover would not fit the host's memory;
   each stage's seconds are printed on stderr as it ends;
   Except under ``--only-snark``, the recursion phase also proves the
   ladder's two core shards with ``MipsMachine.prove(devices=...)`` over
   every visible card, at least two entries (``cuda:0`` twice on one card):
   the bytes must equal the single-device proofs; with two cards or more
   K1 is also launched on ``cuda:1`` from a thread whose current device is
   0 and held against its plain version (on one card this is printed as
   not exercised);
10. the SDK phase: ``ProverClient(config=StarkConfig.test())`` proves the
   e2e fib guest (two shards of 128 cycles) with ``mode="groth16"`` on the
   card (core, lift, compress, shrink, wrap on the card; Groth16 over the
   outer circuit on the host), verifies it and its container bytes, and
   puts the proof through every byte API: ``Groth16Verifier`` on the proof
   and vk bytes, the wrapped container, ``ProverClient.verify`` on the
   ``ProofWithPublicValues`` bytes, the vk and proof in gnark's wire format
   through ``verify_gnark_groth16_algebraic``, ``verify_gnark_groth16``
   and the Solidity verifier on a circuit of gnark's two public inputs
   (constants checked); a wrong public input, a flipped proof byte, a
   flipped gnark flag bit and a tampered wrap public value must be
   rejected.  ``--only-sdk groth16|plonk`` runs this phase alone in either
   mode;
11. the mesh phase, at full width: the fib guest (600,000 iterations:
   four 2^20-cycle shards) run by the native executor, the
   Cpu chip's traces at 2^20 rows with the Global chip's digests and each
   shard's public values; ``parallel.kernels.make_multichip_step`` over a
   4 x 2 ('shard', 'col') grid of the visible cards (``cuda:0`` eight times
   on one card); every output must equal ``host_stage_reference`` on the
   card, shard by shard, a replay whose Merkle trees are hashed by the
   plain torch Poseidon2 (no kernel launched), so that K1 and K2 at the
   step's own shapes are held against their plain versions;
   ``septic_identity_host`` must accept the gathered
   digests and reject a tampered word; K1 and K2 must be launched; each
   part's seconds, peak memory and launches are printed.  At 64-cycle
   shards, on the Branch and Cpu chips, the card's step must equal the CPU
   process's.  ``--only-mesh`` runs it alone;
12. the network phase: a ``ProverServer`` at the core config and one at the
   test config on the card, in background threads, with
   ``ZKM_NETWORK_KEY`` set; the client in a subprocess with
   ``CUDA_VISIBLE_DEVICES=""`` (``--network-client``): ``/setup`` and
   ``/prove_core`` of a fib (two 2^17-cycle shards) whose bytes must equal
   the local proofs; at the test config ``/prove``, ``/verify``, then
   ``/prove_core`` -> ``/compress`` -> ``/shrink`` -> ``/wrap``; a failing
   job must raise on the client and an unsigned POST must get 403.
   ``--only-network`` runs it alone;
13. the CLI phase, beside the network phase: subprocesses of ``python3 -m
   zkmips_tpu_torch.cli`` on a fixture ELF, all at once: ``execute``,
   ``vkey`` and ``prove`` at the core config (the lines and the proof's
   bytes checked against the client in this process), ``verify`` of that
   client's proof and of it with one flipped byte (exit code 1), ``prove
   --config test --mode compressed``, ``serve`` with ``prove --endpoint``,
   and ``solidity-verifier`` on the SDK phase's gnark vk bytes (the source
   must be the one rendered in this process).  ``--only-cli`` runs it alone with
   ``warmup --quick`` beside it and a vk made of fixed curve points; the
   warmup must fail on exactly the corpus's ``mixed30k`` guest and exit 1
   (ROADMAP.md queue 3: that guest's DIVU is not one the DivRem chip
   proves, in either package);
14. the examples phase: the twelve quick programs of
   ``zkmips_tpu_torch/examples`` (the counterparts of ``examples/*.py``),
   each called through its ``main`` at the test config on the card, with
   the example's own assertions (``real_guest`` on a fixture ELF); each
   prints a line with its wall, peak device memory, the kernels' launches
   (counted from 0 for it) and what it returned, and the phase a summary
   line.  ``fibonacci``'s proof bytes must equal the CPU process's.  In the
   whole run this phase, with the ELFs and the every-chip guest of step 8,
   runs in a side process of this script that starts as the ladder's wrap
   starts (from there the main process is mostly host code: the wrap's
   BN254 hashing, the SDK phase's SNARK) and is waited for after the SDK
   phase; its lines are printed then.
   ``--only-examples NAME ...`` runs the card line, the build and the named
   examples alone, the ladder's too (``compressed``, ``aggregation``,
   ``groth16``, ``plonk``, ``sound_ladder`` on a fixture ELF; ``plonk``
   stops before proving when the host's memory is too small);
15. prints one JSON line with every kernel's record (``{"kernels": [...]}``,
   with the ladder's launches per stage, the SNARK's, the placed prove's
   and the mesh step's) and, last, ``{"ok": true, "device": {...}}``.

The CPU halves of the card = CPU checks (the small mesh steps, the small
shard, the small fib, the recursion configs, the every-chip guest, the
small ladder) run in a
second process of this script, started after the card line, while the
card runs its phases; each phase waits for its CPU proof's bytes and
compares them with the card's, and the process's times are printed before
the ``kernels`` line; after its first two results it lowers its priority
(``nice``), so that the card's phases' host work goes first.  The process
is waited for (or stopped, after an ``--only-*`` part or a failure) before
the script exits, as is the side process of step 14.

It exits non-zero, without the last line, when there is no CUDA device,
when the package is missing, or when any phase fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

P = 0x7F000001
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # CUDA-core float32 rate, the table's non-tensor entry
# 132 SMs x 64 INT32 lanes x 1.98 GHz (Hopper white paper): the rate at which
# the card can issue the 32-bit integer multiplies the kernels are made of
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Montgomery products a permutation needs, x 32-bit multiplies each: the
# s-box x^3 is two products, on 16 lanes in each of 8 external rounds and on
# lane 0 in each of 13 internal rounds; the internal diagonal needs none
MULS_PER_PERM = (8 * 16 * 2 + 13 * 2) * 3

# --- the workload -------------------------------------------------------------
#
# Byte ops of the table chip: result of op k on bytes (x, y); op 8 is a
# plain range check with result 0.
BYTE_OPS = [
    lambda x, y: x & y,
    lambda x, y: x | y,
    lambda x, y: x ^ y,
    lambda x, y: (x + y) & 0xFF,
    lambda x, y: (x + y) >> 8,
    lambda x, y: (x < y).astype(np.uint32),
    lambda x, y: (x << (y & 7)) & 0xFF,
    lambda x, y: x >> (y & 7),
    lambda x, y: np.zeros_like(x),
]
N_BYTE_OPS = len(BYTE_OPS)
FIB_SHARD_CYCLES = 1 << 18  # the shard size of the fib phase
FULL_SHARD_CYCLES = 1 << 20  # the shard size of the full-machine phase
KECCAK_SPLIT_THRESHOLD = 1 << 17  # rows of a precompile family kept in one deferred shard
DEFAULT_SPLIT_THRESHOLD = 1 << 15  # the reference's SPLIT_THRESHOLD default
SMALL_KECCAK_ITERS = 50  # the streamed-equals-batch keccak chain: 1,200 KeccakSponge rows
SMALL_KECCAK_SHARD = 1 << 11  # cycles a shard: two execution shards
# rows of a family a record may keep: shard 1's 32 sponge calls (768 rows)
# go to one deferred shard, shard 2 keeps its 18
SMALL_KECCAK_SPLIT = 768
RECURSION_CONFIGS = ("compressed", "ultra_compressed")  # FriConfig log blowup 2 and 3
RECURSION_LOG_ROWS = 16  # the synthetic shard proved at them on the card
RECURSION_CPU_LOG_ROWS = 13  # the synthetic shard proved at them on card and CPU
FIXTURES = "tests/fixtures/guests"  # the compiled guests, relative to this script
ROOT = os.path.dirname(os.path.abspath(__file__))
# io_hints_commit reads two little-endian u32 words from stdin
IO_HINTS_STDIN = [(0x12345678).to_bytes(4, "little"), (0x0F0F0F0F).to_bytes(4, "little")]
CPU_LOOKUPS = 21  # the reference Cpu chip's lookup count: 12 extension permutation columns
CPU_PAIRS = 11


def _airs():
    from zkmips_tpu_torch.stark.air import LookupKind
    from zkmips_tpu_torch.stark.chip import BaseAir

    class CpuShaped(BaseAir):
        """63 columns, degree-4 constraints (log quotient degree 2), 21 byte
        lookups on every row: is_real, clk, 11 byte pairs (x_i, y_i), 21 op
        results, 11 products x_i*y_i, 4 triple products, a running sum
        (bound to the public value), a result sum, a flag bit."""

        name = "CpuShaped"
        main_width = 63
        X0, R0, M0, C0, ACC, SUM, FLAG = 2, 24, 45, 56, 60, 61, 62

        def eval(self, b):
            real = b.main(0)
            x = [b.main(self.X0 + 2 * i) for i in range(CPU_PAIRS)]
            y = [b.main(self.X0 + 2 * i + 1) for i in range(CPU_PAIRS)]
            r = [b.main(self.R0 + k) for k in range(CPU_LOOKUPS)]
            m = [b.main(self.M0 + i) for i in range(CPU_PAIRS)]
            b.assert_bool(real)
            b.when_first_row().assert_zero(b.main(1))
            b.when_transition().assert_eq(b.main(1, 1), b.main(1) + 1)
            on = b.when(real)
            for i in range(CPU_PAIRS):
                on.assert_eq(m[i], x[i] * y[i])
            for j in range(4):
                on.assert_eq(b.main(self.C0 + j), x[2 * j] * y[2 * j] * m[2 * j + 1])
            acc = b.main(self.ACC)
            b.when_first_row().assert_eq(acc, r[0])
            b.when_transition().assert_eq(b.main(self.ACC, 1), acc + b.main(self.R0, 1))
            b.when_last_row().assert_eq(acc, b.public_value(0))
            total = r[0]
            for v in r[1:]:
                total = total + v
            b.assert_eq(b.main(self.SUM), total)
            b.assert_bool(b.main(self.FLAG))
            for k in range(CPU_LOOKUPS):
                i = k // 2
                b.send(LookupKind.Byte, [k % N_BYTE_OPS, x[i], y[i], r[k]], real)

        def generate_trace(self, record, output):
            return record[self.name]

    class AddSubShaped(BaseAir):
        """22 columns, degree 3: a 32-bit add by bytes with carries, the
        three words, a flag, a row counter; 3 byte range lookups per row."""

        name = "AddSubShaped"
        main_width = 22

        def eval(self, b):
            real = b.main(0)
            a = [b.main(1 + i) for i in range(4)]
            bb = [b.main(5 + i) for i in range(4)]
            c = [b.main(9 + i) for i in range(4)]
            carry = [b.main(13 + i) for i in range(4)]
            b.assert_bool(real)
            on = b.when(real)
            for i in range(4):
                b.assert_bool(carry[i])
                rhs = a[i] + bb[i] + (carry[i - 1] if i else 0)
                on.assert_eq(c[i] + carry[i] * 256, rhs)
            for col, limbs in ((17, a), (18, bb), (19, c)):
                b.assert_eq(b.main(col), limbs[0] + limbs[1] * 256 + limbs[2] * 65536 + limbs[3] * (1 << 24))
            b.assert_bool(b.main(20))
            b.when_first_row().assert_zero(b.main(21))
            b.when_transition().assert_eq(b.main(21, 1), b.main(21) + 1)
            b.send(LookupKind.Byte, [8, c[0], c[1], 0], real)
            b.send(LookupKind.Byte, [8, c[2], c[3], 0], real)
            b.send(LookupKind.Byte, [8, a[0], bb[0], 0], real)

        def generate_trace(self, record, output):
            return record[self.name]

    class ByteShaped(BaseAir):
        """The byte table: 2^16 preprocessed rows (x, y and 8 op results),
        9 multiplicity columns, one receive per op."""

        name = "ByteShaped"
        main_width = N_BYTE_OPS
        preprocessed_width = 10

        def eval(self, b):
            x, y = b.preprocessed(0), b.preprocessed(1)
            for k in range(N_BYTE_OPS):
                res = b.preprocessed(2 + k) if k < 8 else 0
                b.receive(LookupKind.Byte, [k, x, y, res], b.main(k))

        def generate_preprocessed(self, program):
            r = np.arange(1 << 16, dtype=np.uint32)
            x, y = r & 0xFF, r >> 8
            return np.stack([x, y] + [op(x, y) for op in BYTE_OPS[:8]], axis=1).astype(np.uint32)

        def generate_trace(self, record, output):
            return record[self.name]

    return CpuShaped, AddSubShaped, ByteShaped


def build_machine(config=None):
    from zkmips_tpu_torch.stark.chip import Chip
    from zkmips_tpu_torch.stark.machine import StarkConfig, StarkMachine

    cpu, addsub, byte = _airs()
    chips = [Chip(cpu(), 1), Chip(addsub(), 1), Chip(byte(), 1)]
    return StarkMachine(config or StarkConfig.core(), chips, num_public_values=1)


def build_record(log_rows: int, seed: int):
    """Canonical uint32 traces for every chip and the public values."""
    rng = np.random.default_rng(seed)
    h = 1 << log_rows
    mult = np.zeros((1 << 16, N_BYTE_OPS), dtype=np.uint64)

    def count(op, x, y):
        mult[:, op] += np.bincount((x + (y << 8)).astype(np.int64), minlength=1 << 16).astype(np.uint64)

    cpu = np.zeros((h, 63), dtype=np.uint64)
    cpu[:, 0] = 1
    cpu[:, 1] = np.arange(h)
    xy = rng.integers(0, 256, size=(h, 2 * CPU_PAIRS), dtype=np.uint64)
    cpu[:, 2:24] = xy
    x, y = xy[:, 0::2], xy[:, 1::2]
    for k in range(CPU_LOOKUPS):
        i, op = k // 2, k % N_BYTE_OPS
        cpu[:, 24 + k] = BYTE_OPS[op](x[:, i], y[:, i])
        count(op, x[:, i], y[:, i])
    m = x * y
    cpu[:, 45:56] = m
    for j in range(4):
        cpu[:, 56 + j] = x[:, 2 * j] * y[:, 2 * j] % P * m[:, 2 * j + 1] % P
    cpu[:, 60] = np.cumsum(cpu[:, 24]) % P
    cpu[:, 61] = cpu[:, 24:45].sum(axis=1)
    cpu[:, 62] = x[:, 0] & 1

    add = np.zeros((h, 22), dtype=np.uint64)
    add[:, 0] = 1
    a = rng.integers(0, 256, size=(h, 4), dtype=np.uint64)
    b = rng.integers(0, 256, size=(h, 4), dtype=np.uint64)
    carry = np.zeros(h, dtype=np.uint64)
    for i in range(4):
        s = a[:, i] + b[:, i] + carry
        add[:, 1 + i], add[:, 5 + i], add[:, 9 + i] = a[:, i], b[:, i], s & 0xFF
        carry = s >> 8
        add[:, 13 + i] = carry
    for col, limbs in ((17, add[:, 1:5]), (18, add[:, 5:9]), (19, add[:, 9:13])):
        add[:, col] = (limbs * np.array([1, 256, 65536, 1 << 24], dtype=np.uint64)).sum(axis=1) % P
    add[:, 20] = rng.integers(0, 2, size=h, dtype=np.uint64)
    add[:, 21] = np.arange(h)
    count(8, add[:, 9], add[:, 10])
    count(8, add[:, 11], add[:, 12])
    count(8, add[:, 1], add[:, 5])

    record = {"CpuShaped": cpu.astype(np.uint32), "AddSubShaped": add.astype(np.uint32),
              "ByteShaped": mult.astype(np.uint32)}
    return record, np.array([cpu[-1, 60]], dtype=np.uint32)


# --- measurement helpers ------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def poseidon2_bound(perms: int, bytes_moved: int) -> tuple[float, str, float]:
    """Least time for the work: the larger of bytes over HBM rate and integer
    multiplies over the CUDA-core rate (ms, and which of the two it is).
    Third, the same multiplies over the integer rate: the float32 rate counts
    two operations per lane and 128 lanes, integer multiplies issue on 64."""
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = perms * MULS_PER_PERM / H100_FP32_OPS_PER_S
    t_int = perms * MULS_PER_PERM / H100_INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations", max(t_bytes, t_int) * 1e3


def rand_field(rng, shape, dev) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, P, size=shape, dtype=np.int64).astype(np.int32)).to(dev)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def kernel_phase(dev, rng, main_hash_w: int, card: str) -> dict:
    """Hold each kernel against its plain version on the card; time both at
    the prover's shapes.  Returns {name: record}."""
    from zkmips_tpu_torch.ops import poseidon2 as p2, poseidon2_cuda as k

    errs = {"poseidon2_hash_rows": [], "poseidon2_compress": [], "poseidon2_permute": []}

    def check(name, got, want, what):
        e = max_err(got, want)
        errs[name].append(e)
        print(f"kernel {name} {what}: max_abs_err {e}", flush=True)
        if e != 0 or got.shape != want.shape:
            raise AssertionError(f"{name} {what} disagrees with its plain version")

    # edge vectors first: lazily reduced arithmetic fails here, not on random words
    for w in (1, 8, 13, 85):
        m = torch.from_numpy(p2.edge_matrix(w, 100 + w).astype(np.int32)).to(dev)
        check("poseidon2_hash_rows", k.hash_rows(m), p2.hash_matrix_rows_plain(m), f"edge vectors, width {w}")
    edge = torch.from_numpy(p2.edge_matrix(16, 116, mixed_rows=4087).astype(np.int32)).to(dev)
    check("poseidon2_permute", k.permute(edge), p2.permute_plain(edge), "edge vectors")
    halves = edge[:, :8].contiguous(), edge[:, 8:].contiguous()
    check("poseidon2_compress", k.compress(*halves), p2.compress_plain(*halves), "edge vectors")
    check("poseidon2_compress", k.compress_layer(edge.view(-1, 8)), p2.compress_plain(*halves),
          "edge vectors, in place")
    check("poseidon2_compress", k.compress(edge[:, :8], edge[:, 8:]), p2.compress_plain(*halves),
          "edge vectors, halves 16 words apart")

    for w in (1, 8, 13, 64, 88):
        m = rand_field(rng, (1024, w), dev)
        check("poseidon2_hash_rows", k.hash_rows(m), p2.hash_matrix_rows_plain(m), f"(1024, {w})")
    for shape in ((1000, 21), (1 << 21, 63), (1 << 21, main_hash_w)):
        m = rand_field(rng, shape, dev)
        check("poseidon2_hash_rows", k.hash_rows(m), p2.hash_matrix_rows_plain(m), str(shape))
    big = m  # the main commit's leaf layer shape

    left, right = rand_field(rng, (2048, 8), dev), rand_field(rng, (2048, 8), dev)
    check("poseidon2_compress", k.compress(left, right), p2.compress_plain(left, right), "2048 pairs")
    cur_k = cur_p = rand_field(rng, (4096, 8), dev)
    while cur_k.shape[0] > 1:
        cur_k = k.compress_layer(cur_k)
        cur_p = p2.compress_plain(cur_p[0::2], cur_p[1::2])
        check("poseidon2_compress", cur_k, cur_p, f"tree level {cur_k.shape[0]}")
    states = rand_field(rng, (1 << 16, 16), dev)
    check("poseidon2_permute", k.permute(states), p2.permute_plain(states), "65536 states")

    # the prover's shapes: the main commit's leaf hash (above), its first
    # Merkle level, one proof-of-work batch; compared, then timed
    n_pairs = big.shape[0] // 2
    leaves = k.hash_rows(big)
    check("poseidon2_compress", k.compress_layer(leaves),
          p2.compress_plain(leaves[0::2], leaves[1::2]), f"{n_pairs} pairs")
    grind = rand_field(rng, (1 << 18, 16), dev)
    check("poseidon2_permute", k.permute(grind), p2.permute_plain(grind), f"{grind.shape[0]} states")
    cases = {
        "poseidon2_hash_rows": (
            lambda: k.hash_rows(big), lambda: p2.hash_matrix_rows_plain(big), 3,
            big.shape[0] * -(-big.shape[1] // 8), big.numel() * 4 + big.shape[0] * 32,
            "zkmips_tpu/ops/pallas_p2.py:135", f"hash_rows {tuple(big.shape)}",
        ),
        "poseidon2_compress": (
            lambda: k.compress_layer(leaves), lambda: p2.compress_plain(leaves[0::2], leaves[1::2]), 10,
            n_pairs, n_pairs * 64 + n_pairs * 32,
            "zkmips_tpu/ops/pallas_p2.py:189", f"compress {n_pairs} pairs",
        ),
        "poseidon2_permute": (
            lambda: k.permute(grind), lambda: p2.permute_plain(grind), 10,
            grind.shape[0], grind.numel() * 8,
            "zkmips_tpu/stark/pcs.py:1068", f"permute {grind.shape[0]} states",
        ),
    }
    out = {}
    for name, (kern, plain, reps, perms, nbytes, replaces, shape) in cases.items():
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 1)
        bound_ms, bound_by, int_bound_ms = poseidon2_bound(perms, nbytes)
        out[name] = {
            "name": name, "route": "cuda", "source": "zkmips_tpu_torch/csrc/poseidon2.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": max(errs[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": shape,
        }
        print(f"time {name} at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), at the integer rate {int_bound_ms:.4f} ms, "
              f"{perms / ms / 1e6:.4f} x 10^9 permutations/s [{card}]", flush=True)
    return out


def print_kernels(records: dict):
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k != "shape"} for r in records.values()
    ]}), flush=True)


def small_proof(machine, record, pv, device) -> bytes:
    """Setup + prove_shard on ``device``; the proof's bytes (every field,
    through the port's codec)."""
    from zkmips_tpu_torch.verifier import stark_codec as codec

    pk = machine.setup(None, device=device)
    return codec.encode_core_proof([machine.prove_shard(pk, record, pv, device=device)], config="test")


class CpuSide:
    """The CPU halves of the card = CPU checks, made by a second process of
    this script (``--cpu-side DIR``) while this one runs the card's phases:
    each result is a file of proof bytes, ``DIR/<name>.bin``, which the
    phase that needs it waits for and compares with the card's.  The
    process's own lines (its times) are printed by ``close``."""

    def __init__(self, args):
        self.dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cpu")
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir)
        self.log = open(os.path.join(self.dir, "cpu_side.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-side", self.dir, "--seed", str(args.seed)],
            stdout=self.log, stderr=subprocess.STDOUT,
        )

    @classmethod
    def attach(cls, out: str) -> "CpuSide":
        """A reader of the results of the CPU process that another process
        of this script started (the side process's view)."""
        reader = cls.__new__(cls)
        reader.dir, reader.proc = out, None
        return reader

    def get(self, name: str) -> bytes:
        path = os.path.join(self.dir, f"{name}.bin")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if self.proc is None:
                if time.perf_counter() - t0 > 1200:
                    raise AssertionError(f"the CPU side wrote no {name} in 1,200 s")
            elif self.proc.poll() is not None and not os.path.exists(path):
                raise AssertionError(f"the CPU side exited with {self.proc.returncode} before {name}: "
                                     + self._tail())
            time.sleep(0.2)
        waited = time.perf_counter() - t0
        if waited > 1:
            print(f"cpu side: waited {waited:.1f} s for {name}", flush=True)
        with open(path, "rb") as fh:
            return fh.read()

    def _tail(self) -> str:
        self.log.flush()
        with open(self.log.name) as fh:
            return fh.read()[-2000:]

    def close(self, finished: bool):
        """Wait for the process when every result was read (its exit code
        must be 0), else stop it; print its lines.  Once."""
        if self.log.closed:
            return
        if finished:
            if self.proc.wait(timeout=600) != 0:
                raise AssertionError(f"the CPU side exited with {self.proc.returncode}: " + self._tail())
        elif self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        with open(self.log.name) as fh:
            for line in fh:
                if line.startswith("cpu side"):
                    print(line.rstrip(), flush=True)


def cpu_side(out: str, seed: int):
    """The CPU halves of the card = CPU checks, in the order the card's
    phases need them; each written to ``out`` as soon as it is made."""
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.stark.pcs import FriConfig

    torch.set_num_threads(4)

    def put(name: str, make):
        t0 = time.perf_counter()
        data = make()
        tmp = os.path.join(out, f".{name}.tmp")
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, os.path.join(out, f"{name}.bin"))
        print(f"cpu side: {name} proved on the CPU in {time.perf_counter() - t0:.3f} s", flush=True)

    small, small_pv = build_record(8, seed + 1)
    put("small_shard", lambda: small_proof(build_machine(), small, small_pv, "cpu"))
    put("mips_small_fib", lambda: small_fib_bytes("cpu"))
    os.nice(10)  # the rest is needed minutes later: the card's phases' host work goes first
    for name in MESH_SMALL_CHIPS:
        put(f"mesh_{name}", lambda: mesh_small_bytes(name, "cpu"))
    for name in RECURSION_CONFIGS:
        rec, pv = build_record(RECURSION_CPU_LOG_ROWS, seed + 8)
        machine = build_machine(StarkConfig(getattr(FriConfig, name)()))
        put(f"config_{name}", lambda: small_proof(machine, rec, pv, "cpu"))
    put("every_chip", lambda: every_chip_bytes("cpu", None)[0])
    put("ladder_small", lambda: small_ladder_bytes("cpu"))
    put("example_fibonacci", example_fibonacci_cpu_bytes)


def fib_program(n_iters: int):
    """The headline fib guest: 6 cycles an iteration, 10 around the loop."""
    from zkmips_tpu_torch.executor import Instruction, Opcode as O, Register as R, asm

    body = [
        *asm.li(R.T0, 0), *asm.li(R.T1, 1), *asm.li(R.T2, n_iters),
        asm.alu(O.ADD, R.T3, R.T0, R.T1),
        Instruction(O.ADD, R.T0, R.T1, 0, False, True),
        Instruction(O.ADD, R.T1, R.T3, 0, False, True),
        asm.addi(R.T2, R.T2, -1 & 0xFFFFFFFF),
        asm.branch(O.BGTZ, R.T2, 0, -20),
        asm.nop(),
    ]
    return asm.prog(body + asm.halt_sequence())


def print_shards(tag: str, proofs, card: str):
    """Each shard's chips (rows, padded log-height) and stage spans, from the
    tracing spans of the prove just run."""
    from zkmips_tpu_torch.utils import logger

    spans, rows = logger.spans_report(), logger.notes_report()
    for proof in proofs:
        shard = f"shard{int(proof.public_values[0])}"
        chips = {n: [rows[f"{shard}/prove.trace_gen/rows.{n}"], o.log_degree]
                 for n, o in zip(proof.chip_names, proof.opened)}
        print(f"{tag} {shard} chips [rows, padded log-height]: " + json.dumps(chips), flush=True)
        stages = {k.split("/", 1)[1]: round(v[0], 4) for k, v in spans.items() if k.startswith(shard + "/")}
        print(f"{tag} {shard} stages: " + json.dumps(
            {"card": card, "total_seconds": round(spans[shard][0], 4), "seconds": stages}), flush=True)


def print_fills(tag: str, proofs, card: str):
    """Each shard's trace fills from the pool: the wall of ``prove.trace_gen``
    beside each chip's fill, in thread seconds (fills run side by side, so
    their sum can exceed the wall)."""
    from zkmips_tpu_torch.utils import logger

    spans = logger.spans_report()
    for proof in proofs:
        shard = f"shard{int(proof.public_values[0])}"
        head = f"{shard}/prove.trace_gen"
        fills = {k[len(head) + len("/fill."):]: round(v[0], 4) for k, v in spans.items()
                 if k.startswith(head + "/fill.")}
        if not fills:
            raise AssertionError(f"{tag}: no fill spans under {head}")
        fills = dict(sorted(fills.items(), key=lambda kv: -kv[1]))
        print(f"{tag} {shard} fills: " + json.dumps(
            {"card": card, "trace_gen_seconds": round(spans[head][0], 4),
             "fill_thread_seconds_summed": round(sum(fills.values()), 4), "fill_thread_seconds": fills}),
            flush=True)


def expect_byte_rejected(proof_bytes: bytes, vk_bytes: bytes, what: str, tag: str):
    from zkmips_tpu_torch.stark.machine import VerificationError
    from zkmips_tpu_torch.verifier import stark_codec as codec

    bad = bytearray(proof_bytes)
    bad[len(bad) // 2] ^= 1
    t0 = time.perf_counter()
    try:
        codec.verify_core(bytes(bad), vk_bytes)
    except (VerificationError, codec.CodecError) as e:
        print(f"{tag} {what} rejected by verify_core in {time.perf_counter() - t0:.3f} s: {e}", flush=True)
    else:
        raise AssertionError(f"{tag}: {what} was accepted by verify_core")


def expect_rejected(machine, vk, proofs, program, what: str, tag: str = "mips"):
    from zkmips_tpu_torch.stark.machine import VerificationError

    try:
        machine.verify(vk, proofs, program)
    except VerificationError as e:
        print(f"{tag} {what} rejected: {e}", flush=True)
    else:
        raise AssertionError(f"{tag}: {what} was accepted")


def mips_phase(args, dev, card: str, cpu: CpuSide) -> dict:
    """Execute, prove and verify the fib guest; returns the kernels' launch
    counts over ``MipsMachine.prove``."""
    import copy

    from zkmips_tpu_torch.executor import execute_for_proving, native_trace, stream_for_proving
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.ops import poseidon2_cuda
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.utils import logger
    from zkmips_tpu_torch.verifier import stark_codec as codec

    t0 = time.perf_counter()
    lib = native_trace.library()
    print(f"mips build: trace executor in {time.perf_counter() - t0:.1f} s -> "
          f"{lib.rsplit('/', 1)[-1]}", flush=True)
    program = fib_program(args.fib_iters)
    t0 = time.perf_counter()
    records, info = execute_for_proving(program, shard_size=FIB_SHARD_CYCLES)
    exec_s = time.perf_counter() - t0
    cycles = info["global_clk"]
    print(f"mips executor ({info['executor']}): {cycles} cycles in {exec_s:.3f} s, {len(records)} "
          f"shards of up to {FIB_SHARD_CYCLES} cycles, Cpu rows {[len(r.cpu_events) for r in records]}",
          flush=True)
    if len(records[0].cpu_events) != FIB_SHARD_CYCLES or len(records) < 2:
        raise AssertionError("the guest does not fill one shard and start a second")

    machine = mips_machine(StarkConfig.core(), minimal=True)
    t0 = time.perf_counter()
    pk = machine.setup(program)
    torch.cuda.synchronize()
    print(f"mips setup: {time.perf_counter() - t0:.3f} s [{card}]", flush=True)

    logger.configure(enabled=True, sync=True, echo=False)
    logger.spans_reset()
    torch.cuda.reset_peak_memory_stats()
    poseidon2_cuda.reset_launches()
    t0 = time.perf_counter()
    proofs = machine.prove(pk, records)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(poseidon2_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    logger.configure(enabled=False)
    print_shards("mips", proofs, card)
    print(f"mips prove: {prove_s:.3f} s for {cycles} cycles in {len(proofs)} shards, "
          f"{cycles / prove_s:.1f} cycles proved per second, peak device memory {peak_gb:.2f} GiB "
          f"[{card}]", flush=True)
    print(f"mips launches over prove: {launches} [{card}]", flush=True)

    t0 = time.perf_counter()
    assert machine.verify(pk.vk, proofs, program)
    print(f"mips verify: accepted {len(proofs)} shard proofs, the shard chain and the digest sum "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    bad = copy.copy(proofs)
    bad[0] = copy.deepcopy(proofs[0])
    gs = bad[0].opened[bad[0].chip_names.index("Global")].global_sum
    gs[0] ^= 1
    expect_rejected(machine, pk.vk, bad, program, "flipped word of a global digest")
    expect_rejected(machine, pk.vk, [proofs[1], proofs[0], *proofs[2:]], program, "swapped proofs")
    batch_bytes = codec.encode_core_proof(proofs)
    del proofs, bad, records

    # the same guest streamed: the proofs must be the batch's, byte for byte
    t0 = time.perf_counter()
    streamed = machine.prove_streaming(pk, stream_for_proving(program, shard_size=FIB_SHARD_CYCLES),
                                       split_threshold=DEFAULT_SPLIT_THRESHOLD)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    if codec.encode_core_proof(streamed) != batch_bytes:
        raise AssertionError("mips: the streamed proofs differ from the batch proofs")
    print(f"mips streamed: {len(streamed)} shard proofs equal the batch proofs byte for byte "
          f"({len(batch_bytes)} bytes), streamed in {stream_s:.3f} s [{card}]", flush=True)
    del streamed, pk

    # a small fib on the card and on the CPU must give the same proofs
    t0 = time.perf_counter()
    on_card = small_fib_bytes(dev)
    if on_card != cpu.get("mips_small_fib"):
        raise AssertionError("mips: the card's proofs of the small fib differ from the CPU's")
    print(f"mips small fib: card and CPU proofs of two shards equal ({len(on_card)} bytes; card "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return launches


def small_fib_bytes(device) -> bytes:
    """The small fib (1810 cycles, two shards of up to 2^10) proved on
    ``device`` by the fifteen-chip machine at the core config: its bytes."""
    from zkmips_tpu_torch.executor import execute_for_proving
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.verifier import stark_codec as codec

    machine = mips_machine(StarkConfig.core(), minimal=True)
    small = fib_program(300)
    recs, _ = execute_for_proving(small, shard_size=1 << 10)
    pk = machine.setup(small, device=device)
    proofs = machine.prove(pk, recs, device=device)
    sums = [o.global_sum for p in proofs for n, o in zip(p.chip_names, p.opened) if n == "Global"]
    if len(proofs) < 2 or len(sums) != len(proofs) or any(g is None for g in sums):
        raise AssertionError("mips: the small fib did not give two shards with global sums")
    return codec.encode_core_proof(proofs)


def keccak_phase(args, dev, card: str) -> dict:
    """The keccak-chain guest at full size through the 49-chip machine;
    returns the kernels' launch counts over ``MipsMachine.prove``."""
    import copy

    from zkmips_tpu_torch.executor import execute_for_proving, guests
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.ops import poseidon2_cuda
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.utils import logger

    # the deferred-shard split threshold (the reference's SPLIT_THRESHOLD knob,
    # 2^15 rows by default) raised so that the KeccakSponge events stay one
    # deferred shard up to 5,461 iterations (2^17 rows)
    os.environ["SPLIT_THRESHOLD"] = str(KECCAK_SPLIT_THRESHOLD)
    program = guests.keccak_chain_program(args.keccak_iters)
    t0 = time.perf_counter()
    records, info = execute_for_proving(program, shard_size=FULL_SHARD_CYCLES)
    exec_s = time.perf_counter() - t0
    cycles = info["global_clk"]
    print(f"keccak executor ({info['executor']}): {cycles} cycles in {exec_s:.3f} s, "
          f"{cycles / exec_s:.1f} cycles/s, {len(records)} shards, KeccakSponge events "
          f"{[len(r.precompile_events.get('keccak_sponge', [])) for r in records]} [{card}]", flush=True)
    if info["executor"] != "interpreter":
        raise AssertionError("the keccak guest did not run on the interpreter")

    machine = mips_machine(StarkConfig.core())
    if len(machine.airs) != 49:
        raise AssertionError(f"mips_machine() has {len(machine.airs)} chips, not 49")
    t0 = time.perf_counter()
    pk = machine.setup(program)
    torch.cuda.synchronize()
    print(f"keccak setup: {time.perf_counter() - t0:.3f} s [{card}]", flush=True)

    logger.configure(enabled=True, sync=True, echo=False)
    logger.spans_reset()
    torch.cuda.reset_peak_memory_stats()
    poseidon2_cuda.reset_launches()
    t0 = time.perf_counter()
    proofs = machine.prove(pk, records)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(poseidon2_cuda.LAUNCHES)
    shapes = sorted(poseidon2_cuda.HASH_SHAPES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    logger.configure(enabled=False)
    print_shards("keccak", proofs, card)
    print_fills("keccak", proofs, card)
    print(f"keccak prove: {prove_s:.3f} s for {cycles} cycles in {len(proofs)} shards, "
          f"{cycles / prove_s:.1f} cycles proved per second, peak device memory {peak_gb:.2f} GiB "
          f"[{card}]", flush=True)
    print(f"keccak launches over prove: {launches} [{card}]", flush=True)
    print(f"keccak K1 leaf shapes (rows, width): {shapes}", flush=True)
    at = [i for i, p in enumerate(proofs) if "KeccakSponge" in p.chip_names]
    if len(at) != 1:
        raise AssertionError(f"KeccakSponge is in {len(at)} shards, not one")
    kproof = proofs[at[0]]
    keccak = kproof.chip_names.index("KeccakSponge")
    if kproof.opened[keccak].log_degree < 15:
        raise AssertionError("KeccakSponge is below 2^15 padded rows")

    t0 = time.perf_counter()
    assert machine.verify(pk.vk, proofs, program)
    print(f"keccak verify: accepted {len(proofs)} shard proofs in {time.perf_counter() - t0:.3f} s "
          f"[{card}]", flush=True)
    bad = copy.copy(proofs)
    bad[at[0]] = copy.deepcopy(kproof)
    bad[at[0]].opened[keccak].main_local[0] ^= 1
    expect_rejected(machine, pk.vk, bad, program, "flipped word of KeccakSponge's opened values", "keccak")
    del proofs, bad, kproof, pk, records
    del os.environ["SPLIT_THRESHOLD"]
    widest_leaf_check("the keccak prove's", shapes, args.seed + 5, dev, card)
    return launches


def widest_leaf_check(what: str, shapes, seed: int, dev, card: str):
    """K1 at the widest leaf shape (rows, width) of a prove, against its
    plain version, and timed beside its bound."""
    from zkmips_tpu_torch.ops import poseidon2 as p2, poseidon2_cuda

    rows, width = max(shapes, key=lambda s: (s[1], s[0]))
    m = rand_field(np.random.default_rng(seed), (rows, width), dev)
    got, want = poseidon2_cuda.hash_rows(m), p2.hash_matrix_rows_plain(m)
    err = max_err(got, want)
    print(f"kernel poseidon2_hash_rows ({rows}, {width}), {what} widest leaf: "
          f"max_abs_err {err} [{card}]", flush=True)
    if err != 0 or got.shape != want.shape:
        raise AssertionError("poseidon2_hash_rows disagrees with its plain version at the widest leaf")
    ms = cuda_ms(lambda: poseidon2_cuda.hash_rows(m), 3)
    perms = rows * -(-width // 8)
    bound_ms, bound_by, _ = poseidon2_bound(perms, m.numel() * 4 + rows * 32)
    print(f"time poseidon2_hash_rows at ({rows}, {width}): kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}) [{card}]", flush=True)


def elf_phase(dev, card: str):
    """Each fixture ELF: load, execute, prove on the card at the core config, verify."""
    from pathlib import Path

    from zkmips_tpu_torch.executor import Program, execute_for_proving
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.stark.machine import StarkConfig

    root = Path(__file__).resolve().parent / FIXTURES
    elfs = sorted(root.glob("*.elf"))
    if len(elfs) != 6:
        raise AssertionError(f"expected the six fixture ELFs under {root}, found {len(elfs)}")
    machine = mips_machine(StarkConfig.core())
    for path in elfs:
        t0 = time.perf_counter()
        program = Program.from_elf(path.read_bytes())
        stdin = IO_HINTS_STDIN if path.stem == "io_hints_commit" else []
        records, info = execute_for_proving(program, stdin_bufs=stdin, shard_size=FULL_SHARD_CYCLES)
        exec_s = time.perf_counter() - t0
        pk = machine.setup(program)
        proofs = machine.prove(pk, records)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0 - exec_s
        assert machine.verify(pk.vk, proofs, program)
        chips = sorted({n for p in proofs for n in p.chip_names})
        print(f"elf {path.stem}: {info['global_clk']} cycles ({info['executor']}, {exec_s:.3f} s), "
              f"{len(proofs)} shards, chips {chips}, setup + prove {prove_s:.3f} s, verified, "
              f"{time.perf_counter() - t0:.3f} s in all [{card}]", flush=True)


def every_chip_phase(dev, card: str, cpu: CpuSide):
    """A guest that gives all 49 chips rows, proved at the test config on the
    card and on the CPU: the proofs must be equal field by field."""
    on_card, names = every_chip_bytes(dev, card)
    if on_card != cpu.get("every_chip"):
        raise AssertionError("the card's proof of the every-chip guest differs from the CPU's")
    print(f"every-chip guest: card and CPU proofs equal, {len(names)} chips", flush=True)


def every_chip_bytes(device, card):
    """The every-chip guest proved on ``device`` at the test config: (its
    bytes, the chips it filled).  On the card its stages are printed and
    the proof verified."""
    from zkmips_tpu_torch.executor import execute_for_proving, guests
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.utils import logger
    from zkmips_tpu_torch.verifier import stark_codec as codec

    program = guests.every_chip_program()
    machine = mips_machine(StarkConfig.test())
    t0 = time.perf_counter()
    records, _ = execute_for_proving(program)
    pk = machine.setup(program, device=device)
    on_card = device != "cpu"
    logger.configure(enabled=on_card, sync=True, echo=False)
    logger.spans_reset()
    proofs = machine.prove(pk, records, device=device)
    names = {n for p in proofs for n in p.chip_names}
    if names != {a.name for a in machine.airs} or len(names) != 49:
        raise AssertionError(f"the every-chip guest left chips empty: {sorted({a.name for a in machine.airs} - names)}")
    if on_card:  # the stages of a shard of 49 small chips; the CPU's proofs must equal these
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        logger.configure(enabled=False)
        print_shards("every-chip", proofs, card)
        t1 = time.perf_counter()
        assert machine.verify(pk.vk, proofs, program)
        print(f"every-chip guest on {device}: proved in {prove_s:.3f} s, verified in "
              f"{time.perf_counter() - t1:.3f} s [{card}]", flush=True)
    return codec.encode_core_proof(proofs, config="test"), names


def stream_phase(args, dev, card: str) -> dict:
    """The streaming path at full size: the fib guest (``--stream-fib-iters``)
    executed by ``stream_for_proving`` in 2^20-cycle shards and proved as the
    records arrive by ``MipsMachine.prove_streaming`` (one worker, pooled
    fills) on the card; the proofs are encoded with the port's codec and
    accepted by ``verify_core`` on the bytes, and a flipped byte must be
    rejected.  Returns the kernels' launch counts over the streamed prove."""
    from zkmips_tpu_torch.executor import stream_for_proving
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.ops import poseidon2_cuda
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.verifier import stark_codec as codec

    program = fib_program(args.stream_fib_iters)
    machine = mips_machine(StarkConfig.core())
    pk = machine.setup(program)
    torch.cuda.synchronize()
    produced = {"seconds": 0.0, "cycles": 0, "records": 0}

    def timed(stream):
        """The executor's own time: spent producing each record."""
        while True:
            t = time.perf_counter()
            try:
                r = next(stream)
            except StopIteration:
                return
            finally:
                produced["seconds"] += time.perf_counter() - t
            produced["cycles"] += len(r.cpu_events)
            produced["records"] += 1
            yield r

    torch.cuda.reset_peak_memory_stats()
    poseidon2_cuda.reset_launches()
    t0 = time.perf_counter()
    proofs = machine.prove_streaming(pk, timed(stream_for_proving(program, shard_size=FULL_SHARD_CYCLES)),
                                     workers=1, split_threshold=DEFAULT_SPLIT_THRESHOLD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(poseidon2_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    cycles = produced["cycles"]
    if len(proofs) != produced["records"] or len(proofs) < 2:
        raise AssertionError(f"stream: {len(proofs)} proofs of {produced['records']} records, not 2 or more")
    print(f"stream fib: {cycles} cycles, {len(proofs)} shards of up to {FULL_SHARD_CYCLES} cycles, "
          f"executor {produced['seconds']:.3f} s, streamed prove wall {wall:.3f} s, "
          f"{cycles / wall:.1f} cycles proved per second, peak device memory {peak_gb:.2f} GiB, "
          f"one worker [{card}]", flush=True)
    print(f"stream launches over prove_streaming: {launches} [{card}]", flush=True)

    t0 = time.perf_counter()
    proof_bytes = codec.encode_core_proof(proofs)
    vk_bytes = codec.encode_vk(pk.vk, program.pc_start)
    enc_s = time.perf_counter() - t0
    del proofs, pk
    t0 = time.perf_counter()
    assert codec.verify_core(proof_bytes, vk_bytes)
    print(f"stream bytes: {len(proof_bytes)} proof bytes, {len(vk_bytes)} vk bytes, encoded in "
          f"{enc_s:.3f} s, accepted by verify_core in {time.perf_counter() - t0:.3f} s", flush=True)
    expect_byte_rejected(proof_bytes, vk_bytes, "proof with a flipped byte", "stream")
    return launches


def stream_keccak_phase(dev, card: str):
    """A small keccak chain with deferred shards: ``prove_streaming`` with one
    and two workers must give the batch proofs byte for byte, shard
    numbers and chained public values of the deferred shards included."""
    from zkmips_tpu_torch.executor import execute_for_proving, guests, stream_for_proving
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.verifier import stark_codec as codec

    program = guests.keccak_chain_program(SMALL_KECCAK_ITERS)
    machine = mips_machine(StarkConfig.core())
    pk = machine.setup(program)
    t0 = time.perf_counter()
    records, _ = execute_for_proving(program, shard_size=SMALL_KECCAK_SHARD)
    shards = machine.split_deferred(records, split_threshold=SMALL_KECCAK_SPLIT)
    batch = [machine.prove_record(pk, r) for r in shards]  # prove's own steps
    n_exec = len(records)
    if n_exec < 2 or len(batch) == n_exec:
        raise AssertionError(f"stream keccak: {n_exec} execution and {len(batch) - n_exec} deferred "
                             "shards, not two and one or more")
    batch_bytes = codec.encode_core_proof(batch)
    assert codec.verify_core(batch_bytes, codec.encode_vk(pk.vk, program.pc_start))
    print(f"stream keccak batch: {n_exec} execution + {len(batch) - n_exec} deferred shards, "
          f"shard numbers {[int(p.public_values[0]) for p in batch]}, proved and verified in "
          f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    del batch, records, shards
    for workers in (1, 2):
        t0 = time.perf_counter()
        proofs = machine.prove_streaming(pk, stream_for_proving(program, shard_size=SMALL_KECCAK_SHARD),
                                         workers=workers, max_inflight=2,
                                         split_threshold=SMALL_KECCAK_SPLIT)
        if codec.encode_core_proof(proofs) != batch_bytes:
            raise AssertionError(f"stream keccak: {workers} worker(s) gave other proofs than batch")
        print(f"stream keccak, {workers} worker(s): {len(proofs)} proofs equal the batch's byte for "
              f"byte, {time.perf_counter() - t0:.3f} s [{card}]", flush=True)


def recursion_configs_phase(args, dev, card: str, cpu: CpuSide):
    """The synthetic shard at the KoalaBear recursion configs (log blowup 2
    and 3): proved on the card and verified at 2^16 rows, a tampered proof
    rejected; at 2^13 rows the card's proof must equal the CPU's."""
    from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError
    from zkmips_tpu_torch.stark.pcs import FriConfig

    for name in RECURSION_CONFIGS:
        fri = getattr(FriConfig, name)()
        machine = build_machine(StarkConfig(fri))
        record, pv = build_record(RECURSION_LOG_ROWS, args.seed + 7)
        pk = machine.setup(None)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        proof = machine.prove_shard(pk, record, pv)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        assert machine.verify_shard(pk.vk, proof)
        proof.fri_proof.final_poly[0] ^= 1
        try:
            machine.verify_shard(pk.vk, proof)
        except VerificationError:
            pass
        else:
            raise AssertionError(f"{name}: a tampered proof was accepted")
        print(f"config {name} (log blowup {fri.log_blowup}, {fri.num_queries} queries): synthetic shard "
              f"at 2^{RECURSION_LOG_ROWS} rows proved in {prove_s:.3f} s, peak device memory "
              f"{peak_gb:.2f} GiB, {len(proof.fri_proof.commit_roots)} FRI layers, verified, "
              f"tampered proof rejected [{card}]", flush=True)
        del proof, pk, record
        small, small_pv = build_record(RECURSION_CPU_LOG_ROWS, args.seed + 8)
        t0 = time.perf_counter()
        on_card = small_proof(machine, small, small_pv, dev)
        card_s = time.perf_counter() - t0
        if on_card != cpu.get(f"config_{name}"):
            raise AssertionError(f"{name}: the card's proof differs from the CPU's")
        print(f"config {name}: card and CPU proofs at 2^{RECURSION_CPU_LOG_ROWS} rows equal "
              f"(card {card_s:.1f} s)", flush=True)


# --- the recursion ladder -------------------------------------------------------

LADDER_STAGES = ("lift", "compress", "shrink", "wrap")
SDK_FIB_ITERS = 25  # the SDK phase's guest: the e2e fib, two shards of up to 128 cycles
SDK_SHARD = 128
SMALL_LADDER_ITERS = 25  # the card = CPU ladder guest: 160 cycles, two shards of up to 128
SMALL_LADDER_SHARD = 128
DEFERRED_AIRS = ("CpuAir", "AddSubAir", "BitwiseAir", "LtAir", "ShiftLeftAir", "ShiftRightAir",
                 "BranchAir", "JumpAir", "MemoryInstrAir", "SyscallInstrAir", "MemoryLocalAir",
                 "MemoryGlobalInitAir", "MemoryGlobalFinalizeAir", "GlobalAir", "ProgramAir",
                 "ByteAir")  # the sixteen chips of the deferred chain's guests


def ladder_stage(name: str, fn, card: str):
    """Run one stage of the ladder with fenced spans, fresh launch counts and
    a fresh peak-memory mark; print its parts.  Returns (output, record)."""
    from zkmips_tpu_torch.ops import poseidon2_cuda
    from zkmips_tpu_torch.utils import logger

    logger.configure(enabled=True, sync=True, echo=False)
    logger.spans_reset()
    torch.cuda.reset_peak_memory_stats()
    poseidon2_cuda.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(poseidon2_cuda.LAUNCHES)
    shapes = sorted(poseidon2_cuda.HASH_SHAPES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    spans = logger.spans_report()
    logger.configure(enabled=False)
    parts = {part: round(spans.get(f"{name}.{part}", (0.0, 0))[0], 4)
             for part in ("circuit", "setup", "execute", "prove")}
    parts["fills"] = round(spans.get(f"{name}.prove/prove.trace_gen", (0.0, 0))[0], 4)
    rec = {"wall_s": round(wall, 4), "parts_s": parts, "peak_gib": round(peak_gb, 3),
           "launches": launches, "leaf_shapes": shapes}
    print(f"ladder {name}: " + json.dumps({"card": card, "wall_seconds": rec["wall_s"],
                                             "seconds": parts, "execute": "C runtime",
                                             "peak_device_gib": rec["peak_gib"],
                                             "launches": launches}), flush=True)
    return out, rec


def print_recursion_shape(name: str, proof, card: str):
    """A recursion proof's chips: padded log-heights."""
    heights = {n: o.log_degree for n, o in zip(proof.chip_names, proof.opened)}
    print(f"ladder {name} chips [padded log-height]: " + json.dumps(heights) + f" [{card}]", flush=True)


def recursion_phase(args, dev, card: str, cpu: CpuSide, beside=None) -> dict:
    """The recursion ladder at full width: the fib guest in 2^20-cycle shards
    proved by the 49-chip machine at the core config, then lift, compress,
    shrink and wrap on the card; each stage checked with
    ``verify_compressed`` and through its bytes.  Returns the launch counts
    per stage.  ``beside`` is called as the wrap starts (its BN254 hashing
    is host code: the card is idle)."""
    import copy

    from zkmips_tpu_torch.executor import execute_for_proving
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.recursion.compress import RecursionProver
    from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError
    from zkmips_tpu_torch.stark.pcs import FriConfig
    from zkmips_tpu_torch.verifier import stark_codec as codec

    program = fib_program(args.ladder_fib_iters)
    t0 = time.perf_counter()
    records, info = execute_for_proving(program, shard_size=FULL_SHARD_CYCLES)
    if len(records) < 2:
        raise AssertionError("ladder: the guest does not fill two shards")
    machine = mips_machine(StarkConfig.core())
    pk = machine.setup(program)
    proofs = machine.prove(pk, records)
    torch.cuda.synchronize()
    print(f"ladder core: {info['global_clk']} cycles ({info['executor']} executor), {len(proofs)} shards "
          f"of up to {FULL_SHARD_CYCLES} cycles, executed and proved at the core config by the "
          f"{len(machine.airs)}-chip machine in {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    placement = None
    if not args.only_snark:
        placement = placement_check(machine, pk, records, proofs, card)
    del records
    rp = RecursionProver(machine)
    if rp.shrink_machine.machine.config.fri != FriConfig.compressed() or \
            rp.wrap_machine.machine.config.fri != FriConfig.outer():
        raise AssertionError("ladder: shrink/wrap are not at the compressed / outer configs")
    stages, done = {}, {}

    def check(stage: str, cp):
        t0 = time.perf_counter()
        assert rp.verify_compressed(pk.vk, program, cp)
        b = codec.encode_compressed_proof(cp)
        back, _cfg = codec.decode_compressed_proof(b)
        if codec.encode_compressed_proof(back) != b:
            raise AssertionError(f"ladder {stage}: the bytes do not round-trip")
        assert rp.verify_compressed(pk.vk, program, back)
        stages[stage]["proof_bytes"] = len(b)
        print(f"ladder {stage}: verify_compressed accepted the proof and its {len(b)} bytes decoded "
              f"in {time.perf_counter() - t0:.3f} s", flush=True)
        return b

    layer, stages["lift"] = ladder_stage("lift", lambda: [rp.lift(pk.vk, p) for p in proofs], card)
    stages["lift"]["proof_bytes"] = [len(codec.encode_core_proof([p])) for p, _vk in layer]
    for i, (p, _vk) in enumerate(layer):
        print_recursion_shape(f"lift {i + 1}", p, card)
    done["compress"], stages["compress"] = ladder_stage(
        "compress", lambda: rp.join(layer, len(proofs)), card)
    print_recursion_shape("compress", done["compress"].proof, card)
    check("compress", done["compress"])
    del layer, proofs
    done["shrink"], stages["shrink"] = ladder_stage("shrink", lambda: rp.shrink(done["compress"]), card)
    print_recursion_shape("shrink", done["shrink"].proof, card)
    check("shrink", done["shrink"])
    if beside is not None:
        beside()
    done["wrap"], stages["wrap"] = ladder_stage("wrap", lambda: rp.wrap(done["shrink"]), card)
    print_recursion_shape("wrap", done["wrap"].proof, card)
    wrap_bytes = check("wrap", done["wrap"])
    if done["wrap"].proof.main_root.dtype != object:
        raise AssertionError("ladder wrap: the digests are not BN254 scalars")

    bad = bytearray(wrap_bytes)
    bad[len(bad) // 2] ^= 1
    try:
        rp.verify_compressed(pk.vk, program, codec.decode_compressed_proof(bytes(bad))[0])
    except (VerificationError, codec.CodecError) as e:
        print(f"ladder wrap: a flipped byte rejected: {e}", flush=True)
    else:
        raise AssertionError("ladder wrap: a flipped byte was accepted")
    tampered = copy.deepcopy(done["wrap"])
    tampered.proof.public_values[0] += 1
    try:
        rp.verify_compressed(pk.vk, program, tampered)
    except VerificationError as e:
        print(f"ladder wrap: a tampered public value of the final record rejected: {e}", flush=True)
    else:
        raise AssertionError("ladder wrap: a tampered public value was accepted")
    widest_leaf_check("the ladder's", stages["lift"]["leaf_shapes"] + stages["compress"]["leaf_shapes"]
                      + stages["shrink"]["leaf_shapes"], args.seed + 9, dev, card)
    print("ladder stages: " + json.dumps({"card": card, "stages": {
        k: {kk: vv for kk, vv in v.items() if kk != "leaf_shapes"} for k, v in stages.items()}}), flush=True)
    launches = {k: v["launches"] for k, v in stages.items()}
    launches["placement"] = placement
    if args.plonk_full:
        snark_plonk_full(rp, done["wrap"], pk.vk, program, card)
    elif args.only_snark:
        snark_groth16_full(rp, done["wrap"], pk.vk, program, info, card)
    else:
        del done, pk
        ladder_card_equals_cpu(dev, card, cpu)
        deferred_chain(card)
    return launches


def ladder_card_equals_cpu(dev, card: str, cpu: CpuSide):
    """At the test config, one lift and one compress pair (a two-shard guest
    on the minimal machine) proved on the card and on the CPU: the
    compressed proofs' bytes must be equal."""
    t0 = time.perf_counter()
    on_card = small_ladder_bytes(dev)
    if on_card != cpu.get("ladder_small"):
        raise AssertionError("ladder small: the card's compressed proof differs from the CPU's")
    print(f"ladder small: two lifts and a compress pair at the test config, card and CPU bytes equal "
          f"({len(on_card)} bytes; card {time.perf_counter() - t0:.3f} s) [{card}]", flush=True)


def small_ladder_bytes(device) -> bytes:
    """A two-shard guest proved, lifted and compressed on ``device`` at the
    test config (minimal machine): the compressed proof's bytes."""
    from zkmips_tpu_torch.executor import execute_for_proving
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.recursion.compress import RecursionProver
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.verifier import stark_codec as codec

    program = fib_program(SMALL_LADDER_ITERS)
    records, _ = execute_for_proving(program, shard_size=SMALL_LADDER_SHARD)
    if len(records) != 2:
        raise AssertionError(f"ladder small: {len(records)} shards, not two")
    machine = mips_machine(StarkConfig.test(), minimal=True)
    pk = machine.setup(program, device=device)
    rp = RecursionProver(machine)
    cp = rp.compress(pk.vk, machine.prove(pk, records, device=device), device=device)
    assert rp.verify_compressed(pk.vk, program, cp)
    return codec.encode_compressed_proof(cp, config="test")


def deferred_chain(card: str):
    """The deferred chain of the aggregation test on the card, at the test
    config: guest A compressed; guest B verifies A's proof in the VM and
    commits the chain; ``prove_deferred`` -> ``verify_deferred`` against
    guest B's compressed proof; a link with a changed digest rejected."""
    import copy

    from zkmips_tpu_torch.executor import Executor, Register as R, asm, execute_for_proving
    from zkmips_tpu_torch.machine.machine import MipsMachine, core_chip_airs
    from zkmips_tpu_torch.recursion.compress import RecursionProver
    from zkmips_tpu_torch.recursion.rec_pv import canonical_digest
    from zkmips_tpu_torch.recursion.verifier import record_digest, rolling_deferred_digest
    from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError

    airs = {type(a).__name__: type(a) for a in core_chip_airs()}

    def machine():
        return MipsMachine(StarkConfig.test(), chip_airs=[airs[n]() for n in DEFERRED_AIRS])

    def sys_(code, a0=0, a1=0):
        return [*asm.li(R.V0, int(code)), *asm.li(R.A0, a0), *asm.li(R.A1, a1), asm.syscall()]

    def store(addr, words):
        return [x for i, w in enumerate(words)
                for x in (*asm.li(R.T0, int(w)), *asm.li(R.T1, addr + 4 * i), asm.sw(R.T0, R.T1))]

    t0 = time.perf_counter()
    m_a = machine()
    prog_a = asm.prog([*asm.li(R.T0, 5)] + asm.halt_sequence())
    pk_a = m_a.setup(prog_a)
    rp = RecursionProver(m_a)
    cp_a = rp.compress(pk_a.vk, m_a.prove(pk_a, execute_for_proving(prog_a)[0]))
    assert rp.verify_compressed(pk_a.vk, prog_a, cp_a)
    child_vk = rp._find_final_vk(cp_a)
    vk_root = canonical_digest(child_vk.prep_root)
    child_pv = cp_a.proof.public_values.tolist()
    chain = rolling_deferred_digest([0] * 8, vk_root, child_pv)
    body = store(0x2000, vk_root) + store(0x2100, record_digest(child_pv)) + sys_(0x1B, 0x2000, 0x2100)
    for i, w in enumerate(chain):
        body += sys_(0x1A, i, w)  # COMMIT_DEFERRED_PROOFS
    prog_b = asm.prog(body + asm.halt_sequence())
    ex = Executor(prog_b)
    ex.subproof_verifier = lambda proof, proof_vk, _vkey, _pvd: rp.rec.verify(proof_vk, proof)
    ex.proof_stream.append((cp_a.proof, child_vk))
    records_b = ex.run()
    m_b = machine()
    pk_b = m_b.setup(prog_b)
    cp_b = RecursionProver(m_b).compress(pk_b.vk, m_b.prove(pk_b, records_b))
    dp, new_digest = rp.prove_deferred(cp_a, [0] * 8)
    if new_digest != chain:
        raise AssertionError("deferred: the chain link is not the guest's committed digest")
    assert rp.verify_deferred([dp], cp_b)
    bad = copy.deepcopy(dp)
    bad.new_digest[0] = (bad.new_digest[0] + 1) % P
    try:
        rp.verify_deferred([bad], cp_b)
    except VerificationError as e:
        print(f"deferred: a link with a changed digest rejected: {e}", flush=True)
    else:
        raise AssertionError("deferred: a changed chain link was accepted")
    print(f"deferred: guest A compressed, guest B verified it in the VM, prove_deferred -> "
          f"verify_deferred accepted the chain in {time.perf_counter() - t0:.3f} s [{card}]", flush=True)


def host_rss_gib() -> tuple[float, float]:
    """(resident, peak resident) memory of this process, GiB."""
    import resource

    with open("/proc/self/status") as fh:
        rss_kb = next(int(line.split()[1]) for line in fh if line.startswith("VmRSS:"))
    return rss_kb / 2**20, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def snark_counts(run, echo: bool = True) -> tuple:
    """Run ``run()`` with fresh spans, notes and launch counts (with
    ``echo``, each span and count printed on stderr as it ends, so a cut run
    shows how far it got); returns (output, {part: seconds}, notes, launches,
    resident GiB before)."""
    from zkmips_tpu_torch.ops import poseidon2_cuda
    from zkmips_tpu_torch.utils import logger

    rss0, _ = host_rss_gib()
    logger.configure(enabled=True, echo=echo)
    logger.spans_reset()
    poseidon2_cuda.reset_launches()
    try:
        out = run()
        spans, notes = logger.spans_report(), logger.notes_report()
    finally:
        logger.configure(enabled=False, echo=False)
    seconds = {k.removeprefix("snark."): round(v[0], 4) for k, v in spans.items() if k.startswith("snark.")}
    notes = {k.removeprefix("snark."): v for k, v in notes.items() if k.startswith("snark.")}
    return out, seconds, notes, dict(poseidon2_cuda.LAUNCHES), rss0


def expect_not_accepted(what: str, fn, errors):
    """``fn()`` must raise one of ``errors`` or return False."""
    try:
        accepted = fn()
    except errors as e:
        print(f"snark: {what} rejected: {type(e).__name__}: {e}", flush=True)
        return
    if accepted:
        raise AssertionError(f"snark: {what} was accepted")
    print(f"snark: {what} rejected: the pairing check failed", flush=True)


def gnark_and_solidity_check(core_vk, program, pv_bytes: bytes):
    """The gnark byte API with its own two public inputs (the vkey hash
    without its top byte, sha256 of the public values): a Groth16 proof of a
    circuit of that shape through ``verify_gnark_groth16``, and the Solidity
    verifier rendered from its gnark vk with its constants checked."""
    import hashlib
    import re

    from zkmips_tpu_torch.snark import groth16, r1cs
    from zkmips_tpu_torch.verifier import gnark, solidity, stark_codec as codec

    vkey_hash = hashlib.sha256(codec.encode_vk(core_vk, program.pc_start)).digest()
    cs = r1cs.ConstraintSystem()
    a = cs.public(int.from_bytes(vkey_hash[1:], "big"))
    b = cs.public(gnark.hash_public_inputs(pv_bytes))
    cs.assert_eq(cs.mul(a, b), cs.witness(cs.value(a) * cs.value(b)))
    pk, vk = groth16.setup(cs)
    vk_b = gnark.dump_groth16_vk(vk)
    proof_b = gnark.dump_groth16_proof(groth16.prove(pk, cs), vk_b)
    if not gnark.verify_gnark_groth16(proof_b, pv_bytes, vkey_hash.hex(), vk_b):
        raise AssertionError("snark: verify_gnark_groth16 rejected a proof of the vkey-hash circuit")
    expect_not_accepted("other public values under verify_gnark_groth16", lambda: gnark.verify_gnark_groth16(
        proof_b, pv_bytes + b"\x01", vkey_hash.hex(), vk_b), gnark.GnarkDecodeError)
    src = solidity.render_groth16_verifier(vk_b)
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"constant (\w+) = (\d+);", src)}
    want = {"ALPHA_X": vk.alpha1[0], "ALPHA_Y": vk.alpha1[1]}
    for name, pt in (("BETA", vk.beta2), ("GAMMA", vk.gamma2), ("DELTA", vk.delta2)):
        (x0, x1), (y0, y1) = pt
        want.update({f"{name}_X0": x0, f"{name}_X1": x1, f"{name}_Y0": y0, f"{name}_Y1": y1})
    for i, (kx, ky) in enumerate(vk.ic):
        want.update({f"K{i}_X": kx, f"K{i}_Y": ky})
    if any(consts.get(n) != v for n, v in want.items()) or hashlib.sha256(vk_b).digest()[:4].hex() not in src:
        raise AssertionError("snark: the Solidity verifier's constants are not the vk's")
    return vk_b, src


def check_groth16_bytes(wg, core_vk, program, pw, client) -> dict:
    """A Groth16-wrapped proof through every byte API: the proof and vk
    bytes under ``Groth16Verifier``, the wrapped container, the
    ``ProofWithPublicValues`` container into ``ProverClient.verify``, the vk
    and proof in gnark's wire format; a wrong public input, a flipped proof
    byte, a flipped gnark flag bit and a tampered wrap public value
    rejected.  Returns the byte sizes."""
    import copy

    from zkmips_tpu_torch import verifier as vf
    from zkmips_tpu_torch.sdk import ProofWithPublicValues
    from zkmips_tpu_torch.snark.outer_circuit import pack_public_values, verify_groth16
    from zkmips_tpu_torch.stark.machine import VerificationError
    from zkmips_tpu_torch.verifier import gnark

    proof_b = vf.encode_groth16_proof(wg.proof)
    vk_b = vf.encode_groth16_vk(wg.groth16_vk)
    publics = pack_public_values(wg.wrap_public_values)
    if not vf.Groth16Verifier.verify(proof_b, vk_b, vf.encode_public_inputs(publics)):
        raise AssertionError("snark groth16: Groth16Verifier rejected the proof's bytes")
    expect_not_accepted("a wrong public input", lambda: vf.Groth16Verifier.verify(
        proof_b, vk_b, vf.encode_public_inputs([publics[0] + 1] + publics[1:])), vf.VerificationFailure)
    bad = bytearray(proof_b)
    bad[5] ^= 1
    expect_not_accepted("a flipped proof byte", lambda: vf.Groth16Verifier.verify(
        bytes(bad), vk_b, vf.encode_public_inputs(publics)), vf.VerificationFailure)
    wrapped_b = vf.encode_groth16_wrapped(wg)
    back = vf.decode_groth16_wrapped(wrapped_b)
    if vf.encode_groth16_wrapped(back) != wrapped_b:
        raise AssertionError("snark groth16: the wrapped proof's bytes do not round-trip")
    assert verify_groth16(core_vk, program, back)

    pw_b = pw.to_bytes()
    if not client.verify(core_vk, ProofWithPublicValues.from_bytes(pw_b), program):
        raise AssertionError("snark groth16: ProverClient.verify rejected the container's bytes")
    tampered = copy.deepcopy(pw)
    tampered.proofs[0].wrap_public_values[0] = (tampered.proofs[0].wrap_public_values[0] + 1) % P
    expect_not_accepted("a tampered wrap public value", lambda: client.verify(core_vk, tampered, program),
                        VerificationError)

    gvk_b = gnark.dump_groth16_vk(wg.groth16_vk)
    gproof_b = gnark.dump_groth16_proof(wg.proof, gvk_b)
    gvk = gnark.load_groth16_vk(gvk_b)
    gproof = gnark.load_groth16_proof(gproof_b[4:])
    k = wg.groth16_vk
    if (gvk.alpha, gvk.beta, gvk.gamma, gvk.delta, gvk.k) != (k.alpha1, k.beta2, k.gamma2, k.delta2, k.ic) \
            or (gproof.ar, gproof.bs, gproof.krs) != (wg.proof.a, wg.proof.b, wg.proof.c):
        raise AssertionError("snark groth16: the gnark bytes do not decode to the key and proof")
    if not gnark.verify_gnark_groth16_algebraic(gvk, gproof, publics):
        raise AssertionError("snark groth16: the gnark verifier rejected the proof")
    flipped = bytearray(gvk_b)
    flipped[0] ^= 0x40  # alpha's compression flag: the other y
    expect_not_accepted("a flipped gnark flag bit", lambda: gnark.verify_gnark_groth16_algebraic(
        gnark.load_groth16_vk(bytes(flipped)), gproof, publics), gnark.GnarkDecodeError)
    gnark_vk, solidity_src = gnark_and_solidity_check(core_vk, program, bytes(pw.public_values) or b"\x00")
    return (gnark_vk, solidity_src), {"proof_bytes": len(proof_b), "vk_bytes": len(vk_b), "public_inputs": len(publics),
            "wrapped_bytes": len(wrapped_b), "container_bytes": len(pw_b), "gnark_vk_bytes": len(gvk_b),
            "gnark_proof_bytes": len(gproof_b), "solidity_chars": len(solidity_src)}


def snark_groth16_full(rp, wrapped, core_vk, program, info, card: str):
    """``--only-snark``: Groth16 over the ladder's own full-width wrap proof
    (``wrap_groth16``, what ``ProverClient.prove(mode="groth16")`` calls
    after the wrap), ``verify_groth16`` and every byte API."""
    from zkmips_tpu_torch.sdk import ProofWithPublicValues, ProverClient
    from zkmips_tpu_torch.snark.outer_circuit import verify_groth16, wrap_groth16

    def run():
        wg = wrap_groth16(rp, wrapped)
        assert verify_groth16(core_vk, program, wg)
        return wg

    wg, seconds, notes, launches, rss0 = snark_counts(run)
    rss1, peak = host_rss_gib()
    pw = ProofWithPublicValues([wg], info["public_values"], info["digest"], mode="groth16")
    _gnark, sizes = check_groth16_bytes(wg, core_vk, program, pw, ProverClient())
    print("snark groth16 (full width): " + json.dumps({
        "card": card, "constraints": notes.get("constraints"), "variables": notes.get("variables"),
        "seconds": seconds, **sizes,
        "host_rss_gib": {"before": round(rss0, 3), "after": round(rss1, 3), "peak": round(peak, 3)},
        "launches": launches}), flush=True)


# host bytes a PLONK setup and prove hold at their peak, per slot of the gate
# domain: the packed prover keeps about 25 vectors on the 4n-point quotient
# coset at 32 bytes an element (3,200 bytes a slot), beside the SRS, the
# selector and permutation polynomials, the gate lists and the R1CS
PLONK_HOST_BYTES_PER_SLOT = 5000


def host_total_bytes() -> int:
    with open("/proc/meminfo") as fh:
        return next(int(line.split()[1]) for line in fh if line.startswith("MemTotal:")) * 1024


def plonk_prove_bytes(n: int) -> int:
    """Host bytes the packed PLONK setup and prove need for a domain of
    ``n`` gates (``snark/plonk``)."""
    return PLONK_HOST_BYTES_PER_SLOT * n


def snark_plonk_full(rp, wrapped, core_vk, program, card: str):
    """``--only-snark --plonk-full``: PLONK over the full-width wrap proof.
    Each stage's seconds and counts are printed as it ends; before setup,
    the prover's memory at this domain is held against the host's, and the
    run stops there (exit code 0, a ``snark plonk (full width)`` line saying
    so) when it would not fit."""
    from zkmips_tpu_torch import verifier as vf
    from zkmips_tpu_torch.snark import outer_circuit, plonk
    from zkmips_tpu_torch.utils import logger

    host_bytes = host_total_bytes()
    reached = {}

    def run():
        circ, _key = outer_circuit._outer_circuit(rp, wrapped)
        reached["circuit_rss_gib"] = round(host_rss_gib()[0], 3)
        with logger.span("snark.gates"):
            gates = plonk.gates_from_r1cs(circ.cs)
        logger.note("snark.gates", gates.num_gates)
        reached["gates_rss_gib"] = round(host_rss_gib()[0], 3)
        n = plonk._domain_size(gates)
        reached["domain"] = n
        reached["prove_bytes_needed"] = plonk_prove_bytes(n)
        if plonk_prove_bytes(n) > 0.8 * host_bytes:
            reached["stopped"] = (f"before setup: the packed prover needs about {plonk_prove_bytes(n) / 2**30:.0f}"
                                  f" GiB at 2^{n.bit_length() - 1} gates, the host has {host_bytes / 2**30:.0f} GiB")
            return None
        del circ
        with logger.span("snark.setup"):
            pk, vk = plonk.setup(gates)
        with logger.span("snark.prove"):
            proof = plonk.prove(pk, gates)
        return outer_circuit.PlonkWrappedProof(proof, vk, [int(x) for x in wrapped.proof.public_values.tolist()],
                                               wrapped.num_shards)

    wp, seconds, notes, launches, rss0 = snark_counts(run)
    rec = {"card": card, "constraints": notes.get("constraints"), "gates": notes.get("gates"), **reached,
           "seconds": seconds, "launches": launches}
    if wp is not None:
        assert outer_circuit.verify_plonk(core_vk, program, wp)
        proof_b, vk_b = vf.encode_plonk_proof(wp.proof), vf.encode_plonk_vk(wp.plonk_vk)
        pubs = vf.encode_public_inputs(outer_circuit.pack_public_values(wp.wrap_public_values))
        if not vf.PlonkVerifier.verify(proof_b, vk_b, pubs):
            raise AssertionError("snark plonk: PlonkVerifier rejected the proof's bytes")
        rec.update({"proof_bytes": len(proof_b), "vk_bytes": len(vk_b)})
    rec["host_rss_gib"] = {"before": round(rss0, 3), "peak": round(host_rss_gib()[1], 3)}
    print("snark plonk (full width): " + json.dumps(rec), flush=True)


def e2e_fib_program(n_iters: int):
    """The fib guest of the reference's MIPS -> SNARK end-to-end test
    (``tests/test_groth16_e2e.py``) at ``n_iters`` iterations."""
    from zkmips_tpu_torch.executor import Opcode as O, Register as R, asm

    body = [
        asm.addi(R.A0, 0, n_iters), asm.addi(R.T0, 0, 0), asm.addi(R.T1, 0, 1),
        asm.alu(O.ADD, R.T2, R.T0, R.T1),
        asm.alu(O.ADD, R.T0, R.T1, R.ZERO),
        asm.alu(O.ADD, R.T1, R.T2, R.ZERO),
        asm.addi(R.A0, R.A0, -1),
        asm.branch(O.BNE, R.A0, R.ZERO, -5 * 4),
        asm.nop(),
    ]
    return asm.prog(body + asm.halt_sequence())


def sdk_phase(mode: str, card: str) -> dict:
    """``ProverClient(config=StarkConfig.test())`` on the card: the e2e fib
    guest in two shards proved with ``mode`` ("groth16" or "plonk": core,
    lift, compress, shrink and wrap on the card, the SNARK over the outer
    circuit on the host), verified, through its container bytes, a tampered
    wrap public value rejected; a Groth16 proof also through every byte API
    (``check_groth16_bytes``).  Returns the kernels' launches during the
    SNARK itself (host code: zero), and for Groth16 the gnark vk bytes of
    the byte-API check with the Solidity source rendered from them."""
    import copy

    from zkmips_tpu_torch.executor import execute_for_proving
    from zkmips_tpu_torch.ops import poseidon2_cuda
    from zkmips_tpu_torch.sdk import ProofWithPublicValues, ProverClient, ZKMStdin
    from zkmips_tpu_torch.snark import outer_circuit
    from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError

    program = e2e_fib_program(SDK_FIB_ITERS)
    if len(execute_for_proving(program, shard_size=SDK_SHARD)[0]) != 2:
        raise AssertionError("sdk: the guest does not give two shards")
    client = ProverClient(config=StarkConfig.test())
    wrap_name = "wrap_groth16" if mode == "groth16" else "wrap_plonk"
    wrap_fn = getattr(outer_circuit, wrap_name)
    snark_launches = {}

    def counted(*a, **kw):  # the launches of the SNARK alone, beside the ladder's
        before = dict(poseidon2_cuda.LAUNCHES)
        out = wrap_fn(*a, **kw)
        snark_launches.update({k: v - before.get(k, 0) for k, v in poseidon2_cuda.LAUNCHES.items()})
        return out

    def run():
        pk, vk = client.setup(program)
        setattr(outer_circuit, wrap_name, counted)
        try:
            proof = client.prove(pk, program, ZKMStdin(), shard_size=SDK_SHARD, mode=mode)
        finally:
            setattr(outer_circuit, wrap_name, wrap_fn)
        return vk, proof

    t0 = time.perf_counter()
    (vk, proof), seconds, notes, launches, _rss0 = snark_counts(run, echo=False)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    if proof.mode != mode or not client.verify(vk, proof, program):
        raise AssertionError(f"sdk {mode}: the proof was not accepted")
    seconds["verify"] = round(time.perf_counter() - t0, 4)
    b = proof.to_bytes()
    back = ProofWithPublicValues.from_bytes(b)
    if back.to_bytes() != b or not client.verify(vk, back, program):
        raise AssertionError(f"sdk {mode}: the container's bytes do not round-trip or verify")
    if mode == "groth16":
        gnark, sizes = check_groth16_bytes(proof.proofs[0], vk, program, proof, client)
    else:
        bad = copy.deepcopy(proof)
        bad.proofs[0].wrap_public_values[0] = (bad.proofs[0].wrap_public_values[0] + 1) % P
        expect_not_accepted("a tampered wrap public value", lambda: client.verify(vk, bad, program),
                            VerificationError)
        gnark, sizes = None, {"container_bytes": len(b)}
    _rss, peak = host_rss_gib()
    print(f"snark {mode} (test config): " + json.dumps({
        "card": card, **notes, "wall_seconds": round(wall, 4), "seconds": seconds, **sizes,
        "host_peak_rss_gib": round(peak, 3), "launches_whole_prove": launches,
        "launches_snark": snark_launches}), flush=True)
    return snark_launches, gnark


# --- the last slice: the mesh step, placement, the network service, the CLI ------

MESH_FIB_ITERS = 600_000  # the mesh phase's fib guest: about 3.6 M cycles, four 2^20-cycle shards
MESH_SHAPE = (4, 2)  # ('shard', 'col')
MESH_SMALL_SHARD = 64  # the card = CPU mesh check: four 64-cycle shards, as the reference's tests
MESH_SMALL_CHIPS = ("Branch", "Cpu")
NET_FIB_ITERS = 40_000  # the network phase's core-config fib: two 2^17-cycle shards
NET_SHARD = 1 << 17
CLI_ELF = "memory_sweep.elf"  # the CLI phase's fixture guest (393 cycles)
WARMUP_KNOWN_FAILURE = "mixed30k"  # ROADMAP.md queue 3: its DIVU is not one the DivRem chip proves


def mesh_grid(kind: str) -> list:
    """The ('shard', 'col') grid: the visible cards in turn (one card
    repeated when there is one), or CPU devices."""
    rows, cols = MESH_SHAPE
    if kind == "cpu":
        return [["cpu"] * cols for _ in range(rows)]
    n = torch.cuda.device_count()
    return [[torch.device("cuda", (r * cols + c) % n) for c in range(cols)] for r in range(rows)]


@functools.lru_cache(maxsize=1)
def _mips_machine():
    """The 49-chip machine whose fills make the mesh phase's traces (built
    once: its constraint DAGs take seconds)."""
    from zkmips_tpu_torch.machine.machine import MipsMachine

    return MipsMachine()


def real_shard_traces(program, shard_size: int, chip_name: str):
    """The port's counterpart of ``__graft_entry__._real_shard_traces``: the
    guest executed into shards, ``chip_name``'s trace of each (zero-padded to
    one power-of-two height, Montgomery int32 on the host), the Global
    chip's septic digest of each (Montgomery), each shard's canonical public
    values, the chip, and the executor's info."""
    from zkmips_tpu_torch import convert
    from zkmips_tpu_torch.executor import execute_for_proving
    from zkmips_tpu_torch.machine.pv import NUM_PV
    from zkmips_tpu_torch.ops import field as f
    from zkmips_tpu_torch.stark.chip import Chip, pad_to_power_of_two

    records, info = execute_for_proving(program, shard_size=shard_size)
    m = _mips_machine()
    chip_air = next(a for a in m.airs if a.name == chip_name)
    global_air = next(a for a in m.airs if a.name == "Global")
    raws, digests, pvs = [], [], []
    for r in records:
        m.generate_dependencies(r)
        raws.append(np.asarray(chip_air.generate_trace(r, None), dtype=np.uint32))
        digests.append(np.asarray(global_air.generate_trace(r, None), dtype=np.uint32)[-1, -14:])
        pvs.append(m.shard_public_values(r))
    h_max = 1 << (max([16] + [t.shape[0] for t in raws]) - 1).bit_length()
    traces = f.to_monty(convert.to_torch(np.stack([pad_to_power_of_two(t, fixed_rows=h_max) for t in raws])))
    return (traces, f.to_monty(convert.to_torch(np.stack(digests))), np.stack(pvs).astype(np.uint32),
            Chip(chip_air, num_public_values=NUM_PV), info)


def mesh_small_bytes(chip_name: str, kind: str) -> bytes:
    """The mesh step over four 64-cycle shards of the fib guest on
    ``chip_name``, on the card's grid or the CPU's: every output's bytes."""
    from zkmips_tpu_torch import convert
    from zkmips_tpu_torch.parallel import kernels as mk

    program = fib_program((MESH_SMALL_SHARD * 4 - 24) // 7)
    traces, digests, pvs, chip, _info = real_shard_traces(program, MESH_SMALL_SHARD, chip_name)
    states0 = torch.stack([mk.transcript_prefix_state(pv) for pv in pvs])
    out = mk.make_multichip_step(mesh_grid(kind), chip=chip)(traces, digests, pvs, states0)
    return b"".join(convert.to_numpy(out[k]).tobytes() for k in sorted(out))


def mesh_phase(args, dev, card: str, cpu) -> dict:
    """The mesh step at full width: the fib guest's Cpu-chip traces in four
    2^20-row shards over a 4 x 2 grid of the visible cards, held shard by
    shard against the port's ``host_stage_reference`` on the card, whose
    trees the plain Poseidon2 hashes (K1 and K2 at the step's commit and
    fold shapes against their plain versions); the septic identity on the gathered digests, a tampered word rejected; K1 at
    the step's widest leaf against its plain version; then the card's step
    against the CPU's at 64-cycle shards (Branch and Cpu chips).  Returns
    the kernels' launches over the step."""
    from zkmips_tpu_torch.ops import field as f, poseidon2_cuda
    from zkmips_tpu_torch.parallel import kernels as mk

    if cpu is None:
        raise AssertionError("mesh: the CPU side is needed for the card = CPU check")
    program = fib_program(MESH_FIB_ITERS)
    t0 = time.perf_counter()
    traces, digests, pvs, chip, info = real_shard_traces(program, FULL_SHARD_CYCLES, "Cpu")
    traces_s = time.perf_counter() - t0
    s, h, w = traces.shape
    if s != MESH_SHAPE[0] or h != FULL_SHARD_CYCLES:
        raise AssertionError(f"mesh: {s} shards of {h} rows, not {MESH_SHAPE[0]} of {FULL_SHARD_CYCLES}")
    grid = mesh_grid("cuda")
    states0 = torch.stack([mk.transcript_prefix_state(pv) for pv in pvs])
    step = mk.make_multichip_step(grid, chip=chip)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    poseidon2_cuda.reset_launches()
    t0 = time.perf_counter()
    out = step(traces, digests, pvs, states0)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches, shapes = dict(poseidon2_cuda.LAUNCHES), set(poseidon2_cuda.HASH_SHAPES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in ("poseidon2_hash_rows", "poseidon2_compress"):
        if launches[name] == 0:
            raise AssertionError(f"mesh: kernel {name} was not launched by the mesh step")
    t0 = time.perf_counter()
    poseidon2_cuda.reset_launches()
    keys = (("main_roots", "main_root"), ("perm_roots", "perm_root"), ("quotient_roots", "quotient_root"),
            ("fold_roots", "fold_roots"), ("final_polys", "final_poly"), ("cum_sums", "cum_sum"),
            ("states", "state"))
    for i in range(s):
        ref = mk.host_stage_reference(chip, traces[i].to(dev), pvs[i])
        for key, ref_key in keys:
            if not torch.equal(out[key][i].cpu(), ref[ref_key].cpu()):
                raise AssertionError(f"mesh: {key} of shard {i} differs from the plain host replay")
    replay_s = time.perf_counter() - t0
    if any(poseidon2_cuda.LAUNCHES.values()):
        raise AssertionError(f"mesh: the plain host replay launched kernels: {dict(poseidon2_cuda.LAUNCHES)}")
    if not mk.septic_identity_host(out["all_digests"]):
        raise AssertionError("mesh: the septic identity rejected the gathered digests")
    bad = out["all_digests"].clone()
    bad[1, 3] = f.to_monty_int(12345)
    if mk.septic_identity_host(bad):
        raise AssertionError("mesh: the septic identity accepted a tampered digest")
    print("mesh step: " + json.dumps({
        "card": card, "guest_cycles": info["global_clk"], "chip": "Cpu", "shards": s, "rows": h, "width": w,
        "mesh": list(MESH_SHAPE), "devices": sorted({str(d) for row in grid for d in row}),
        "seconds": {"traces": round(traces_s, 4), "step": round(step_s, 4), "host_replay": round(replay_s, 4)},
        "peak_gib": round(peak, 3), "launches": launches, "fold_layers": int(out["fold_roots"].shape[1]),
    }), flush=True)
    print("mesh: every output equals the plain host replay shard by shard (its trees hashed by the plain "
          "torch Poseidon2, no kernel launched); the septic identity accepted the gathered digests and "
          "rejected a tampered word", flush=True)
    widest_leaf_check("the mesh step's", shapes, args.seed + 10, dev, card)
    for name in MESH_SMALL_CHIPS:
        t0 = time.perf_counter()
        if mesh_small_bytes(name, "cuda") != cpu.get(f"mesh_{name}"):
            raise AssertionError(f"mesh small: the card's step on the {name} chip differs from the CPU's")
        print(f"mesh small: {name} chip, four {MESH_SMALL_SHARD}-cycle shards on a {MESH_SHAPE[0]} x "
              f"{MESH_SHAPE[1]} grid, card and CPU outputs equal (card {time.perf_counter() - t0:.3f} s)",
              flush=True)
    return launches


def placement_check(machine, pk, records, proofs, card: str) -> dict:
    """``MipsMachine.prove(devices=...)`` over the ladder's core shards: every
    visible card, at least two entries (the one card twice): the bytes must
    be the single-device proofs'.  With two cards or more, K1 is also
    launched on card 1 from a thread whose current device is 0.  Returns the
    kernels' launches over the placed prove."""
    from zkmips_tpu_torch.ops import poseidon2_cuda
    from zkmips_tpu_torch.verifier import stark_codec as codec

    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(n)] if n >= 2 else ["cuda:0", "cuda:0"]
    want = codec.encode_core_proof(proofs)
    torch.cuda.synchronize()
    poseidon2_cuda.reset_launches()
    t0 = time.perf_counter()
    placed = machine.prove(pk, records, devices=devices)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(poseidon2_cuda.LAUNCHES)
    if codec.encode_core_proof(placed) != want:
        raise AssertionError("placement: the placed proofs' bytes differ from the single-device proofs'")
    for name, k in launches.items():
        if k == 0:
            raise AssertionError(f"placement: kernel {name} was not launched")
    print(f"placement: {len(placed)} shards proved with devices={devices} in {wall:.3f} s, bytes equal to "
          f"the single-device proofs ({len(want)} bytes); launches {launches} [{card}]", flush=True)
    if n < 2:
        print("placement: one card, so a launch on a second card from a thread whose current device is 0 "
              "was not exercised", flush=True)
        return launches
    import threading

    from zkmips_tpu_torch.ops import poseidon2 as p2

    m = rand_field(np.random.default_rng(12), (1 << 16, 85), torch.device("cuda", 1))
    got = {}

    def launch():
        try:
            torch.cuda.set_device(0)
            got["out"] = poseidon2_cuda.hash_rows(m)
        except Exception as e:  # re-raised in the main thread
            got["error"] = e

    t = threading.Thread(target=launch)
    t.start()
    t.join()
    if "error" in got:
        raise got["error"]
    err = max_err(got["out"], p2.hash_matrix_rows_plain(m))
    if err != 0 or got["out"].device != m.device:
        raise AssertionError("placement: K1 on card 1 from a thread on card 0 disagrees with its plain version")
    print(f"placement: K1 launched on cuda:1 from a thread whose current device is 0, max_abs_err {err}",
          flush=True)
    return launches


def network_phase(card: str):
    """A ``ProverServer`` at the core config and one at the test config on
    the card, in background threads, with ``ZKM_NETWORK_KEY`` set; the client
    in a subprocess with CUDA hidden (``--network-client``).  The served core
    proofs' bytes must equal the local ones, and the served shrink proof
    must be accepted here."""
    import secrets

    from zkmips_tpu_torch.executor import execute_for_proving
    from zkmips_tpu_torch.sdk import ProverClient
    from zkmips_tpu_torch.sdk.network import ProverServer
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.verifier import stark_codec as codec

    out = os.path.join(ROOT, "build", "chip_smoke_net")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    os.environ["ZKM_NETWORK_KEY"] = secrets.token_hex(16)
    servers = [ProverServer(ProverClient(config=StarkConfig.core())),
               ProverServer(ProverClient(config=StarkConfig.test()))]
    try:
        for srv in servers:
            srv.serve_background()
        program = fib_program(NET_FIB_ITERS)
        local = servers[0].client
        pk, _vk = local.setup(program)
        records, _ = execute_for_proving(program, shard_size=NET_SHARD)
        t0 = time.perf_counter()
        want = codec.encode_core_proof(local.machine.prove(pk, records))
        local_s = time.perf_counter() - t0
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--network-client", out,
                               *[f"http://127.0.0.1:{srv.port}" for srv in servers]],
                              env=env, capture_output=True, text=True, timeout=900)
        client_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(line, flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"network: the client exited with {proc.returncode}: {proc.stderr[-3000:]}")
        with open(os.path.join(out, "core.bin"), "rb") as fh:
            if fh.read() != want:
                raise AssertionError("network: the served core proofs' bytes differ from the local proofs'")
        sdk = e2e_fib_program(SDK_FIB_ITERS)
        _pk, vk = servers[1].client.setup(sdk)
        with open(os.path.join(out, "shrink.bin"), "rb") as fh:
            sh, _cfg = codec.decode_compressed_proof(fh.read())
        if not servers[1].client._recursion_prover().verify_compressed(vk, sdk, sh):
            raise AssertionError("network: the served shrink proof was not accepted")
        print(f"network: served core proofs equal the local ones ({len(want)} bytes; local prove "
              f"{local_s:.3f} s), the served shrink proof accepted; client process {client_s:.3f} s "
              f"[{card}]", flush=True)
    finally:
        for srv in servers:
            srv.shutdown()
        del os.environ["ZKM_NETWORK_KEY"]


def network_client(out: str, core_url: str, test_url: str) -> int:
    """The network phase's client, in a process without a GPU: the core
    server's /setup and /prove_core of the fib; the test server's /setup,
    /prove, /verify, then /prove_core -> /compress -> /shrink -> /wrap; a
    failing job must raise; an unsigned POST must get 403."""
    import http.client
    import pickle

    from zkmips_tpu_torch.sdk import ProverClient, ZKMStdin
    from zkmips_tpu_torch.sdk.network import NetworkProver
    from zkmips_tpu_torch.verifier import stark_codec as codec

    if torch.cuda.is_available():
        raise AssertionError("network client: a GPU is visible")
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        seconds[name] = round(time.perf_counter() - t0, 4)
        return r

    core = NetworkProver(core_url)
    if not core.ready() or core.config != "core":
        raise AssertionError("network client: the core server is not ready")
    program = fib_program(NET_FIB_ITERS)
    pk, _vk = timed("core /setup", lambda: core.setup(program))
    proofs = timed("core /prove_core", lambda: core.prove_core(pk, program, shard_size=NET_SHARD))
    with open(os.path.join(out, "core.bin"), "wb") as fh:
        fh.write(codec.encode_core_proof(proofs))

    client = ProverClient(backend="network", endpoint=test_url)
    sdk = e2e_fib_program(SDK_FIB_ITERS)
    pk, vk = timed("test /setup", lambda: client.setup(sdk))
    proof = timed("test /prove", lambda: client.prove(pk, sdk, ZKMStdin(), shard_size=SDK_SHARD))
    if not timed("test /verify", lambda: client.verify(vk, proof, sdk)):
        raise AssertionError("network client: /verify rejected the served proof")
    shards = timed("test /prove_core", lambda: client.remote.prove_core(pk, sdk, shard_size=SDK_SHARD))
    if codec.encode_core_proof(shards, config="test") != codec.encode_core_proof(proof.proofs, config="test"):
        raise AssertionError("network client: /prove_core and /prove gave different shard proofs")
    cp = timed("test /compress", lambda: client.remote.compress(vk, shards))
    sh = timed("test /shrink", lambda: client.remote.shrink(cp))
    wp = timed("test /wrap", lambda: client.remote.wrap(sh))
    if (cp.stage, sh.stage, wp.stage) != ("compress", "shrink", "wrap"):
        raise AssertionError("network client: the ladder's stages came back wrong")
    with open(os.path.join(out, "shrink.bin"), "wb") as fh:
        fh.write(codec.encode_compressed_proof(sh, config="test"))
    try:
        client.prove(None, sdk, ZKMStdin(), shard_size=SDK_SHARD)
    except RuntimeError as e:
        if "remote job failed" not in str(e):
            raise
    else:
        raise AssertionError("network client: a failing job did not raise")
    conn = http.client.HTTPConnection(test_url[len("http://"):], timeout=60)
    conn.request("POST", "/setup", body=pickle.dumps({"program": sdk}))
    status = conn.getresponse().status
    conn.close()
    if status != 403:
        raise AssertionError(f"network client: an unsigned POST got {status}, not 403")
    print("network client: " + json.dumps({
        "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "core_shards": len(proofs),
        "seconds": seconds, "failing_job": "raised", "unsigned_post": status}), flush=True)
    return 0


def synthetic_gnark_vk() -> tuple:
    """gnark vk bytes of a key made of fixed curve points (for ``--only-cli``,
    which has no SDK phase), and the Solidity source rendered in-process."""
    import types

    from zkmips_tpu_torch.snark import bn254_curve as ec
    from zkmips_tpu_torch.verifier import gnark, solidity

    vk = types.SimpleNamespace(
        alpha1=ec.g1_mul(ec.G1_GEN, 3), beta2=ec.g2_mul(ec.G2_GEN, 5), gamma2=ec.g2_mul(ec.G2_GEN, 7),
        delta2=ec.g2_mul(ec.G2_GEN, 11), ic=[ec.g1_mul(ec.G1_GEN, k) for k in (13, 17, 19)])
    vk_b = gnark.dump_groth16_vk(vk)
    return vk_b, solidity.render_groth16_verifier(vk_b)


def cli_phase(card: str, gnark: tuple, warmup: bool, env: dict):
    """Subprocesses of ``python3 -m zkmips_tpu_torch.cli`` (environment
    ``env``) on the card, all at once: execute, vkey, prove (core config:
    the bytes of the client's proof in this process), prove --config test
    --mode compressed (its container decoded here), verify of this process's
    proof and of it with a flipped byte (exit 1), serve with prove
    --endpoint (the served proof verified here), and solidity-verifier on
    ``gnark``'s vk bytes (the source rendered in this process).  With
    ``warmup``, ``warmup --quick`` runs beside them and must fail on exactly
    the corpus's ``mixed30k`` guest."""
    from zkmips_tpu_torch.executor import Program
    from zkmips_tpu_torch.sdk import ProofWithPublicValues, ProverClient
    from zkmips_tpu_torch.stark.machine import StarkConfig

    d = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    elf = os.path.join(ROOT, FIXTURES, CLI_ELF)
    path = {k: os.path.join(d, f"{k}.bin") for k in ("mine", "bad", "core", "compressed", "net")}
    procs = {}

    def start(name, *argv):
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "zkmips_tpu_torch.cli", *argv], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def finish(name, rc: int = 0) -> str:
        t0, p = procs.pop(name)
        out, err = p.communicate(timeout=900)
        if p.returncode != rc:
            raise AssertionError(f"cli {name}: exit code {p.returncode}, not {rc}: {out[-3000:]}{err[-3000:]}")
        print(f"cli {name}: exit {p.returncode} in {time.perf_counter() - t0:.1f} s: "
              + " | ".join(out.strip().splitlines()[-3:]), flush=True)
        return out

    serve = None
    try:
        t_phase = time.perf_counter()
        serve = subprocess.Popen([sys.executable, "-m", "zkmips_tpu_torch.cli", "serve", "--port", "0",
                                  "--config", "test"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        if warmup:
            start("warmup --quick", "warmup", "--quick")
        start("execute", "execute", elf)
        start("vkey", "vkey", elf)
        start("prove", "prove", elf, "-o", path["core"])
        start("prove compressed", "prove", elf, "-o", path["compressed"], "--config", "test", "--mode", "compressed")
        vk_bin = os.path.join(d, "groth16_vk.bin")
        with open(vk_bin, "wb") as fh:
            fh.write(gnark[0])
        start("solidity-verifier", "solidity-verifier", vk_bin, "-o", os.path.join(d, "ZKMVerifier.sol"))
        program = Program.from_elf(open(elf, "rb").read())
        local = ProverClient(config=StarkConfig.core())
        pk, vk = local.setup(program)
        mine = local.prove(pk, program).to_bytes()
        bad = bytearray(mine)
        bad[len(bad) // 2] ^= 1
        for key, data in (("mine", mine), ("bad", bytes(bad))):
            with open(path[key], "wb") as fh:
                fh.write(data)
        start("verify", "verify", elf, path["mine"])
        start("verify flipped byte", "verify", elf, path["bad"])
        line = serve.stdout.readline()
        if "listening on http://" not in line:
            raise AssertionError(f"cli serve: {line!r} {serve.stderr.read()[-3000:] if serve.poll() else ''}")
        start("prove --endpoint", "prove", elf, "-o", path["net"], "--endpoint", line.strip().rsplit(" ", 1)[-1])

        rep = local.execute(program)
        want = f"cycles={rep.total_instruction_count} exit={rep.exit_code}\n"
        if rep.public_values:
            want += f"public_values: {rep.public_values.hex()}\n"
        if finish("execute") != want:
            raise AssertionError("cli execute: the output is not the client's report")
        if finish("vkey") != "vk: " + "-".join(f"{int(x):08x}" for x in vk.prep_root) + "\n":
            raise AssertionError("cli vkey: the line is not the verifying key's")
        finish("prove")
        with open(path["core"], "rb") as fh:
            if fh.read() != mine:
                raise AssertionError("cli prove: the proof's bytes are not the client's in this process")
        finish("prove compressed")
        # another process verifies a compressed proof only with the prover's vk map (as the
        # reference's): here its bytes are decoded and re-encoded
        with open(path["compressed"], "rb") as fh:
            compressed = fh.read()
        back = ProofWithPublicValues.from_bytes(compressed)
        if back.mode != "compressed" or back.proofs[0].stage != "compress" or back.to_bytes() != compressed:
            raise AssertionError("cli prove --mode compressed: the file is not a compress proof's container")
        if "verification: OK" not in finish("verify"):
            raise AssertionError("cli verify: the proof was not accepted")
        if "verification: FAILED" not in finish("verify flipped byte", rc=1):
            raise AssertionError("cli verify: the flipped byte was not reported")
        finish("prove --endpoint")
        test_client = ProverClient(config=StarkConfig.test())
        _pk, test_vk = test_client.setup(program)
        if not test_client.verify(test_vk, ProofWithPublicValues.load(path["net"]), program):
            raise AssertionError("cli prove --endpoint: the served proof was not accepted")
        finish("solidity-verifier")
        with open(os.path.join(d, "ZKMVerifier.sol")) as fh:
            if fh.read() != gnark[1]:
                raise AssertionError("cli solidity-verifier: the source is not the one rendered in-process")
        if warmup:
            # the corpus's mixed30k guest (a copy of the reference's) encodes DIVU with rd = $t7;
            # the DivRem chip models rd = 32 (HI/LO), so its LogUp sums do not balance in either
            # package: warmup must report exactly that guest and exit 1
            out = finish("warmup --quick", rc=1)
            failed = [ln for ln in out.splitlines() if ": FAILED" in ln]
            if len(failed) != 1 or not failed[0].startswith(f"warm {WARMUP_KNOWN_FAILURE}: FAILED") \
                    or "local cumulative sums do not balance" not in failed[0]:
                raise AssertionError(f"cli warmup --quick: unexpected failures {failed}")
        print(f"cli: every subcommand passed in {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    finally:
        for _t0, p in procs.values():
            p.kill()
            p.wait()
        if serve is not None:
            serve.terminate()
            serve.wait(timeout=60)


# --- the repository's programs: zkmips_tpu_torch/examples ----------------------------

QUICK_EXAMPLES = ("fibonacci", "io", "is_prime", "large_sum", "sha256_precompile", "keccak_precompile",
                  "poseidon2_precompile", "uint256_mul", "cycle_tracking", "unconstrained", "elf_build",
                  "real_guest")
EXAMPLES = QUICK_EXAMPLES + ("compressed", "aggregation", "groth16", "plonk", "sound_ladder")
EXAMPLE_ARGV = {  # real_guest's and the sound ladder's compiled guests: fixtures of the tests
    "real_guest": ["--elf", os.path.join(FIXTURES, "memory_sweep.elf")],
    "sound_ladder": ["--elf", os.path.join(FIXTURES, "sha256_chain.elf")],
}
# the test config's outer circuit has 8,730,955 PLONK gates: a 2^24 domain
SDK_PLONK_DOMAIN = 1 << 24


def _printable(value):
    """What an example returned, without its proof objects."""
    if isinstance(value, dict):
        return {str(k): _printable(v) for k, v in value.items() if k not in ("proof", "vk")}
    if isinstance(value, (list, tuple)):
        return [_printable(v) for v in value]
    if isinstance(value, bytes):
        return value.hex()
    return value if isinstance(value, (int, float, str, bool, type(None))) else repr(value)


def run_example(name: str, card: str) -> dict:
    """One program of ``zkmips_tpu_torch/examples`` on the card through its
    ``main`` (its own assertions hold or it raises); prints its wall, peak
    device memory, the kernels' launches from 0 and what it returned."""
    import importlib

    from zkmips_tpu_torch.ops import poseidon2_cuda

    argv = [os.path.join(ROOT, a) if a.startswith(FIXTURES) else a for a in EXAMPLE_ARGV.get(name, [])]
    if name == "plonk":
        host = host_total_bytes()
        if plonk_prove_bytes(SDK_PLONK_DOMAIN) > 0.8 * host:
            print(f"example plonk: not run: the packed prover needs about "
                  f"{plonk_prove_bytes(SDK_PLONK_DOMAIN) / 2**30:.0f} GiB at 2^24 gates, the host has "
                  f"{host / 2**30:.0f} GiB [{card}]", flush=True)
            return {}
    mod = importlib.import_module(f"zkmips_tpu_torch.examples.{name}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    poseidon2_cuda.reset_launches()
    t0 = time.perf_counter()
    out = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(poseidon2_cuda.LAUNCHES)
    if name != "cycle_tracking" and not all(launches.values()):  # cycle_tracking only executes
        raise AssertionError(f"example {name}: a kernel was not launched: {launches}")
    if name == "real_guest" and not out.get("present"):
        raise AssertionError("example real_guest: the fixture ELF was not found")
    print(f"example {name}: " + json.dumps({
        "card": card, "wall_seconds": round(wall, 4), "launches": launches,
        "peak_device_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "returned": _printable(out)}), flush=True)
    return {"wall": wall, "launches": launches, "out": out}


def example_fibonacci_cpu_bytes() -> bytes:
    """The ``fibonacci`` example's proof bytes from its ``--cpu`` run; the
    card's come from the examples phase."""
    from zkmips_tpu_torch.examples import fibonacci

    return fibonacci.main(["--cpu"])["proof"].to_bytes()


def run_examples(names, card: str, fib_bytes_out: str | None = None):
    """``--only-examples``: each named program in turn through
    ``run_example``, then a summary line; with ``fib_bytes_out`` (the
    examples phase of the whole run) ``fibonacci``'s proof bytes are
    written there for the card = CPU check."""
    t0 = time.perf_counter()
    runs = {name: run_example(name, card) for name in names}
    wall = time.perf_counter() - t0
    total = {}
    for r in runs.values():
        for k, v in r.get("launches", {}).items():
            total[k] = total.get(k, 0) + v
    if fib_bytes_out:
        tmp = fib_bytes_out + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(runs["fibonacci"]["out"]["proof"].to_bytes())
        os.replace(tmp, fib_bytes_out)
    print(f"examples: {len(runs)} programs passed their own checks in {wall:.1f} s, launches {total} "
          f"[{card}]", flush=True)


class SideProcess:
    """The phases of the whole run whose launches the kernels line does not
    read: the six fixture ELFs, the every-chip guest (card = CPU) and the
    examples phase (the twelve quick programs, each called through its
    ``main``, its launches its own counts from 0), in a third process of
    this script (``--side DIR``).  It starts as the ladder's wrap starts:
    from there the main process is mostly host code (the wrap's BN254
    hashing, the SDK phase's SNARK) and the card idle; it is waited for
    after the SDK phase.  Then ``fibonacci``'s proof bytes against the CPU
    process's."""

    def __init__(self, cpu: CpuSide):
        self.cpu = cpu
        self.proc = None
        self.log_path = os.path.join(cpu.dir, "side.log")

    def start(self):
        if self.proc is None:
            self.t0 = time.perf_counter()
            self.log = open(self.log_path, "w")
            self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--side", self.cpu.dir],
                                         stdout=self.log, stderr=subprocess.STDOUT)

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def finish(self, card: str):
        if self.proc is None:
            raise AssertionError("the ladder ended without starting the side process")
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=900)
        finally:
            self.stop()
            self.log.close()
        with open(self.log_path) as fh:
            lines = fh.read().splitlines()
        for line in lines[1:]:  # its first line is the card's, then the build's as above
            if not line.startswith(("build:", "ptxas:", "sass:")):
                print(line, flush=True)
        if rc != 0:
            raise AssertionError(f"the side process exited with {rc}")
        with open(side_fib_path(self.cpu.dir), "rb") as fh:
            if fh.read() != self.cpu.get("example_fibonacci"):
                raise AssertionError("examples: fibonacci's proof on the card differs from the CPU's")
        print(f"side process: wall {time.perf_counter() - self.t0:.1f} s beside the wrap and the SDK phase, "
              f"waited {time.perf_counter() - t0:.1f} s after them; examples: fibonacci's proof bytes equal "
              f"on card and CPU [{card}]", flush=True)


def side_fib_path(out: str) -> str:
    return os.path.join(out, "example_fibonacci_card.bin")


def side_phases(out: str, dev, card: str):
    """``--side DIR``: what ``SideProcess`` runs, each part's wall printed."""
    clock = PhaseClock(time.perf_counter())
    elf_phase(dev, card)
    every_chip_phase(dev, card, CpuSide.attach(out))
    clock.done("full machine: the ELFs and the every-chip guest (side process)")
    run_examples(QUICK_EXAMPLES, card, side_fib_path(out))
    clock.done("examples (side process)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-rows", type=int, default=18,
                    help="log2 rows of the synthetic shard's Cpu/AddSub-shaped chips")
    ap.add_argument("--fib-iters", type=int, default=60_000,
                    help="iterations of the fib phase's guest (6 cycles each)")
    ap.add_argument("--stream-fib-iters", type=int, default=200_000,
                    help="iterations of the streaming phase's fib guest (6 cycles each)")
    ap.add_argument("--keccak-iters", type=int, default=1365,
                    help="iterations of the full-machine phase's keccak-chain guest (24 KeccakSponge rows each)")
    ap.add_argument("--ladder-fib-iters", type=int, default=180_000,
                    help="iterations of the recursion ladder's fib guest (two 2^20-cycle shards at the default)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--only-kernels", action="store_true",
                      help="stop after the kernel phase and its kernels line (exit code 0, no last line)")
    only.add_argument("--only-full", action="store_true",
                      help="run the full-machine phase alone (exit code 0, no kernels line, no last line)")
    only.add_argument("--only-recursion", action="store_true",
                      help="run the recursion phase alone (exit code 0, no kernels line, no last line)")
    only.add_argument("--only-snark", action="store_true",
                      help="run the ladder and Groth16 over its full-width wrap proof alone "
                           "(exit code 0, no kernels line, no last line)")
    only.add_argument("--only-sdk", choices=("groth16", "plonk"),
                      help="run the SDK phase alone in this mode (exit code 0, no kernels line, no last line)")
    only.add_argument("--only-mesh", action="store_true",
                      help="run the mesh phase alone (exit code 0, no kernels line, no last line)")
    only.add_argument("--only-network", action="store_true",
                      help="run the network phase alone (exit code 0, no kernels line, no last line)")
    only.add_argument("--only-cli", action="store_true",
                      help="run the CLI phase alone, with warmup --quick (exit code 0, no kernels line, "
                           "no last line)")
    only.add_argument("--only-examples", nargs="+", metavar="NAME", choices=EXAMPLES,
                      help="run these programs of zkmips_tpu_torch/examples alone (exit code 0, no kernels "
                           "line, no last line)")
    only.add_argument("--cpu-side", metavar="DIR", help=argparse.SUPPRESS)  # the second process
    only.add_argument("--side", metavar="DIR", help=argparse.SUPPRESS)  # the side process (SideProcess)
    only.add_argument("--network-client", nargs=3, metavar=("DIR", "CORE_URL", "TEST_URL"),
                      help=argparse.SUPPRESS)  # the network phase's client process, without a GPU
    ap.add_argument("--plonk-full", action="store_true",
                    help="with --only-snark: PLONK over the full-width wrap proof in place of Groth16")
    args = ap.parse_args()
    if args.plonk_full and not args.only_snark:
        ap.error("--plonk-full goes with --only-snark")

    if args.network_client:
        return network_client(*args.network_client)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.cpu_side:
        cpu_side(args.cpu_side, args.seed)
        return 0
    import zkmips_tpu_torch  # noqa: F401  (fails here, before any phase, without the package)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    cpu = None if args.only_kernels or args.only_snark or args.only_sdk or args.only_network \
        or args.only_cli or args.only_examples or args.side else CpuSide(args)
    finished = False
    try:
        finished = run_phases(args, dev, rng, card, cpu)
    finally:
        if cpu is not None:
            cpu.close(finished)
    if finished:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}), flush=True)
    return 0


class PhaseClock:
    """Prints each phase's wall and the script's so far."""

    def __init__(self, t_start: float):
        self.t_start = self.t_last = t_start

    def done(self, phase: str):
        now = time.perf_counter()
        print(f"phase {phase}: {now - self.t_last:.1f} s (script {now - self.t_start:.1f} s)", flush=True)
        self.t_last = now


def run_phases(args, dev, rng, card: str, cpu) -> bool:
    """Every phase of the run; True when the whole script ran (the kernels
    line printed), False after an ``--only-*`` part."""
    from zkmips_tpu_torch.ops import poseidon2_cuda
    from zkmips_tpu_torch.stark.machine import VerificationError
    from zkmips_tpu_torch.utils import logger

    t_script = t0 = time.perf_counter()
    lib = poseidon2_cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    sass = poseidon2_cuda.sass_counts(lib)
    if sass:  # per kernel: all machine instructions, and the twelve commonest opcodes
        sass = {k: {"total": v["total"], "by_op": dict(list(v["by_op"].items())[:12])} for k, v in sass.items()}
    print("sass: " + (json.dumps(sass) if sass else "cuobjdump not found, instructions not counted"), flush=True)

    if args.only_full:
        keccak_phase(args, dev, card)
        elf_phase(dev, card)
        every_chip_phase(dev, card, cpu)
        return False
    if args.side:
        side_phases(args.side, dev, card)
        return False
    if args.only_recursion or args.only_snark:
        recursion_phase(args, dev, card, cpu)
        return False
    if args.only_sdk:
        sdk_phase(args.only_sdk, card)
        return False
    if args.only_mesh:
        mesh_phase(args, dev, card, cpu)
        return False
    if args.only_network:
        network_phase(card)
        return False
    if args.only_cli:
        cli_phase(card, synthetic_gnark_vk(), True, dict(os.environ))
        return False
    if args.only_examples:
        run_examples(args.only_examples, card)
        return False

    machine = build_machine()
    for c in machine.chips:
        print(f"chip {c!r} lqd={c.log_quotient_degree} constraints={len(c.constraints)}", flush=True)
    cpu_w = machine.chip_map["CpuShaped"].main_width
    add_w = machine.chip_map["AddSubShaped"].main_width
    records = kernel_phase(dev, rng, cpu_w + add_w, card)
    if args.only_kernels:
        print_kernels(records)
        return False

    # main path
    t0 = time.perf_counter()
    record, pv = build_record(args.log_rows, args.seed)
    cells = sum(t.size for t in record.values())
    print(f"workload: 2^{args.log_rows} rows, {cells} trace cells, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    logger.configure(enabled=True, sync=True, echo=False)
    t0 = time.perf_counter()
    pk = machine.setup(None)
    torch.cuda.synchronize()
    print(f"setup: {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    logger.spans_reset()
    torch.cuda.reset_peak_memory_stats()
    poseidon2_cuda.reset_launches()
    t0 = time.perf_counter()
    proof = machine.prove_shard(pk, record, pv)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(poseidon2_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    logger.configure(enabled=False)
    stages = {k: round(v[0], 4) for k, v in logger.spans_report().items()}
    print(f"prove_shard: {prove_s:.3f} s, peak device memory {peak_gb:.2f} GiB [{card}]", flush=True)
    print("stages: " + json.dumps({"card": card, "seconds": stages}), flush=True)
    print(f"launches on the synthetic shard's path: {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the synthetic shard's path")

    t0 = time.perf_counter()
    assert machine.verify_shard(pk.vk, proof)
    print(f"verify_shard: accepted in {time.perf_counter() - t0:.3f} s", flush=True)
    bad = proof.opened[0].main_local.clone()
    bad[0, 0] ^= 1
    proof.opened[0].main_local = bad
    try:
        machine.verify_shard(pk.vk, proof)
    except VerificationError as e:
        print(f"tampered proof rejected: {e}", flush=True)
    else:
        raise AssertionError("a tampered proof was accepted")
    del proof, pk, record

    # a small shard on the card and on the CPU must give the same proof
    small, small_pv = build_record(8, args.seed + 1)
    t0 = time.perf_counter()
    if small_proof(machine, small, small_pv, dev) != cpu.get("small_shard"):
        raise AssertionError("the card's proof of the small shard differs from the CPU's")
    print(f"small shard: card and CPU proofs equal ({time.perf_counter() - t0:.1f} s)", flush=True)
    del small, machine

    clock = PhaseClock(t_script)
    for name, n in mips_phase(args, dev, card, cpu).items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the fib path")
    clock.done("kernels, synthetic shard and fib")
    for name, n in stream_phase(args, dev, card).items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the streaming path")
    stream_keccak_phase(dev, card)
    recursion_configs_phase(args, dev, card, cpu)
    clock.done("streaming")
    for name, n in keccak_phase(args, dev, card).items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the keccak path")
        records[name]["launches"] = n
    clock.done("full machine: the keccak chain (the ELFs and the every-chip guest in the side process)")
    side = SideProcess(cpu)
    try:
        ladder = recursion_phase(args, dev, card, cpu, beside=side.start)
        clock.done("recursion (the side process started with the wrap)")
        for name in records:
            records[name]["ladder_launches"] = {stage: ladder[stage][name] for stage in LADDER_STAGES}
            if sum(records[name]["ladder_launches"].values()) == 0:
                raise AssertionError(f"kernel {name} was not launched on the recursion ladder")
        snark, gnark = sdk_phase("groth16", card)
        clock.done("sdk groth16")
        side.finish(card)
    finally:
        side.stop()
    clock.done("side process (what was left of it after the SDK phase)")
    for name in records:
        records[name]["snark_launches"] = snark.get(name, 0)
        records[name]["placement_launches"] = ladder["placement"][name]
    mesh = mesh_phase(args, dev, card, cpu)
    clock.done("mesh")
    for name in records:
        records[name]["mesh_launches"] = mesh[name]
    # the CLI's processes run beside the network phase: neither reads the launch counts
    from zkmips_tpu_torch.utils.pool import make_pool

    with make_pool(1) as pool:
        cli = pool.submit(cli_phase, card, gnark, False, dict(os.environ))
        network_phase(card)
        cli.result()
    clock.done("network and cli")
    cpu.close(True)
    print_kernels(records)
    return True


if __name__ == "__main__":
    sys.exit(main())
