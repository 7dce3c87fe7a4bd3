#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--log-rows K] [--fib-iters N] [--stream-fib-iters N]
                          [--keccak-iters N] [--only-kernels | --only-full]

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
   iterations, default 400,000, about 2,400,000 cycles: three 2^20-cycle
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
   ``bench.py`` (``--keccak-iters`` iterations, default 2,730: 65,520
   KeccakSponge rows, about 161,000 cycles in one 2^20-cycle shard) runs
   through ``execute_for_proving`` (the Python interpreter: the native
   executor has no precompiles), is proved by ``mips_machine()`` (the 49
   chips, core config, fixed shapes) on the card and verified; a flipped
   word of KeccakSponge's opened values must be rejected; K1 is held
   against its plain version at the widest leaf shape this prove gave it.
   The kernels' launch counts of the ``kernels`` line are those of this
   prove; each shard's pooled trace fills are printed in thread seconds
   beside the wall of ``prove.trace_gen``.  Then the six fixture ELFs of ``tests/fixtures/guests`` are
   loaded, executed, proved on the card at the core config and verified;
   and a guest that gives every one of the 49 chips rows is proved at the
   test config on the card and on the CPU, and the two proofs must be equal.
   ``--only-full`` runs the card line, the build and this phase alone
   (exit code 0, no ``kernels`` line and no last line);
9. prints one JSON line with every kernel's record (``{"kernels": [...]}``)
   and, last, ``{"ok": true, "device": {...}}``.

It exits non-zero, without the last line, when there is no CUDA device,
when the package is missing, or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
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


def small_proof(machine, record, pv, device) -> dict:
    """Setup + prove_shard on ``device``; the proof as numpy fields."""
    from zkmips_tpu_torch import convert

    pk = machine.setup(None, device=device)
    return convert.shard_proof_to_numpy(machine.prove_shard(pk, record, pv, device=device))


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


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


def mips_phase(args, dev, card: str) -> dict:
    """Execute, prove and verify the fib guest; returns the kernels' launch
    counts over ``MipsMachine.prove``."""
    import copy

    from zkmips_tpu_torch import convert
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
    small = fib_program(300)  # 1810 cycles: two shards of up to 2^10

    def prove_small(device):
        recs, _ = execute_for_proving(small, shard_size=1 << 10)
        spk = machine.setup(small, device=device)
        return [convert.shard_proof_to_numpy(p) for p in machine.prove(spk, recs, device=device)]

    on_card, on_cpu = prove_small(dev), prove_small("cpu")
    sums = [o["global_sum"] for p in on_card for n, o in zip(p["chip_names"], p["opened"]) if n == "Global"]
    if len(on_card) < 2 or len(sums) != len(on_card) or any(g is None for g in sums):
        raise AssertionError("mips: the small fib did not give two shards with global sums")
    if not _same(on_card, on_cpu):
        raise AssertionError("mips: the card's proofs of the small fib differ from the CPU's")
    print(f"mips small fib: card and CPU proofs of {len(on_card)} shards equal "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return launches


def keccak_phase(args, dev, card: str) -> dict:
    """The keccak-chain guest at full size through the 49-chip machine;
    returns the kernels' launch counts over ``MipsMachine.prove``."""
    import copy

    from zkmips_tpu_torch.executor import execute_for_proving, guests
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.ops import poseidon2 as p2, poseidon2_cuda
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.utils import logger

    # the deferred-shard split threshold (the reference's SPLIT_THRESHOLD knob,
    # 2^15 rows by default) raised so that the KeccakSponge events stay one
    # deferred shard: 65,520 rows, padded to 2^16
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
    if kproof.opened[keccak].log_degree < 16:
        raise AssertionError("KeccakSponge is below 2^16 padded rows")

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

    # K1 at the widest leaf shape of this prove, against its plain version
    rows, width = max(shapes, key=lambda s: (s[1], s[0]))
    m = rand_field(np.random.default_rng(args.seed + 5), (rows, width), dev)
    got, want = poseidon2_cuda.hash_rows(m), p2.hash_matrix_rows_plain(m)
    err = max_err(got, want)
    print(f"kernel poseidon2_hash_rows ({rows}, {width}), the keccak prove's widest leaf: "
          f"max_abs_err {err} [{card}]", flush=True)
    if err != 0 or got.shape != want.shape:
        raise AssertionError("poseidon2_hash_rows disagrees with its plain version at the widest leaf")
    ms = cuda_ms(lambda: poseidon2_cuda.hash_rows(m), 3)
    perms = rows * -(-width // 8)
    bound_ms, bound_by, _ = poseidon2_bound(perms, m.numel() * 4 + rows * 32)
    print(f"time poseidon2_hash_rows at ({rows}, {width}): kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}) [{card}]", flush=True)
    del m, got, want
    return launches


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


def every_chip_phase(dev, card: str):
    """A guest that gives all 49 chips rows, proved at the test config on the
    card and on the CPU: the proofs must be equal field by field."""
    from zkmips_tpu_torch import convert
    from zkmips_tpu_torch.executor import execute_for_proving, guests
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.utils import logger

    program = guests.every_chip_program()
    machine = mips_machine(StarkConfig.test())

    def prove_on(device):
        t0 = time.perf_counter()
        records, _ = execute_for_proving(program)
        pk = machine.setup(program, device=device)
        on_card = device != "cpu"
        logger.configure(enabled=on_card, sync=True, echo=False)
        logger.spans_reset()
        proofs = machine.prove(pk, records, device=device)
        if on_card:
            torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        logger.configure(enabled=False)
        verified = ""
        if on_card:  # the stages of a shard of 49 small chips; the CPU's proofs must equal these
            print_shards("every-chip", proofs, card)
            t1 = time.perf_counter()
            assert machine.verify(pk.vk, proofs, program)
            verified = f", verified in {time.perf_counter() - t1:.3f} s"
        print(f"every-chip guest on {device}: proved in {prove_s:.3f} s{verified} [{card}]", flush=True)
        return [convert.shard_proof_to_numpy(p) for p in proofs]

    on_card, on_cpu = prove_on(dev), prove_on("cpu")
    names = {n for p in on_card for n in p["chip_names"]}
    if names != {a.name for a in machine.airs} or len(names) != 49:
        raise AssertionError(f"the every-chip guest left chips empty: {sorted({a.name for a in machine.airs} - names)}")
    if not _same(on_card, on_cpu):
        raise AssertionError("the card's proof of the every-chip guest differs from the CPU's")
    print(f"every-chip guest: card and CPU proofs equal, {len(names)} chips", flush=True)


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
    if len(proofs) != produced["records"] or len(proofs) < 3:
        raise AssertionError(f"stream: {len(proofs)} proofs of {produced['records']} records, not 3 or more")
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


def recursion_configs_phase(args, dev, card: str):
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
        t0 = time.perf_counter()
        on_cpu = small_proof(machine, small, small_pv, "cpu")
        if not _same(on_card, on_cpu):
            raise AssertionError(f"{name}: the card's proof differs from the CPU's")
        print(f"config {name}: card and CPU proofs at 2^{RECURSION_CPU_LOG_ROWS} rows equal "
              f"(card {card_s:.1f} s, CPU {time.perf_counter() - t0:.1f} s)", flush=True)


def full_phase(args, dev, card: str) -> dict:
    launches = keccak_phase(args, dev, card)
    elf_phase(dev, card)
    every_chip_phase(dev, card)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-rows", type=int, default=18,
                    help="log2 rows of the synthetic shard's Cpu/AddSub-shaped chips")
    ap.add_argument("--fib-iters", type=int, default=60_000,
                    help="iterations of the fib phase's guest (6 cycles each)")
    ap.add_argument("--stream-fib-iters", type=int, default=400_000,
                    help="iterations of the streaming phase's fib guest (6 cycles each)")
    ap.add_argument("--keccak-iters", type=int, default=2730,
                    help="iterations of the full-machine phase's keccak-chain guest (24 KeccakSponge rows each)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--only-kernels", action="store_true",
                      help="stop after the kernel phase and its kernels line (exit code 0, no last line)")
    only.add_argument("--only-full", action="store_true",
                      help="run the full-machine phase alone (exit code 0, no kernels line, no last line)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from zkmips_tpu_torch.ops import poseidon2_cuda
    from zkmips_tpu_torch.stark.machine import VerificationError
    from zkmips_tpu_torch.utils import logger

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
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
        full_phase(args, dev, card)
        return 0

    machine = build_machine()
    for c in machine.chips:
        print(f"chip {c!r} lqd={c.log_quotient_degree} constraints={len(c.constraints)}", flush=True)
    cpu_w = machine.chip_map["CpuShaped"].main_width
    add_w = machine.chip_map["AddSubShaped"].main_width
    records = kernel_phase(dev, rng, cpu_w + add_w, card)
    if args.only_kernels:
        print_kernels(records)
        return 0

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
    if not _same(small_proof(machine, small, small_pv, dev), small_proof(machine, small, small_pv, "cpu")):
        raise AssertionError("the card's proof of the small shard differs from the CPU's")
    print(f"small shard: card and CPU proofs equal ({time.perf_counter() - t0:.1f} s)", flush=True)
    del small, machine

    for name, n in mips_phase(args, dev, card).items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the fib path")
    for name, n in stream_phase(args, dev, card).items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the streaming path")
    stream_keccak_phase(dev, card)
    recursion_configs_phase(args, dev, card)
    for name, n in full_phase(args, dev, card).items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the keccak path")
        records[name]["launches"] = n

    print_kernels(records)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
