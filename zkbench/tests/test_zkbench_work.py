"""The Poseidon2 work count from a proof's shapes (``zkbench.work``) against
a hand count: a toy tree, and the rows and compressions the program hashes
while it proves a small shard on the CPU, counted at its hash functions."""

import math

import numpy as np
import pytest

from zkbench import spec, work


def test_tree_by_hand():
    # heights 8 (widths 10 + 6) and 2 (width 4): 8 rows of 16 -> 2 perms each, 2 rows of 4 -> 1 each;
    # compressions 4 + 2 + 1 below the tallest, 2 more where the height-2 rows join
    w = work.tree([(3, 10), (3, 6), (1, 4)])
    assert w.hash_perms == 8 * 2 + 2 * 1
    assert w.compressions == 7 + 2
    assert w.hash_bytes == 4 * (8 * (16 + 8) + 2 * (4 + 8))
    assert w.compress_bytes == 9 * 96


def test_roofline_bound():
    peak = spec.peaks()["NVIDIA H100 80GB HBM3"]
    r = work.roofline(work.Work(hash_perms=10**6), peak)
    assert r["bound"] == "operations"
    assert math.isclose(r["least_s"], 846e6 / 67e12)
    r = work.roofline(work.Work(hash_perms=1, hash_bytes=10**9), peak)
    assert r["bound"] == "bytes" and math.isclose(r["least_s"], 1e9 / 3.35e12)


@pytest.fixture(scope="module")
def counted_proof():
    """A two-shard proof of the fib guest at the test config, with
    the program's sponge rows and compressions counted as it hashes."""
    from zkmips_tpu_torch.executor import Program, execute_for_proving
    from zkmips_tpu_torch.machine.machine import mips_machine
    from zkmips_tpu_torch.ops import poseidon2 as p2
    from zkmips_tpu_torch.stark.machine import StarkConfig

    traffic = {"guest": "fib", "iterations": 60}
    guest = spec.guest("fib")
    program = Program.from_elf(guest.program(traffic))
    records, _ = execute_for_proving(program, stdin_bufs=guest.stdin(traffic, np.random.default_rng(7)),
                                     shard_size=256)
    machine = mips_machine(StarkConfig.test())
    pk = machine.setup(program, device="cpu")
    seen = {"perms": 0, "compressions": 0}
    saved = (p2.hash_matrix_rows, p2.compress, p2.compress_layer)

    def hash_rows(mat):
        seen["perms"] += mat.shape[0] * -(-mat.shape[1] // 8)
        return saved[0](mat)

    def compress(left, right):
        seen["compressions"] += left.shape[0]
        return saved[1](left, right)

    def compress_layer(layer):
        seen["compressions"] += layer.shape[0] // 2
        return saved[2](layer)

    p2.hash_matrix_rows, p2.compress, p2.compress_layer = hash_rows, compress, compress_layer
    try:
        proofs = machine.prove(pk, records, device="cpu")
    finally:
        p2.hash_matrix_rows, p2.compress, p2.compress_layer = saved
    return proofs, seen, machine.machine.config.fri.log_blowup


def test_count_from_shapes_is_the_programs(counted_proof):
    proofs, seen, log_blowup = counted_proof
    assert len(proofs) == 2
    total = work.Work()
    for p in proofs:
        total += work.proof(p, log_blowup)
    assert (total.hash_perms, total.compressions) == (seen["perms"], seen["compressions"])
    assert total.grind_perms == sum(p.fri_proof.pow_witness + 1 for p in proofs)
