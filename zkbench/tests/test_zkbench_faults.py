"""The check fails a broken timed path: a run of a cell, past the harness's
look for a card, on the CPU at a size a test can hold (the test FRI config,
a 60-iteration fib in two 256-cycle shards), with one
fault planted in ``ProverClient.prove`` at a time, reads ``correct`` false;
the same run without a fault reads it true.  The control (``control.py``:
the program at half the stated queries) fails the FRI shape check."""

import copy

import pytest

from zkbench import control, harness, spec

SEED = 2**31 + 4242


def small_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    cell.config = dict(cell.config, fri={"log_blowup": 1, "num_queries": 8, "proof_of_work_bits": 4},
                       shard_size=256)
    cell.traffic = {"guest": "fib", "iterations": 60}
    return cell


def stale(prove):
    """A step that returns its state unchanged: every job gets the first proof."""
    first = []

    def f(*a, **kw):
        if not first:
            first.append(prove(*a, **kw))
        return first[0]
    return f


def half_left_out(prove):
    """Half of the batch left out: the job's later shards are dropped."""
    def f(*a, **kw):
        p = prove(*a, **kw)
        p.proofs = p.proofs[: max(1, len(p.proofs) // 2)]
        return p
    return f


def answer_altered(prove):
    """An answer altered where it is produced: a committed digest word of
    the last shard's public values."""
    def f(*a, **kw):
        p = prove(*a, **kw)
        last = copy.deepcopy(p.proofs[-1])
        last.public_values[5] = (int(last.public_values[5]) + 1) % 0x10000
        p.proofs[-1] = last
        return p
    return f


def run(hook):
    return harness.run(small_cell("core-fib2"), SEED, 0.0, False, device="cpu", client_hook=hook)


def test_sound_run_is_correct():
    r = run(None)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", [stale, half_left_out, answer_altered])
def test_fault_is_not_correct(fault):
    def hook(client):
        client.prove = fault(client.prove)

    r = run(hook)
    assert not r["correct"]
    assert r["checks"]["answer_mismatches"]["value"] + r["checks"]["rejected_proofs"]["value"] > 0


def test_control_is_not_correct():
    cell = small_cell("core-fib2")

    r = harness.run(cell, SEED + 1, 0.0, False, device="cpu",
                    client_hook=control.weaken_queries(cell.config))
    assert not r["correct"]
    assert r["checks"]["config_mismatches"]["value"] == 2  # both shards at 4 queries, not 8
    assert r["checks"]["answer_mismatches"]["value"] == 0
