"""The check of ``compress-fib2`` fails a broken compressed proof: runs of the
cell past the harness's look for a card, on the CPU at the fault tests'
size (the test FRI config, a 60-iteration fib in two 256-cycle shards, the
configuration's ``compressed`` mode), one set-up shared by the sound run and
the faults planted in ``ProverClient.prove``.  The sound run reads
``correct`` true against the plain reference; an altered digest word of the
compressed record and a stale proof each read false; so does the control
(``control.py``: the program at half the stated queries)."""

import copy
import time

import pytest

from zkbench import checks, control, harness, spec

SEED = 2**31 + 1717


def small_cell() -> spec.Cell:
    cell = spec.cell("compress-fib2")
    cell.config = dict(cell.config, fri={"log_blowup": 1, "num_queries": 8, "proof_of_work_bits": 4},
                       shard_size=256)
    cell.traffic = {"guest": "fib", "iterations": 60}
    return cell


def digest_altered(prove, first):
    """A committed digest word of the compressed record altered where it is produced."""
    def f(*a, **kw):
        p = prove(*a, **kw)
        cp = copy.deepcopy(p.proofs[0])
        pv = cp.proof.public_values
        pv[checks.REC_DIGEST] = (int(pv[checks.REC_DIGEST]) + 1) % 0x10000
        p.proofs[0] = cp
        return p
    return f


def stale(prove, first):
    """Every job given the first job's proof."""
    return lambda *a, **kw: first[0]


@pytest.fixture(scope="module")
def session():
    """One set-up; ``planted[0]`` is the fault ``ProverClient.prove`` runs
    (None: the program's own); ``first`` keeps the warm job's proof."""
    planted, first = [None], []

    def hook(client):
        prove = client.prove

        def switched(*a, **kw):
            if planted[0] is not None:
                return planted[0](prove, first)(*a, **kw)
            p = prove(*a, **kw)
            if not first:
                first.append(p)
            return p

        client.prove = switched

    s = harness.Session(small_cell(), "cpu", client_hook=hook)
    s.warm(SEED)
    return s, planted


def window(session, fault, seed):
    s, planted = session
    planted[0] = fault
    try:
        return s.window(seed, 0.0, False, time.perf_counter())
    finally:
        planted[0] = None


def test_sound_compressed_run_is_correct(session):
    r = window(session, None, SEED + 1)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"cycles_per_s", "peak_device_gib", "setup_s"}


@pytest.mark.parametrize("fault", [digest_altered, stale])
def test_compressed_fault_is_not_correct(session, fault):
    r = window(session, fault, SEED + 2)
    assert not r["correct"]
    assert r["checks"]["answer_mismatches"]["value"] + r["checks"]["rejected_proofs"]["value"] > 0


def test_compressed_control_is_not_correct():
    cell = small_cell()
    r = harness.run(cell, SEED + 3, 0.0, False, device="cpu",
                    client_hook=control.weaken_queries(cell.config))
    assert not r["correct"]
    assert r["checks"]["config_mismatches"]["value"] == 1  # the recursion proof at 4 queries, not 8
    assert r["checks"]["answer_mismatches"]["value"] == 0
