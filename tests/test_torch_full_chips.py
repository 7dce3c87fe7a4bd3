"""The 34 chips of the full MIPS machine that the minimal machine lacks,
against the reference package's.

One guest that gives every chip rows runs through each package's own
interpreter; each package's full machine fills its chips from its own record.
Traces, preprocessed tables and the shape of every AIR (constraint DAGs,
lookups, quotient degree, permutation width) are integer data and are
compared exactly (tolerance 0), and so is the Global chip's running septic
sum, which the port forms in blocks.  No proofs here.
"""

import numpy as np
import pytest

from zkmips_tpu.executor import Executor as JExecutor
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.stark.machine import StarkConfig as JStarkConfig

from zkmips_tpu_torch.executor import Executor, guests
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.ops import septic
from zkmips_tpu_torch.stark.machine import StarkConfig

from test_torch_interpreter import ref_program
from test_torch_mips_chips import CHIP_NAMES as MINIMAL_NAMES
from test_torch_mips_chips import _lookups, _structure

NEW_CHIPS = [
    "Mul", "DivRem", "CloClz", "MemoryInstrs", "MiscInstrs", "MovCond", "SyscallCore",
    "SyscallPrecompile", "ShaExtend", "ShaCompress", "Poseidon2Permute", "KeccakSponge",
    "SysLinux", "Secp256k1Add", "Secp256k1Double", "Secp256k1Decompress", "Secp256r1Add",
    "Secp256r1Double", "Secp256r1Decompress", "Bn254Add", "Bn254Double", "Bls12381Add",
    "Bls12381Double", "Bls12381Decompress", "EdAdd", "EdDecompress", "Bn254FpOp", "Bls12381FpOp",
    "Bn254Fp2AddSub", "Bls12381Fp2AddSub", "Bn254Fp2Mul", "Bls12381Fp2Mul", "Uint256Mul",
    "U256x2048Mul",
]


@pytest.fixture(scope="module")
def both():
    """Both full machines, and every chip's trace of the every-chip guest."""
    tp = guests.every_chip_program()
    jp = ref_program(tp)
    (jrec,) = JExecutor(jp).run()
    (trec,) = Executor(tp).run()
    jm = j_mips_machine(JStarkConfig.test())
    tm = mips_machine(StarkConfig.test())
    jm.generate_dependencies(jrec)
    tm.generate_dependencies(trec)
    jtraces = {a.name: np.asarray(a.generate_trace(jrec, None)) for a in jm.airs}
    ttraces = {a.name: np.asarray(a.generate_trace(trec, None)) for a in tm.airs}
    return {"jm": jm, "tm": tm, "jp": jp, "tp": tp, "jrec": jrec, "trec": trec,
            "jtraces": jtraces, "ttraces": ttraces}


def test_the_new_chips_complete_the_full_machine(both):
    names = [a.name for a in both["tm"].airs]
    assert names == [a.name for a in both["jm"].airs]
    assert sorted(NEW_CHIPS + MINIMAL_NAMES) == sorted(names) and len(names) == 49


def test_generate_dependencies_runs_once(both):
    """Nested ALU events (DivRem, MiscInstrs) and global lookups are appended
    once however often the machine is asked."""
    rec = both["trec"]
    counts = (len(rec.nested_alu_events), len(rec.global_lookup_events))
    assert counts[0] > 0
    both["tm"].generate_dependencies(rec)
    assert (len(rec.nested_alu_events), len(rec.global_lookup_events)) == counts
    assert len(both["jrec"].nested_alu_events) == counts[0]


@pytest.mark.parametrize("name", NEW_CHIPS)
def test_chip_trace_matches(both, name):
    jt, tt = both["jtraces"][name], both["ttraces"][name]
    assert tt.shape == jt.shape and tt.shape[0] > 0
    assert tt.dtype == jt.dtype
    assert np.array_equal(tt.astype(np.uint64), jt.astype(np.uint64))
    jair = next(a for a in both["jm"].airs if a.name == name)
    tair = next(a for a in both["tm"].airs if a.name == name)
    assert tair.included(both["trec"]) and jair.included(both["jrec"])
    assert tair.main_width == jair.main_width == tt.shape[1]


@pytest.mark.parametrize("name", NEW_CHIPS)
def test_chip_preprocessed_matches(both, name):
    jair = next(a for a in both["jm"].airs if a.name == name)
    tair = next(a for a in both["tm"].airs if a.name == name)
    jprep = jair.generate_preprocessed(both["jp"])
    tprep = tair.generate_preprocessed(both["tp"])
    assert (tprep is None) == (jprep is None)
    assert tair.preprocessed_width == jair.preprocessed_width
    if jprep is not None:
        assert np.array_equal(np.asarray(tprep, dtype=np.uint64), np.asarray(jprep, dtype=np.uint64))


@pytest.mark.parametrize("name", NEW_CHIPS)
def test_chip_air_shape_matches(both, name):
    jc = both["jm"].machine.chip_map[name]
    tc = both["tm"].machine.chip_map[name]
    assert len(tc.constraints) == len(jc.constraints) > 0
    assert tc.log_quotient_degree == jc.log_quotient_degree
    assert tc.quotient_chunks == jc.quotient_chunks
    assert tc.perm_width_ext == jc.perm_width_ext
    assert tc.constraint_degree == jc.constraint_degree
    assert int(tc.commit_scope) == int(jc.commit_scope)
    assert _lookups(tc.sends) == _lookups(jc.sends)
    assert _lookups(tc.receives) == _lookups(jc.receives)
    jmemo, tmemo = {}, {}
    assert [_structure(c, tmemo) for c in tc.constraints] == \
        [_structure(c, jmemo) for c in jc.constraints]


def test_global_trace_matches(both):
    """The Global chip of the every-chip guest: its running septic sum goes
    through the blocked sum of ``septic.curve_prefix_sums``."""
    jt, tt = both["jtraces"]["Global"], both["ttraces"]["Global"]
    assert tt.shape == jt.shape and tt.shape[0] > 100
    assert np.array_equal(tt.astype(np.uint64), jt.astype(np.uint64))


def _serial_sums(start, xs, ys):
    cum = ([int(c) for c in start[0]], [int(c) for c in start[1]])
    out = []
    for x, y in zip(xs, ys):
        cum = septic.curve_add_int(cum, ([int(c) for c in x], [int(c) for c in y]))
        out.append(cum)
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 17, 300])
def test_septic_prefix_sums_equal_the_serial_chain(n):
    rng = np.random.default_rng(n)
    xs, ys, _ = septic.lift_x_batch(rng.integers(0, 1 << 30, size=(n, 7), dtype=np.uint64))
    ys = np.where(rng.random(n)[:, None] < 0.5, ys, (septic.f.P - ys) % septic.f.P)
    cx, cy = septic.curve_prefix_sums(septic.ZERO_DIGEST_INT, xs, ys)
    want = _serial_sums(septic.ZERO_DIGEST_INT, xs, ys)
    assert [([int(v) for v in a], [int(v) for v in b]) for a, b in zip(cx, cy)] == want


def test_septic_prefix_sums_refuse_equal_x():
    """Where an addition would meet equal x coordinates the blocked sum
    returns None and the Global fill runs the reference's serial chain."""
    start = septic.ZERO_DIGEST_INT
    sx, sy = (np.array([start[0]], dtype=np.uint64), np.array([start[1]], dtype=np.uint64))
    assert septic.curve_prefix_sums(start, sx, sy) is None  # start + start
    rng = np.random.default_rng(7)
    xs, ys, _ = septic.lift_x_batch(rng.integers(0, 1 << 30, size=(1, 7), dtype=np.uint64))
    twice = (np.repeat(xs, 4, axis=0), np.repeat(ys, 4, axis=0))
    assert septic.curve_prefix_sums(start, *twice) is None  # P + P within a block
