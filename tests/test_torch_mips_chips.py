"""The fifteen chips of the minimal MIPS machine, and the septic curve, against
the reference package's.

One guest that touches every opcode the minimal machine has a chip for is run
by the reference's executor; the record goes to the reference's chips as it
is and to the port's through ``convert.record_to_port``.  Traces,
preprocessed tables and the shape of every AIR are integer data and are
compared exactly (tolerance 0).
"""

import numpy as np
import pytest

from zkmips_tpu.executor import Executor as JExecutor
from zkmips_tpu.executor import asm as jasm
from zkmips_tpu.machine.machine import core_chip_airs as j_core_chip_airs
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.ops import field as jf
from zkmips_tpu.ops import septic as jseptic
from zkmips_tpu.stark.chip import pad_to_power_of_two as j_pad
from zkmips_tpu.stark.machine import StarkConfig as JStarkConfig

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import asm
from zkmips_tpu_torch.machine.machine import core_chip_airs, minimal_chip_airs, mips_machine
from zkmips_tpu_torch.ops import field as tf
from zkmips_tpu_torch.ops import septic
from zkmips_tpu_torch.stark.chip import pad_to_power_of_two, padded_height
from zkmips_tpu_torch.stark.machine import StarkConfig

from test_torch_executor import JAX_SIDE, PORT_SIDE, minimal_ops_body

CHIP_NAMES = [
    "Cpu", "AddSub", "Bitwise", "Lt", "ShiftLeft", "ShiftRight", "Branch", "Jump",
    "SyscallInstrs", "MemoryLocal", "MemoryGlobalInit", "MemoryGlobalFinalize", "Global",
    "Program", "Byte",
]


@pytest.fixture(scope="module")
def both():
    """Both machines, and every chip's trace of one single-shard record."""
    jp = jasm.prog(minimal_ops_body(JAX_SIDE) + jasm.halt_sequence())
    tp = asm.prog(minimal_ops_body(PORT_SIDE) + asm.halt_sequence())
    (jrec,) = JExecutor(jp).run()
    trec = convert.record_to_port(jrec, tp)
    jm = j_mips_machine(JStarkConfig.test(), minimal=True)
    tm = mips_machine(StarkConfig.test(), minimal=True)
    jm.generate_dependencies(jrec)
    tm.generate_dependencies(trec)
    # machine order: the Byte chip comes last and reads what the other
    # fills appended to the record
    jtraces = {a.name: np.asarray(a.generate_trace(jrec, None)) for a in jm.airs}
    ttraces = {a.name: np.asarray(a.generate_trace(trec, None)) for a in tm.airs}
    return {"jm": jm, "tm": tm, "jp": jp, "tp": tp, "jrec": jrec, "trec": trec,
            "jtraces": jtraces, "ttraces": ttraces}


def test_machine_lists_the_fifteen_chips(both):
    """The minimal machine keeps its fifteen chips in the reference's order;
    the full machine has the reference's 49 in its order."""
    assert [a.name for a in both["tm"].airs] == CHIP_NAMES
    assert [a.name for a in both["jm"].airs] == CHIP_NAMES
    assert [a.name for a in minimal_chip_airs()] == CHIP_NAMES
    full = [a.name for a in j_core_chip_airs()]
    assert len(full) == 49 and [a.name for a in core_chip_airs()] == full
    assert [a.name for a in mips_machine(StarkConfig.test(), minimal=False).airs] == full


@pytest.mark.parametrize("name", CHIP_NAMES)
def test_chip_trace_matches(both, name):
    jt, tt = both["jtraces"][name], both["ttraces"][name]
    assert tt.shape == jt.shape and tt.shape[0] > 0
    assert np.array_equal(tt.astype(np.uint64), jt.astype(np.uint64))
    jair = next(a for a in both["jm"].airs if a.name == name)
    tair = next(a for a in both["tm"].airs if a.name == name)
    assert tair.included(both["trec"]) and jair.included(both["jrec"])
    assert tair.main_width == jair.main_width == tt.shape[1]


@pytest.mark.parametrize("name", CHIP_NAMES)
def test_chip_preprocessed_matches(both, name):
    jair = next(a for a in both["jm"].airs if a.name == name)
    tair = next(a for a in both["tm"].airs if a.name == name)
    jprep = jair.generate_preprocessed(both["jp"])
    tprep = tair.generate_preprocessed(both["tp"])
    assert (tprep is None) == (jprep is None)
    assert tair.preprocessed_width == jair.preprocessed_width
    if jprep is not None:
        assert np.array_equal(np.asarray(tprep, dtype=np.uint64), np.asarray(jprep, dtype=np.uint64))


def _structure(root, memo):
    """A structural hash of an expression DAG, by node class name and fields,
    that is the same for both packages' node classes."""
    stack = [root]
    while stack:
        e = stack[-1]
        if id(e) in memo:
            stack.pop()
            continue
        kids = [getattr(e, s) for s in type(e).__slots__]
        todo = [k for k in kids if hasattr(type(k), "__slots__") and id(k) not in memo]
        if todo:
            stack.extend(todo)
            continue
        key = tuple(memo[id(k)] if hasattr(type(k), "__slots__") else int(k) for k in kids)
        memo[id(e)] = hash((type(e).__name__, key))
        stack.pop()
    return memo[id(root)]


def _lookups(lookups):
    memo = {}
    return [(int(l.kind), int(l.scope), [_structure(v, memo) for v in l.values],
             _structure(l.multiplicity, memo)) for l in lookups]


@pytest.mark.parametrize("name", CHIP_NAMES)
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


def test_global_chip_pad_rows_and_digest(both):
    jair = next(a for a in both["jm"].airs if a.name == "Global")
    tair = next(a for a in both["tm"].airs if a.name == "Global")
    jt, tt = both["jtraces"]["Global"], both["ttraces"]["Global"]
    for target in (padded_height(tt.shape[0]), 4 * padded_height(tt.shape[0])):
        jpad = np.asarray(jair.pad_rows(jt, target))
        tpad = np.asarray(tair.pad_rows(tt, target))
        assert np.array_equal(tpad.astype(np.uint64), jpad.astype(np.uint64))
        # padding rows carry the running digest: the last row is not zero
        assert tpad.shape[0] <= target and tpad[-1, -14:].any()


def test_public_values_match(both):
    jpv = both["jm"].shard_public_values(both["jrec"])
    tpv = both["tm"].shard_public_values(both["trec"])
    assert tpv.dtype == np.uint32 and np.array_equal(tpv, jpv)
    assert (tpv < tf.P).all()


def test_padded_height_is_the_reference_target():
    for h in list(range(0, 5000)) + [(1 << 20) - 1, 1 << 20, (1 << 20) + 1, (1 << 22) + 1]:
        assert padded_height(h) == max(16, 1 << max(h - 1, 1).bit_length()), h
    for h in (0, 1, 15, 16, 17, 64, 65):
        t = np.ones((h, 2), dtype=np.uint32)
        assert pad_to_power_of_two(t).shape == j_pad(t).shape
        assert pad_to_power_of_two(t, fixed_rows=128).shape == j_pad(t, fixed_rows=128).shape == (128, 2)


# ---------------------------------------------------------------------------
# ops/septic.py on seeded inputs
# ---------------------------------------------------------------------------


def _septic_elems(seed, n):
    rng = np.random.default_rng(seed)
    canon = rng.integers(0, tf.P, size=(n, 7), dtype=np.uint64)
    return canon, jf.to_monty(canon.astype(np.uint32))


def test_field_helpers_on_numpy_match():
    rng = np.random.default_rng(3)
    a = rng.integers(0, tf.P, size=257, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, tf.P, size=257, dtype=np.uint64).astype(np.uint32)
    for name in ("mul", "add", "sub"):
        out = getattr(tf, name)(a, b)
        assert out.dtype == np.uint32 and np.array_equal(out, getattr(jf, name)(a, b)), name
    for name in ("neg", "to_monty", "from_monty", "inv", "double", "square"):
        out = getattr(tf, name)(a)
        assert out.dtype == np.uint32 and np.array_equal(out, getattr(jf, name)(a)), name
    assert np.array_equal(tf.mul(a, np.uint32(7)), jf.mul(a, np.uint32(7)))
    assert tf.monty_const(12345) == jf.monty_const(12345)
    assert tf.inv_int(5) == jf.inv_int(5)


def test_septic_constants_match():
    for name in ("ZERO", "ONE", "CURVE_A", "CURVE_B", "DUMMY_X", "DUMMY_Y", "START_X", "START_Y",
                 "DIGEST_START_X", "DIGEST_START_Y"):
        assert np.array_equal(getattr(septic, name), getattr(jseptic, name)), name
    assert septic.ZERO_DIGEST_INT == jseptic.ZERO_DIGEST_INT
    for k in range(1, 7):
        assert np.array_equal(septic._FROB_M[k], jseptic._FROB_M[k])


def test_septic_field_ops_match():
    _, a = _septic_elems(11, 33)
    _, b = _septic_elems(12, 33)
    for name in ("add", "sub", "mul"):
        assert np.array_equal(getattr(septic, name)(a, b), getattr(jseptic, name)(a, b)), name
    for name in ("neg", "square", "inv", "curve_formula"):
        assert np.array_equal(getattr(septic, name)(a), getattr(jseptic, name)(a)), name
    for k in (1, 3, 6):
        assert np.array_equal(septic.frobenius(a, k), jseptic.frobenius(a, k))
    assert np.array_equal(septic.mul(a, septic.inv(a)), np.broadcast_to(septic.ONE, a.shape))
    assert np.array_equal(septic.from_base(a[:, 0]), jseptic.from_base(a[:, 0]))
    assert np.array_equal(septic.mul_base(a, b[:, 0]), jseptic.mul_base(a, b[:, 0]))


def test_septic_curve_ops_match():
    canon, _ = _septic_elems(21, 12)
    canon[:, 6] >>= 8  # the lift shifts the last limb by a byte
    x, y, off = septic.lift_x_batch(canon)
    jx, jy, joff = jseptic.lift_x_batch(canon)
    assert np.array_equal(x, jx) and np.array_equal(y, jy) and np.array_equal(off, joff)
    for i in range(3):
        xi, yi, oi = septic.lift_x_int([int(v) for v in canon[i]])
        assert (xi, yi, oi) == jseptic.lift_x_int([int(v) for v in canon[i]])
        assert xi == [int(v) for v in x[i]] and yi == [int(v) for v in y[i]] and oi == int(off[i])
        assert septic.sqrt_int(septic._curve_formula_int(xi)) is not None
    pts = [([int(v) for v in x[i]], [int(v) for v in y[i]]) for i in range(len(x))]
    acc, jacc = septic.ZERO_DIGEST_INT, jseptic.ZERO_DIGEST_INT
    for p in pts:
        acc, jacc = septic.curve_add_int(acc, p), jseptic.curve_add_int(jacc, p)
        assert acc == jacc
    xm = jf.to_monty(x.astype(np.uint32))
    ym = jf.to_monty(y.astype(np.uint32))
    for fn in ("curve_add",):
        got = getattr(septic, fn)(xm[:6], ym[:6], xm[6:], ym[6:])
        ref = getattr(jseptic, fn)(xm[:6], ym[:6], xm[6:], ym[6:])
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    got, ref = septic.curve_double(xm, ym), jseptic.curve_double(xm, ym)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    got, ref = septic.curve_sum_host(xm, ym), jseptic.curve_sum_host(xm, ym)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    # the host sum and the int sum are the same point
    assert [int(v) for v in jf.from_monty(got[0])] == acc[0]
    lhs, rhs = septic.is_on_curve(xm, ym)
    assert np.array_equal(lhs, rhs)
