"""The port's recursion VM (``zkmips_tpu_torch/recursion``: builder, program,
Python and C interpreters, the ten chips, ``RecursionMachine``) against the
reference's, on the programs of ``tests/test_recursion.py``.

Everything is a field element, so every comparison is exact (tolerance 0):
programs instruction for instruction, records event for event (the port's
Python and C interpreters and the reference's), each chip's preprocessed and
main trace, and the proofs at ``StarkConfig.test()`` through ``convert``,
each package's verifier accepting the other's proof.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zkmips_tpu.ops import ext4 as jext4, field as jf
from zkmips_tpu.recursion import Builder as JBuilder, RecursionMachine as JRecursionMachine
from zkmips_tpu.recursion import program as jpr, runtime as jrt
from zkmips_tpu.recursion.verifier import CircuitChallenger as JCircuitChallenger
from zkmips_tpu.stark import machine as jm, pcs as jpcs
from zkmips_tpu.stark.challenger import DuplexChallenger as JDuplexChallenger
from zkmips_tpu.verifier import stark_codec as jcodec

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.ops import ext4, field as tf
from zkmips_tpu_torch.recursion import Builder, RecursionMachine, native_runtime
from zkmips_tpu_torch.recursion.builder import Felt
from zkmips_tpu_torch.recursion.runtime import RecursionRuntime
from zkmips_tpu_torch.recursion.verifier import CircuitChallenger
from zkmips_tpu_torch.stark.challenger import DuplexChallenger
from zkmips_tpu_torch.stark.machine import StarkConfig, VerificationError

torch.set_num_threads(2)

EVENTS = convert._EVENT_LISTS


def _demo(B):
    b = B()
    x = b.felt(7)
    y = b.hint_felt()
    z = b.mul(b.add(x, y), b.felt(3))  # (7 + w) * 3
    e1 = b.ext(1, 2, 3, 4)
    e2 = b.ext(5, 6, 7, 8)
    b.div(b.mul(e1, e2), e2)  # == e1
    bit = b.felt(1)
    s1, s2 = b.select(bit, x, z)
    hashed = b.poseidon2([x] * 4 + [z] * 4 + [s1] * 4 + [s2] * 4)
    b.commit_public_values(hashed[:6] + [z, s1])
    return b.compile(), [(35, 0, 0, 0)]


def _fri_fold(B):
    b = B()
    x = b.felt(7)
    z = b.ext(3, 1, 4, 1)
    alpha = b.ext(2, 7, 1, 8)
    mat = [b.ext(10 + i, i, 0, 5) for i in range(3)]
    psz = [b.ext(20 + i, 0, i, 6) for i in range(3)]
    apow2, ro2 = b.fri_fold(x, z, alpha, mat, psz, b.ext(1), b.ext(0))
    felt = type(x)
    pv = [b.add(felt(ro2.addr), b.felt(0)), b.add(felt(apow2.addr), b.felt(0))]
    b.commit_public_values(pv + [b.felt(0) for _ in range(6)])
    return b.compile(), []


def _hint_bits(B):
    b = B()
    v = b.felt(0b1011)
    bits = b.hint_bits(v, 4)
    acc = bits[0]
    for k in range(1, 4):
        acc = b.add(acc, b.mul(bits[k], b.felt(1 << k)))
    felts = b.ext2felts(b.ext(9, 8, 7, 6))
    exp = b.exp_reverse_bits(b.felt(5), bits[:3])
    b.commit_public_values([acc] + felts + [bits[1], bits[2], exp])
    return b.compile(), []


def _batch_fri(B):
    b = B()
    pxs = [b.felt(3 + i) for i in range(4)]
    pzs = [b.ext(7 + i, i, 2 * i, 1) for i in range(4)]
    apows = [b.ext(1, i, 0, 3) for i in range(4)]
    acc = b.batch_fri(pxs, pzs, apows)
    felt = type(pxs[0])
    b.commit_public_values([b.add(felt(acc.addr), b.felt(0))] + [b.felt(0)] * 7)
    return b.compile(), []


def _assert_eq_prog(B):
    b = B()
    x = b.felt(4)
    b.assert_eq(b.mul(x, x), b.felt(16))
    b.assert_zero(b.sub(b.ext(2, 3, 0, 1), b.ext(2, 3, 0, 1)))
    b.commit_public_values([x] * 8)
    return b.compile(), []


PROGRAMS = {"demo": _demo, "fri_fold": _fri_fold, "hint_bits": _hint_bits,
            "batch_fri": _batch_fri, "assert_eq": _assert_eq_prog}


def _fields(ins):
    return {f.name: getattr(ins, f.name) for f in dataclasses.fields(ins)}


def _norm(v):
    """Plain Python values of an event: instructions as (class name, fields)."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, {k: _norm(x) for k, x in _fields(v).items()})
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def assert_programs_equal(got, ref):
    assert got.memory_size == ref.memory_size
    assert got.num_public_values == ref.num_public_values
    assert len(got.instructions) == len(ref.instructions)
    for i, (a, b) in enumerate(zip(got.instructions, ref.instructions)):
        assert type(a).__name__ == type(b).__name__, i
        assert _norm(a) == _norm(b), (i, a, b)


def assert_records_equal(got, ref):
    assert got.public_values == ref.public_values
    for name in EVENTS:
        a, b = getattr(got, name), getattr(ref, name)
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            assert _norm(x) == _norm(y), (name, i)


@pytest.fixture(scope="module", params=sorted(PROGRAMS))
def case(request):
    tprog, wit = PROGRAMS[request.param](Builder)
    jprog, _ = PROGRAMS[request.param](JBuilder)
    return request.param, tprog, jprog, wit


def test_programs_equal_instruction_for_instruction(case):
    _name, tprog, jprog, _wit = case
    assert_programs_equal(tprog, jprog)
    # the carry-across functions give the same program both ways
    assert_programs_equal(convert.recursion_program_to_port(jprog), tprog)
    assert_programs_equal(convert.recursion_program_to_reference(tprog, jpr), jprog)


def test_records_equal_python_c_and_reference(case):
    _name, tprog, jprog, wit = case
    ref = jrt.RecursionRuntime(jprog, wit).run()
    py = RecursionRuntime(tprog, wit).run()
    nat = native_runtime.run(tprog, wit)
    assert_records_equal(py, ref)
    assert_records_equal(nat, ref)
    assert_records_equal(RecursionMachine(StarkConfig.test()).execute(tprog, wit), ref)
    assert_records_equal(convert.recursion_record_to_port(ref), nat)
    assert_records_equal(convert.recursion_record_to_reference(nat, jpr, jrt), ref)


def test_chip_traces_equal(case):
    _name, tprog, jprog, wit = case
    ref = jrt.RecursionRuntime(jprog, wit).run()
    nat = native_runtime.run(tprog, wit)
    tmach, jmach = RecursionMachine(StarkConfig.test()), JRecursionMachine(jm.StarkConfig.test())
    for tair, jair in zip(tmach.airs, jmach.airs):
        assert tair.name == jair.name
        tp, jp = tair.generate_preprocessed(tprog), jair.generate_preprocessed(jprog)
        assert np.array_equal(np.asarray(tp, dtype=np.uint32), jp), tair.name
        tt, jt = tair.generate_trace(nat, None), jair.generate_trace(ref, None)
        assert tt.shape == jt.shape and np.array_equal(np.asarray(tt, dtype=np.uint32), jt), tair.name


def test_runtime_semantics():
    prog, wit = _demo(Builder)
    rec = RecursionMachine(StarkConfig.test()).execute(prog, wit)
    assert rec.public_values[6] == (7 + 35) * 3
    assert rec.public_values[7] == (7 + 35) * 3  # select(bit=1) puts z first
    assert len(rec.ext_alu_events) == 2
    rec = native_runtime.run(*_hint_bits(Builder))
    assert rec.public_values[:8] == [0b1011, 9, 8, 7, 6, 1, 0, pow(5, 0b110, tf.P)]


@pytest.fixture(scope="module")
def demo_proofs():
    tprog, wit = _demo(Builder)
    jprog, _ = _demo(JBuilder)
    tmach = RecursionMachine(StarkConfig.test())
    tpk = tmach.setup(tprog, device="cpu")
    tproof = tmach.prove(tpk, tmach.execute(tprog, wit), device="cpu")
    jmach = JRecursionMachine(jm.StarkConfig.test())
    jpk = jmach.setup(jprog)
    jproof = jmach.prove(jpk, jmach.execute(jprog, wit))
    return tmach, tpk, tproof, jmach, jpk, jproof


def test_proofs_equal_and_each_verifier_accepts_the_other(demo_proofs):
    tmach, tpk, tproof, jmach, jpk, jproof = demo_proofs
    assert np.array_equal(convert.to_numpy(tpk.vk.prep_root), jpk.vk.prep_root)
    converted = convert.shard_proof_to_reference(tproof, jm, jpcs)
    assert jcodec.encode_core_proof([converted]) == jcodec.encode_core_proof([jproof])
    assert tmach.verify(tpk.vk, tproof)
    assert jmach.verify(convert.verifying_key_to_reference(tpk.vk, jm), converted)
    assert tmach.verify(convert.verifying_key_to_port(jpk.vk), convert.shard_proof_to_port(jproof))


def test_tampered_public_value_rejected(demo_proofs):
    tmach, tpk, tproof, jmach, jpk, _jproof = demo_proofs
    bad = convert.shard_proof_to_port(convert.shard_proof_to_reference(tproof, jm, jpcs))
    bad.public_values[6] ^= 1
    with pytest.raises(VerificationError):
        tmach.verify(tpk.vk, bad)
    with pytest.raises(jm.VerificationError):
        jmach.verify(jpk.vk, convert.shard_proof_to_reference(bad, jm, jpcs))


@pytest.mark.parametrize("name", ["fri_fold", "hint_bits", "batch_fri", "assert_eq"])
def test_each_chip_program_proves_and_verifies(name):
    prog, wit = PROGRAMS[name](Builder)
    m = RecursionMachine(StarkConfig.test())
    pk = m.setup(prog, device="cpu")
    assert m.verify(pk.vk, m.prove(pk, m.execute(prog, wit), device="cpu"))


def test_fri_fold_value_matches_direct_ext_math():
    rec = native_runtime.run(*_fri_fold(Builder))

    def mont(t):
        return torch.tensor([tf.to_monty_int(v) for v in t], dtype=torch.int32)

    zv, av = mont((3, 1, 4, 1)), mont((2, 7, 1, 8))
    xz = ext4.sub(mont((7, 0, 0, 0)), zv)
    acc_ro, acc_ap = mont((0, 0, 0, 0)), mont((1, 0, 0, 0))
    for i in range(3):
        q = ext4.mul(ext4.sub(mont((10 + i, i, 0, 5)), mont((20 + i, 0, i, 6))), ext4.inv(xz))
        acc_ro = ext4.add(acc_ro, ext4.mul(acc_ap, q))
        acc_ap = ext4.mul(acc_ap, av)
    assert ext4.to_canonical(acc_ro).tolist()[0] == rec.public_values[0]
    assert ext4.to_canonical(acc_ap).tolist()[0] == rec.public_values[1]


def test_circuit_assert_propagates_from_both_interpreters():
    b = Builder()
    b.assert_eq(b.felt(1), b.felt(2))
    prog = b.compile()
    with pytest.raises(AssertionError):
        RecursionRuntime(prog, []).run()
    with pytest.raises(AssertionError, match="circuit assert"):
        RecursionMachine(StarkConfig.test()).execute(prog)


def test_execute_raises_when_the_c_runtime_fails_to_build(monkeypatch):
    """No fallback to the Python interpreter: a failed build raises."""
    calls = []

    def broken_build(src, extra_flags=()):
        calls.append(src)
        raise OSError("cc: not found")

    monkeypatch.setattr(native_runtime, "_LIB", None)
    monkeypatch.setattr(native_runtime, "build", broken_build)
    prog, wit = _demo(Builder)
    with pytest.raises(OSError, match="cc"):
        RecursionMachine(StarkConfig.test()).execute(prog, wit)
    assert calls and calls[0].endswith("recursion_runtime.c")


def test_execute_raises_when_the_c_runtime_fails_to_run():
    """A witness underrun is a failed run: it raises, it is not retried."""
    prog, _wit = _demo(Builder)
    with pytest.raises(AssertionError, match="witness underrun"):
        RecursionMachine(StarkConfig.test()).execute(prog, [])


def test_circuit_challenger_matches_both_host_challengers():
    b, jb = Builder(), JBuilder()
    cch, jcch = CircuitChallenger(b), JCircuitChallenger(jb)
    host, jhost = DuplexChallenger(), JDuplexChallenger()
    rng = np.random.default_rng(7)
    pairs = []
    for i, v in enumerate(int(x) for x in rng.integers(0, tf.P, size=23)):
        cch.observe(b.const_felt(v))
        jcch.observe(jb.const_felt(v))
        host.observe(v)
        jhost.observe(v)
        if i % 5 == 4:
            pairs.append((cch.sample(), host.sample(), jcch.sample(), jhost.sample()))
    bits_c, bits_h = cch.sample_bits(10), host.sample_bits(10)
    jcch.sample_bits(10)
    assert jhost.sample_bits(10) == bits_h
    ec, eh = cch.sample_ext(), host.sample_ext()
    jcch.sample_ext()
    assert ext4.to_canonical(eh).tolist() == [int(x) for x in jext4.to_canonical(jhost.sample_ext())]
    prog, jprog = b.compile(), jb.compile()
    assert_programs_equal(prog, jprog)
    rt = RecursionRuntime(prog, [])
    rt.run()
    for fc, fh, _jfc, jfh in pairs:
        assert rt.memory[fc.addr][0] == fh == jfh
    assert sum(rt.memory[v.addr][0] << k for k, v in enumerate(bits_c)) == bits_h
    assert rt.memory[ec.addr] == tuple(ext4.to_canonical(eh).tolist())


def test_felt_handles_are_plain_addresses():
    b = Builder()
    x = b.felt(3)
    assert isinstance(x, Felt) and x.addr == 0
    assert jf.P == tf.P


@pytest.mark.gpu
def test_card_proof_equals_cpu(demo_proofs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    tmach, _tpk, tproof, _jmach, _jpk, _jproof = demo_proofs
    prog, wit = _demo(Builder)
    pk = tmach.setup(prog)
    card = tmach.prove(pk, tmach.execute(prog, wit))
    assert jcodec.encode_core_proof([convert.shard_proof_to_reference(card, jm, jpcs)]) == \
        jcodec.encode_core_proof([convert.shard_proof_to_reference(tproof, jm, jpcs)])
