"""The port's shard prover against the reference's numpy prover on the toy
machine of tests/test_machine.py, rebuilt against the port's AirBuilder:
the proofs must be equal field by field, the reference's verifier must
accept the port's proof, and the port's verifier must reject tampering."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from zkmips_tpu.ops import field as jf
from zkmips_tpu.stark import air as jair, machine as jm, pcs as jpcs, permutation as jperm
from zkmips_tpu.stark.chip import BaseAir as JBaseAir, Chip as JChip
from zkmips_tpu_torch import convert
from zkmips_tpu_torch.stark import air as tair, machine as tm, permutation as tperm
from zkmips_tpu_torch.stark.chip import BaseAir as TBaseAir, Chip as TChip

torch.set_num_threads(2)

T, N = convert.to_torch, convert.to_numpy
RECORD = {"fib_rows": 16, "sent_values": [3, 5, 5, 60, 0, 0, 0, 7]}


def _fib_trace(record):
    n = record["fib_rows"]
    t = np.zeros((n, 2), dtype=np.uint32)
    a, b = 0, 1
    for i in range(n):
        t[i] = (a, b)
        a, b = b, (a + b) % jf.P
    return t


def _sender_trace(record):
    vals = record["sent_values"]
    t = np.zeros((max(16, len(vals)), 2), dtype=np.uint32)
    for i, v in enumerate(vals):
        t[i] = (v, 1)
    return t


def _range_trace(record, extra):
    mult = np.zeros((64, 1), dtype=np.uint32)
    for v in record["sent_values"]:
        mult[v, 0] += 1
    mult[3, 0] += extra
    return mult


def _toy_airs(lib_air, base, extra_range=0):
    """Fibonacci, Sender and Range chips against either package's builder."""

    class FibonacciAir(base):
        name = "Fibonacci"
        main_width = 2

        def eval(self, b):
            a0, b0 = b.main(0), b.main(1)
            a1, b1 = b.main(0, 1), b.main(1, 1)
            first = b.when_first_row()
            first.assert_zero(a0)
            first.assert_eq(b0, 1)
            t = b.when_transition()
            t.assert_eq(a1, b0)
            t.assert_eq(b1, a0 + b0)
            b.when_last_row().assert_eq(b0, b.public_value(0))

        def generate_trace(self, record, output):
            return _fib_trace(record)

    class SenderAir(base):
        name = "Sender"
        main_width = 2

        def eval(self, b):
            b.assert_bool(b.main(1))
            b.send(lib_air.LookupKind.Range, [b.main(0)], b.main(1))

        def generate_trace(self, record, output):
            return _sender_trace(record)

    class RangeAir(base):
        name = "Range"
        main_width = 1
        preprocessed_width = 1

        def eval(self, b):
            b.receive(lib_air.LookupKind.Range, [b.preprocessed(0)], b.main(0))

        def generate_preprocessed(self, program):
            return np.arange(64, dtype=np.uint32)[:, None]

        def generate_trace(self, record, output):
            return _range_trace(record, extra_range)

    return [FibonacciAir(), SenderAir(), RangeAir()]


def _fib_pv(n):
    a, b = 0, 1
    for _ in range(n - 1):
        a, b = b, (a + b) % jf.P
    return b


PV = np.array([_fib_pv(16)], dtype=np.uint32)


def _jax_machine(cfg, extra_range=0):
    chips = [JChip(a, 1) for a in _toy_airs(jair, JBaseAir, extra_range)]
    return jm.StarkMachine(cfg, chips, num_public_values=1)


def _port_machine(cfg, extra_range=0):
    chips = [TChip(a, 1) for a in _toy_airs(tair, TBaseAir, extra_range)]
    return tm.StarkMachine(cfg, chips, num_public_values=1)


def _to_reference_proof(tproof) -> jm.ShardProof:
    return convert.shard_proof_to_reference(tproof, jm, jpcs)


def _assert_same(a, b, path="proof"):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for fld in dataclasses.fields(a):
            _assert_same(getattr(a, fld.name), getattr(b, fld.name), f"{path}.{fld.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a, dtype=np.uint32), np.asarray(b, dtype=np.uint32)), path
    else:
        assert a == b, path


@pytest.fixture(scope="module", params=["test", "core"])
def proofs(request):
    jmach = _jax_machine(getattr(jm.StarkConfig, request.param)())
    jpk = jmach.setup(None)
    jproof = jmach.prove_shard(jpk, RECORD, PV)
    tmach = _port_machine(getattr(tm.StarkConfig, request.param)())
    tpk = tmach.setup(None, device="cpu")
    tproof = tmach.prove_shard(tpk, RECORD, PV, device="cpu")
    return jmach, jpk, jproof, tmach, tpk, tproof


def test_proof_equals_reference_field_by_field(proofs):
    from zkmips_tpu.verifier import stark_codec

    _jmach, _jpk, jproof, _tmach, _tpk, tproof = proofs
    converted = _to_reference_proof(tproof)
    _assert_same(converted, jproof)
    assert stark_codec.encode_core_proof([converted]) == stark_codec.encode_core_proof([jproof])


def test_reference_verifier_accepts_port_proof(proofs):
    jmach, jpk, _jproof, _tmach, tpk, tproof = proofs
    assert np.array_equal(N(tpk.vk.prep_root), jpk.vk.prep_root)
    assert jmach.verify_shard(jpk.vk, _to_reference_proof(tproof))


def test_port_verifier(proofs):
    _jmach, _jpk, _jproof, tmach, tpk, tproof = proofs
    assert tmach.verify_shard(tpk.vk, tproof)
    saved = tproof.opened[0].main_local
    bad = saved.clone()
    bad[0, 0] ^= 1
    tproof.opened[0].main_local = bad
    try:
        with pytest.raises(tm.VerificationError):
            tmach.verify_shard(tpk.vk, tproof)
    finally:
        tproof.opened[0].main_local = saved


def test_port_verifier_rejects_wrong_public_value_and_unbalanced_lookups():
    cfg = tm.StarkConfig.test()
    m = _port_machine(cfg)
    pk = m.setup(None, device="cpu")
    proof = m.prove_shard(pk, RECORD, np.array([12345], dtype=np.uint32), device="cpu")
    with pytest.raises(tm.VerificationError):
        m.verify_shard(pk.vk, proof)
    bad = _port_machine(cfg, extra_range=1)
    pk = bad.setup(None, device="cpu")
    proof = bad.prove_shard(pk, RECORD, PV, device="cpu")
    with pytest.raises(tm.VerificationError):
        bad.verify_shard(pk.vk, proof)


def test_permutation_trace_with_zero_denominator():
    """More than two lookups take the batch-inversion path; a denominator
    forced to zero on one row must zero the same fractions as in the
    reference."""

    def airs(lib_air, base):
        class Multi(base):
            name = "Multi"
            main_width = 3

            def eval(self, b):
                b.send(lib_air.LookupKind.Range, [b.main(0)], b.main(2))
                b.send(lib_air.LookupKind.Byte, [b.main(1), b.main(0)], b.main(2))
                b.receive(lib_air.LookupKind.Range, [b.main(1)], 1)

        return Multi()

    rng = np.random.default_rng(9)
    main = jf.to_monty(rng.integers(0, 1000, size=(16, 3), dtype=np.uint32))
    beta = np.array([jf.to_monty_int(v) for v in (5, 1, 2, 3)], dtype=np.uint32)
    # alpha = -(kind + beta * v0) on row 0, so the first lookup's D is 0 there
    jchip = JChip(airs(jair, JBaseAir))
    from zkmips_tpu.ops import ext4 as jext4

    d0 = jext4.add(jext4.scalar(int(jair.LookupKind.Range)), jext4.mul_base(beta, main[0, 0]))
    alpha = jext4.neg(d0)
    jflat, jcum = jperm.generate_permutation_trace(jchip, None, main, alpha, beta)
    tchip = TChip(airs(tair, TBaseAir))
    tflat, tcum = tperm.generate_permutation_trace(tchip, None, T(main), T(alpha), T(beta))
    assert np.array_equal(N(tflat), jflat)
    assert np.array_equal(N(tcum), jcum)
    assert not jflat[0, :4].any()  # the poisoned row


def test_traces_released_before_open(monkeypatch):
    """The main traces are dead when the open phase starts (the reference's
    ``traces = None`` frees nothing, ADVICE.md)."""
    m = _port_machine(tm.StarkConfig.test())
    pk = m.setup(None, device="cpu")
    refs, alive_at_open = [], []
    upload = tm.upload_trace

    def tracking_upload(t, target, device):
        out = upload(t, target, device)
        refs.append(weakref.ref(out))
        return out

    open_batches = tm.pcs.open_batches

    def checking_open(*args, **kwargs):
        gc.collect()
        alive_at_open.extend(r() is not None for r in refs)
        return open_batches(*args, **kwargs)

    monkeypatch.setattr(tm, "upload_trace", tracking_upload)
    monkeypatch.setattr(tm.pcs, "open_batches", checking_open)
    proof = m.prove_shard(pk, RECORD, PV, device="cpu")
    assert len(refs) == 3 and alive_at_open == [False, False, False]
    assert m.verify_shard(pk.vk, proof)
