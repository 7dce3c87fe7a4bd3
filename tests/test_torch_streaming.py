"""Streamed proving: ``stream_for_proving`` -> ``MipsMachine.prove_streaming``
against batch ``prove`` and the reference package's numpy prover, the
pooled trace fills of ``StarkMachine.fill_traces``, and the thread-local
tracing spans they report under.

Everything is integer data and is compared exactly (tolerance 0): records
column by column, traces array by array, proofs through the reference's
``encode_core_proof`` bytes.  The proofs are of a keccak-chain guest on the
full machine at ``StarkConfig.test()``: one execution shard and one
deferred KeccakSponge shard (``split_threshold`` passed explicitly); the
records tests stream six shards.
"""

import threading

import numpy as np
import pytest
import torch

from zkmips_tpu.executor import Executor as JExecutor
from zkmips_tpu.executor import asm as jasm
from zkmips_tpu.executor import stream_for_proving as j_stream_for_proving
from zkmips_tpu.executor.columnar import cpu_struct as jcpu_struct
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.stark import machine as jmachine
from zkmips_tpu.stark import pcs as jpcs
from zkmips_tpu.verifier import stark_codec as jcodec

from zkmips_tpu_torch import convert
from zkmips_tpu_torch.executor import asm, execute_for_proving, stream_for_proving
from zkmips_tpu_torch.executor.columnar import cpu_struct
from zkmips_tpu_torch.executor.guests import keccak_chain_program
from zkmips_tpu_torch.machine.machine import mips_machine
from zkmips_tpu_torch.stark.machine import StarkConfig
from zkmips_tpu_torch.utils import logger, pool

from test_torch_executor import JAX_SIDE, PORT_SIDE, _assert_records_equal, fib_body
from test_torch_interpreter import ref_program

torch.set_num_threads(2)

# the proved guest: 248 cycles in one shard, its one sponge call carved into
# deferred shard 2 (24 KeccakSponge rows >= 16)
KECCAK_ITERS, SHARD, SPLIT = 1, 1 << 10, 16


def _programs(kind):
    if kind == "fib":  # native executor, six shards
        return (jasm.prog(fib_body(JAX_SIDE, 400) + jasm.halt_sequence()),
                asm.prog(fib_body(PORT_SIDE, 400) + asm.halt_sequence()), 512)
    # the native executor refuses the sponge after yielding two records:
    # the interpreter re-executes and skips them
    tp = keccak_chain_program(3)
    return ref_program(tp), tp, 64


@pytest.mark.parametrize("kind", ["fib", "keccak"])
def test_streamed_records_equal_batch_and_the_reference(kind):
    jp, tp, shard = _programs(kind)
    streamed = list(stream_for_proving(tp, shard_size=shard))
    batch, _info = execute_for_proving(tp, shard_size=shard)
    ref = list(j_stream_for_proving(jp, shard_size=shard))
    ref_batch = JExecutor(jp, shard_size=shard).run()
    assert len(streamed) == len(batch) == len(ref) == len(ref_batch) >= 3
    for s, b, r, rb in zip(streamed, batch, ref, ref_batch):
        _assert_records_equal(s, r, jcpu_struct(r))
        _assert_records_equal(s, rb, jcpu_struct(rb))
        _assert_records_equal(b, s, cpu_struct(s))
        assert {k: len(v) for k, v in s.precompile_events.items()} == \
            {k: len(v) for k, v in b.precompile_events.items()}


def test_stream_stops_at_max_cycles():
    from zkmips_tpu_torch.executor import ExecutionError

    _jp, tp, shard = _programs("fib")
    with pytest.raises(ExecutionError):
        list(stream_for_proving(tp, shard_size=shard, max_cycles=1000))


@pytest.fixture(scope="module")
def machine():
    return mips_machine(StarkConfig.test())


@pytest.fixture(scope="module")
def runs(machine):
    tp = keccak_chain_program(KECCAK_ITERS)
    jp = ref_program(tp)
    m = machine
    pk = m.setup(tp, device="cpu")
    logger.configure(enabled=True, sync=False, echo=False)
    logger.spans_reset()
    try:
        s1 = m.prove_streaming(pk, stream_for_proving(tp, shard_size=SHARD), device="cpu",
                               split_threshold=SPLIT)
        spans, notes = logger.spans_report(), logger.notes_report()
    finally:
        logger.configure(enabled=False)
    s2 = m.prove_streaming(pk, stream_for_proving(tp, shard_size=SHARD), device="cpu",
                           workers=2, max_inflight=2, split_threshold=SPLIT)
    records, _ = execute_for_proving(tp, shard_size=SHARD)
    with pool.make_pool(2) as p:  # prove's own steps, with the threshold given
        batch = list(p.map(lambda r: m.prove_record(pk, r, device="cpu"),
                           m.split_deferred(records, split_threshold=SPLIT)))
    jm = j_mips_machine(jmachine.StarkConfig.test())
    jpk = jm.setup(jp)
    jrecords = JExecutor(jp, shard_size=SHARD).run()
    ref = [jm.prove_record(jpk, r) for r in jm.split_deferred(jrecords, split_threshold=SPLIT)]
    return {"tp": tp, "jp": jp, "m": m, "pk": pk, "jm": jm, "jpk": jpk, "spans": spans,
            "notes": notes, "proofs": {"stream1": s1, "stream2": s2, "batch": batch}, "ref": ref}


def _bytes(proofs):
    return jcodec.encode_core_proof([convert.shard_proof_to_reference(p, jmachine, jpcs)
                                     for p in proofs], config="test")


@pytest.mark.parametrize("which", ["stream1", "stream2", "batch"])
def test_proofs_equal_the_reference_bytes(runs, which):
    proofs = runs["proofs"][which]
    assert [int(p.public_values[0]) for p in proofs] == [1, 2]
    assert "KeccakSponge" in proofs[1].chip_names and "Cpu" not in proofs[1].chip_names
    assert _bytes(proofs) == jcodec.encode_core_proof(runs["ref"], config="test")


@pytest.mark.parametrize("which", ["stream1", "stream2"])
def test_streamed_proofs_verify(runs, which):
    assert runs["m"].verify(runs["pk"].vk, runs["proofs"][which], runs["tp"])


def test_deferred_shard_public_values_equal_batch(runs):
    """The deferred shard carries the last execution shard's chained values."""
    tp, m = runs["tp"], runs["m"]
    records, _ = execute_for_proving(tp, shard_size=SHARD)
    batch = m.split_deferred(records, split_threshold=SPLIT)
    got = [p.public_values for p in runs["proofs"]["stream1"]]
    assert len(got) == len(batch)
    for pv, r in zip(got, batch):
        assert pv.tolist() == m.shard_public_values(r).astype(np.int64).tolist()


def test_pooled_fills_report_under_the_prove_span(runs):
    spans, notes = runs["spans"], runs["notes"]
    for shard, chip in ((1, "Cpu"), (1, "MemoryLocal"), (2, "KeccakSponge"), (1, "Byte")):
        assert f"shard{shard}/prove.trace_gen/fill.{chip}" in spans
        assert notes[f"shard{shard}/prove.trace_gen/rows.{chip}"] > 0
    assert not [k for k in spans if k.startswith("fill.")]


@pytest.mark.parametrize("workers", [1, 2, 8])
def test_pooled_fills_equal_serial_fills(machine, monkeypatch, workers):
    """The Byte chip reads lookups every ALU fill appends from its thread:
    its trace (a multiset count) and every other trace must not depend on
    the pool."""
    tp = keccak_chain_program(2)
    m = machine
    record = execute_for_proving(tp, shard_size=1 << 20)[0][0]
    m.generate_dependencies(record)
    chips = [c for c in m.machine.chips if c.air.included(record)]
    serial = {}
    for c in sorted(chips, key=lambda c: bool(getattr(c.air, "trace_consumes_fills", False))):
        serial[c.name] = np.asarray(c.air.generate_trace(record, None), dtype=np.uint32)
    record.byte_lookups.pop("arrays", None)
    sizes = []
    make_pool = pool.make_pool

    def sized_pool(n):
        sizes.append(n)
        return make_pool(workers)

    monkeypatch.setattr(pool, "make_pool", sized_pool)
    pooled = m.machine.fill_traces(chips, record)
    assert sizes == [min(8, len(chips) - 1)]
    assert pooled.keys() == serial.keys() and "Byte" in pooled
    for name, t in serial.items():
        assert np.array_equal(pooled[name], t), name


def test_span_paths_are_per_thread():
    logger.configure(enabled=True, sync=False, echo=False)
    logger.spans_reset()
    try:
        barrier = threading.Barrier(2)

        def work(tag):
            with logger.span(f"outer{tag}"):
                barrier.wait()
                with logger.span("inner"):
                    logger.note("rows", tag)
                    barrier.wait()

        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with logger.span("main"):
            parent = logger.current_path()
            with pool.make_pool(1) as p:
                p.submit(lambda: _enter(parent)).result()
            assert logger.current_path() == "main"
        spans, notes = logger.spans_report(), logger.notes_report()
    finally:
        logger.configure(enabled=False)
    assert {p for p in spans if not p.startswith("gc.gen")} == {  # the collector's spans aside
        "outer0", "outer0/inner", "outer1", "outer1/inner", "main", "main/fill.x", "main/fill.x/deeper"}
    assert notes == {"outer0/inner/rows": 0, "outer1/inner/rows": 1, "main/fill.x/rows": 7}


def _enter(parent):
    with logger.span("fill.x", parent=parent):
        with logger.span("deeper"):
            pass
        logger.note("rows", 7)
    assert logger.current_path() == ""


@pytest.mark.gpu
def test_card_streamed_proofs_equal_the_reference(runs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    m, tp = runs["m"], runs["tp"]
    pk = m.setup(tp)
    for workers in (1, 2):
        proofs = m.prove_streaming(pk, stream_for_proving(tp, shard_size=SHARD), workers=workers,
                                   split_threshold=SPLIT)
        assert _bytes(proofs) == jcodec.encode_core_proof(runs["ref"], config="test")
