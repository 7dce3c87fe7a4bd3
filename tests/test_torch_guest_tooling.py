"""The port's host tooling against the reference package's, tolerance 0:
the guest encoder and ELF writer (``guest/``), the shape corpus and menu
(``machine/shape_gen.py``) and the debug oracles (``stark/debug.py``)."""

import os

import numpy as np
import pytest

from zkmips_tpu import guest as jguest
from zkmips_tpu.executor import execute_for_proving as j_execute_for_proving
from zkmips_tpu.guest import corpus as jcorpus
from zkmips_tpu.machine import shape_gen as jshape_gen
from zkmips_tpu.machine.machine import MipsMachine as JMipsMachine
from zkmips_tpu.machine.machine import mips_machine as j_mips_machine
from zkmips_tpu.stark import debug as jdebug
from zkmips_tpu.stark.machine import StarkConfig as JStarkConfig

from zkmips_tpu_torch import guest
from zkmips_tpu_torch.executor import execute_for_proving, guests
from zkmips_tpu_torch.executor.program import Program
from zkmips_tpu_torch.guest import corpus
from zkmips_tpu_torch.machine import shape_gen
from zkmips_tpu_torch.machine.machine import MipsMachine, mips_machine
from zkmips_tpu_torch.stark import debug
from zkmips_tpu_torch.stark.machine import StarkConfig

from test_torch_interpreter import FIXTURES, ref_program


def _key(p):
    """A program as plain values (instructions, entry, base, image)."""
    return ([(int(i.opcode), i.op_a, i.op_b, i.op_c, bool(i.imm_b), bool(i.imm_c))
             for i in p.instructions], p.pc_start, p.pc_base, dict(p.image))


# ---------------------------------------------------------------- guest/


@pytest.mark.parametrize("name", sorted(corpus.corpus()))
def test_write_elf_gives_the_fixture_and_the_references_bytes(name):
    tp, stdin = corpus.corpus()[name]
    jp, jstdin = jcorpus.corpus()[name]
    assert _key(tp) == _key(jp) and stdin == jstdin
    b = guest.write_elf(tp)
    assert b == jguest.write_elf(jp)
    with open(os.path.join(FIXTURES, f"{name}.elf"), "rb") as fh:
        assert b == fh.read()
    back = guest.roundtrip(tp)
    assert isinstance(back, Program) and back.pc_start == tp.pc_start
    assert _key(back) == _key(jguest.roundtrip(jp))


def test_encode_instruction_equals_the_reference():
    programs = [p for p, _ in corpus.corpus().values()]
    programs += [guests.program(guests.all_ops_body()), guests.every_chip_program()]
    encoded = refused = 0
    for tp in programs:
        for ti, ji in zip(tp.instructions, ref_program(tp).instructions):
            try:
                want = jguest.encode_instruction(ji)
            except jguest.EncodeError:
                with pytest.raises(guest.EncodeError):
                    guest.encode_instruction(ti)
                refused += 1
                continue
            assert guest.encode_instruction(ti) == want
            encoded += 1
    assert encoded > 3000 and refused > 0


# ---------------------------------------------------------- shape_gen


def test_corpus_programs_equal_the_reference():
    got, ref = shape_gen.corpus_programs(), jshape_gen.corpus_programs()
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert "keccak" in dict(ref) and "poseidon2" in dict(ref)  # the examples' guests
    for (name, tp), (_, jp) in zip(got, ref):
        assert _key(tp) == _key(jp), name


# the corpus members that trace in seconds: the rest (fib200000, mem20k,
# mixed30k and the keccak chains) take 10 s to minutes of fills per package
# on the CPU
OBSERVED = ("fib100", "fib3000", "fib40000", "keccak", "sha256", "poseidon2")


@pytest.fixture(scope="module")
def core_machines():
    return (MipsMachine(StarkConfig.core(), use_shapes=False),
            JMipsMachine(JStarkConfig.core(), use_shapes=False))


@pytest.mark.parametrize("name", OBSERVED)
def test_observe_heights_equal_the_reference(core_machines, name):
    tm, jm = core_machines
    tp = dict(shape_gen.corpus_programs())[name]
    jp = dict(jshape_gen.corpus_programs())[name]
    records, _ = execute_for_proving(tp)
    jrecords, _ = j_execute_for_proving(jp)
    got = shape_gen.observe_heights(tm, records)
    assert got == jshape_gen.observe_heights(jm, jrecords)
    assert got and all(h["Cpu"] > 0 for h in got)


def test_generate_menu_over_a_sub_corpus_equals_the_reference(monkeypatch):
    pick = ("fib3000", "sha256")
    sub = [(n, p) for n, p in shape_gen.corpus_programs() if n in pick]
    jsub = [(n, p) for n, p in jshape_gen.corpus_programs() if n in pick]
    monkeypatch.setattr(shape_gen, "corpus_programs", lambda: sub)
    monkeypatch.setattr(jshape_gen, "corpus_programs", lambda: jsub)
    menu = shape_gen.generate_menu()
    assert menu == jshape_gen.generate_menu()
    assert len(menu) == 2


# --------------------------------------------------------------- debug


@pytest.fixture(scope="module")
def traces():
    """Each package's canonical traces of a small fib shard on the minimal
    machine: [(chip, main, prep)] in fill order (the Byte chip last), and
    the shard's public values."""
    from test_torch_executor import JAX_SIDE, PORT_SIDE, fib_body
    from zkmips_tpu.executor import asm as jasm
    from zkmips_tpu_torch.executor import asm

    out = {}
    for side, m, prog, run in (
        ("port", mips_machine(StarkConfig.test(), minimal=True),
         asm.prog(fib_body(PORT_SIDE, 5) + asm.halt_sequence()), execute_for_proving),
        ("ref", j_mips_machine(JStarkConfig.test(), minimal=True),
         jasm.prog(fib_body(JAX_SIDE, 5) + jasm.halt_sequence()), j_execute_for_proving),
    ):
        record = run(prog)[0][0]
        m.generate_dependencies(record)
        chips = sorted((c for c in m.machine.chips if c.air.included(record)),
                       key=lambda c: bool(getattr(c.air, "trace_consumes_fills", False)))
        rows = []
        for c in chips:
            main = np.asarray(c.air.generate_trace(record, None), dtype=np.uint32)
            prep = c.air.generate_preprocessed(prog)
            rows.append((c, main, None if prep is None else np.asarray(prep, dtype=np.uint32)))
        out[side] = rows
        out[side + "_pv"] = m.shard_public_values(record)
    return out


def _by_name(rows, name):
    return next(r for r in rows if r[0].name == name)


@pytest.mark.parametrize("chip", ["Cpu", "AddSub", "Branch"])
def test_debug_constraints_report_equals_the_reference(traces, chip):
    c, main, prep = _by_name(traces["port"], chip)
    jc, jmain, jprep = _by_name(traces["ref"], chip)
    pv, jpv = traces["port_pv"], traces["ref_pv"]
    assert np.array_equal(main, jmain) and np.array_equal(pv, jpv)
    assert debug.debug_constraints(c, main, prep, publics=pv)
    assert jdebug.debug_constraints(jc, jmain, jprep, publics=jpv)
    # break the first cell of row 0 that some constraint reads
    for col in range(main.shape[1]):
        broken = main.copy()
        broken[0, col] += 1
        try:
            jdebug.debug_constraints(jc, broken.copy(), jprep, publics=jpv)
        except AssertionError as err:
            want = str(err)
            break
    else:
        pytest.fail("no constrained column")
    with pytest.raises(AssertionError) as got:
        debug.debug_constraints(c, broken, prep, publics=pv)
    assert str(got.value) == want and "fails at row 0" in want


def test_debug_lookups_report_equals_the_reference(traces):
    port, ref = traces["port"], traces["ref"]
    assert debug.debug_lookups(port) == jdebug.debug_lookups(ref) == {}
    name = "AddSub"
    c, main, prep = _by_name(port, name)
    broken = main.copy()
    broken[0, :] += 1  # every value and the multiplicity of the first event
    bport = [(c, broken, prep) if ch is c else (ch, m, p) for ch, m, p in port]
    jc = _by_name(ref, name)[0]
    bref = [(jc, broken.copy(), p) if ch is jc else (ch, m, p) for ch, m, p in ref]
    got = debug.debug_lookups(bport)
    assert got and got == jdebug.debug_lookups(bref)
