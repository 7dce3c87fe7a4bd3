"""The quotient's tape (``stark/quotient_tape.py``) against the eager fold
(``air.fold_constraints`` through ``quotient.fold_chunks_eager``), bit for
bit, for every chip of the MIPS machine and of the recursion machine.

The plain torch evaluator of the tape runs here, on random Montgomery inputs
at 8 rows.  The fold kernel (``csrc/quotient.cu``) has twins marked ``gpu``
that run on a card and skip without one; this file imports no JAX."""

import zlib

import numpy as np
import pytest
import torch

from zkmips_tpu_torch.machine.machine import core_chip_airs, mips_machine
from zkmips_tpu_torch.ops import field as f, quotient_cuda
from zkmips_tpu_torch.recursion.machine import RecursionMachine
from zkmips_tpu_torch.stark import air, quotient, quotient_tape as qt

torch.set_num_threads(2)

CORE = [a.name for a in core_chip_airs()]
RECURSION = [a.name for a in RecursionMachine().airs]
LOG_H = 3


@pytest.fixture(scope="module")
def chips():
    out = {c.name: c for c in mips_machine().machine.chips}
    out.update({c.name: c for c in RecursionMachine().machine.chips})
    return out


def _rand(rng, shape, dev="cpu") -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, f.P, size=shape, dtype=np.int64).astype(np.int32)).to(dev)


def _inputs(chip, log_h: int, dev="cpu") -> dict:
    """Random Montgomery traces (evaluations on the trace domain) and
    uniform values for ``chip``, seeded by its name."""
    rng = np.random.default_rng(zlib.crc32(chip.name.encode()))
    h = 1 << log_h
    prep = _rand(rng, (h, chip.preprocessed_width), dev) if chip.preprocessed_width else None
    return {
        "main": _rand(rng, (h, chip.main_width), dev), "prep": prep,
        "perm_flat": _rand(rng, (h, 4 * chip.perm_width_ext), dev),
        "publics": _rand(rng, (64,)), "challenges": [_rand(rng, (4,)), _rand(rng, (4,))],
        "cum_sum": _rand(rng, (4,)), "global_sum": _rand(rng, (14,)), "alpha": _rand(rng, (4,)),
    }


def _ldes(chip, x: dict, log_h: int):
    lqd = chip.log_quotient_degree
    lde = lambda t: quotient.lde_onto_quotient_domain(t, log_h, lqd)
    return (lde(x["main"]), None if x["prep"] is None else lde(x["prep"]),
            lde(x["perm_flat"]) if x["perm_flat"].shape[1] else None)


def _uniform_args(x: dict) -> tuple:
    return x["publics"], x["challenges"], x["cum_sum"], x["global_sum"], x["alpha"]


@pytest.mark.parametrize("name", CORE + RECURSION)
def test_tape_folds_as_the_eager_fold(chips, name):
    chip = chips[name]
    x = _inputs(chip, LOG_H)
    _doms, want = quotient.quotient_chunks(chip, x["main"], x["prep"], x["perm_flat"], *_uniform_args(x))
    tape = qt.chip_tape(chip)
    uni = qt.uniforms(tape, LOG_H, *_uniform_args(x))
    got = qt.fold_chunks_plain(tape, *_ldes(chip, x, LOG_H), uni, LOG_H)
    assert got.shape == (1 << chip.log_quotient_degree, 1 << LOG_H, 4)
    for i, w in enumerate(want):
        assert torch.equal(got[i], w), (name, i)


def _kinds(order) -> dict:
    """id(node) -> the node's value is ext, as ``EvalContext`` types it."""
    ext: dict = {}
    for e in order:
        kids = air._children(e)
        if kids:
            ext[id(e)] = any(ext[id(c)] for c in kids)
        else:
            ext[id(e)] = (isinstance(e, (air.Challenge, air.CumSumLocal))
                          or (isinstance(e, air.Var) and e.segment == air.PERM))
    return ext


def _held_operation_values(constraints, ext: dict) -> tuple[int, int]:
    """The most base and ext values of operation nodes that
    ``fold_constraints`` holds at once: a node's value from its evaluation,
    with its children's, until its last reader."""
    order, readers = air._schedule(constraints)
    places = {}
    for c in constraints:
        places[id(c)] = places.get(id(c), 0) + 1
    held = [0, 0]
    most = [0, 0]
    for e in order:
        kids = air._children(e)
        if kids:
            held[ext[id(e)]] += 1
            most = [max(m, h) for m, h in zip(most, held)]
        for c in kids:
            readers[id(c)] -= 1
            if not readers[id(c)] and air._children(c):
                held[ext[id(c)]] -= 1
        readers[id(e)] -= places.get(id(e), 0)
        if not readers[id(e)] and kids:
            held[ext[id(e)]] -= 1
    return most[0], most[1]


@pytest.mark.parametrize("name", CORE + RECURSION)
def test_tape_slots_hold_each_value_until_its_last_reader(chips, name):
    """Replays the tape beside the DAG: every slot an instruction reads still
    holds the operand the DAG names, and the slots are no more than the
    operation values the eager fold holds at once."""
    chip = chips[name]
    tape = qt.chip_tape(chip)
    order, _ = air._schedule(chip.constraints)
    ext = _kinds(order)
    ops = [e for e in order if air._children(e)]
    holder: dict = {}  # (slot kind, index) -> id of the node written there
    where: dict = {}  # id(node) -> its slot
    code = iter(tape.code.tolist())
    places = {}
    for k, c in enumerate(chip.constraints):
        places.setdefault(id(c), []).append(k)
    folds = 0
    for e in order:
        if air._children(e):
            op, dst, a, b = next(code)
            assert op not in (qt.FOLD_B, qt.FOLD_E)
            words = [a] if op in (qt.NEG_B, qt.NEG_E) else [a, b]
            kids = air._children(e)
            if op in (qt.ADD_EB, qt.MUL_EB) and not ext[id(kids[0])]:
                words = words[::-1]  # base + ext, base * ext are stored ext first
            for c, w in zip(kids, words):
                kind, idx = qt.split(w)
                if kind in (qt.K_BSLOT, qt.K_ESLOT):
                    assert holder.get((kind, idx)) == id(c), (name, "overwritten before its last reader")
                    assert where[id(c)] == (kind, idx)
            slot = (qt.K_ESLOT if ext[id(e)] else qt.K_BSLOT, dst)
            holder[slot] = id(e)
            where[id(e)] = slot
        for k in places.get(id(e), ()):
            op, dst, a, _b = next(code)
            assert op == (qt.FOLD_E if ext[id(e)] else qt.FOLD_B) and dst == tape.APOW + 4 * k
            kind, idx = qt.split(a)
            if kind in (qt.K_BSLOT, qt.K_ESLOT):
                assert holder.get((kind, idx)) == id(e)
            folds += 1
    assert next(code, None) is None
    assert tape.n_instr == len(ops) + folds and folds == len(chip.constraints)
    most_base, most_ext = _held_operation_values(chip.constraints, ext)
    assert tape.n_base <= most_base and tape.n_ext <= most_ext, (tape.n_base, most_base, tape.n_ext, most_ext)


@pytest.mark.parametrize("log_h,lqd", [(3, 0), (3, 1), (4, 2), (2, 3)])
def test_vanishing_classes_are_the_eager_selectors(log_h, lqd):
    sels = quotient.coset_selectors(log_h, lqd, "cpu")
    zh, inv_zh = qt.vanishing_classes(log_h, lqd)
    rows = torch.arange(1 << (log_h + lqd))
    assert torch.equal(sels["inv_zeroifier"], torch.tensor(inv_zh, dtype=torch.int32)[rows % (1 << lqd)])
    x = f.mul(f.batch_powers(f.two_adic_generator_int(log_h + lqd), 1 << (log_h + lqd)),
              f.to_monty_int(f.GENERATOR))
    assert torch.equal(f.sub(f.pow_const(x, 1 << log_h), f.ONE),
                       torch.tensor(zh, dtype=torch.int32)[rows % (1 << lqd)])
    c = qt.coset_params(log_h, lqd)
    assert torch.equal(sels[air.Selector.TRANSITION], f.sub(x, c["last"]))


def test_uniform_table_refuses_what_the_tape_reads_and_lacks(chips):
    glob = qt.chip_tape(chips["Global"])
    assert glob.global_sum
    x = _inputs(chips["Global"], LOG_H)
    with pytest.raises(ValueError, match="global sum"):
        qt.uniforms(glob, LOG_H, x["publics"], x["challenges"], x["cum_sum"], None, x["alpha"])
    cpu = qt.chip_tape(chips["Cpu"])
    assert cpu.n_publics > 0 and not cpu.global_sum
    with pytest.raises(ValueError, match="public value"):
        qt.uniforms(cpu, LOG_H, x["publics"][: cpu.n_publics - 1], x["challenges"], x["cum_sum"],
                    None, x["alpha"])
    uni = qt.uniforms(cpu, LOG_H, x["publics"], x["challenges"], x["cum_sum"], None, x["alpha"])
    assert uni.dtype == torch.int32 and uni.shape == (cpu.PUBLICS + 64,)
    assert uni[cpu.APOW : cpu.APOW + 4].tolist() == [f.ONE, 0, 0, 0]


def test_rows_in_flight_keep_to_the_scratch_budget(chips):
    for name in ("Cpu", "KeccakSponge", "Bls12381Double", "Program"):
        tape = qt.chip_tape(chips[name])
        row_bytes = 4 * tape.n_base + 16 * tape.n_ext
        for n in (16, 1 << 12, 1 << 22):
            rows = quotient_cuda.rows_in_flight(tape.n_base, tape.n_ext, n)
            assert 1 <= rows <= n
            assert rows == n or (rows % 128 == 0 and rows >= 128)
            assert rows == min(n, 128) or rows * row_bytes <= quotient_cuda.SCRATCH_BYTES


def test_the_cpu_keeps_the_eager_fold(chips, monkeypatch):
    chip = chips["AddSub"]
    x = _inputs(chip, LOG_H)
    before = dict(quotient_cuda.LAUNCHES)
    monkeypatch.setattr(quotient, "fold_chunks_kernel", None)  # never reached on the CPU
    quotient.quotient_chunks(chip, x["main"], x["prep"], x["perm_flat"], *_uniform_args(x))
    assert quotient_cuda.LAUNCHES == before
    tape = qt.chip_tape(chip)
    uni = qt.uniforms(tape, LOG_H, *_uniform_args(x))
    with pytest.raises(ValueError, match="not a CUDA device"):
        quotient_cuda.fold_chunks(
            torch.from_numpy(tape.code), *_ldes(chip, x, LOG_H), uni, log_h=LOG_H, lqd=tape.lqd,
            n_base=tape.n_base, n_ext=tape.n_ext, inv_zh=tape.INV_ZH, invert=tape.invert,
            **qt.coset_params(LOG_H, tape.lqd))


@pytest.mark.parametrize("name,segment", [("Program", "preprocessed"), ("AddSub", "permutation")])
def test_the_kernel_path_refuses_a_trace_the_tape_reads_and_lacks(chips, name, segment):
    """The prover's side checks that the traces the tape reads are given,
    before anything reaches the binding (which knows no tape)."""
    chip = chips[name]
    x = _inputs(chip, LOG_H)
    main_q, prep_q, perm_q = _ldes(chip, x, LOG_H)
    if segment == "preprocessed":
        assert air.PREPROCESSED in qt.chip_tape(chip).reads
        prep_q = None
    else:
        assert air.PERM in qt.chip_tape(chip).reads
        perm_q = None
    with pytest.raises(ValueError, match=f"reads the {segment} trace"):
        quotient.fold_chunks_kernel(chip, main_q, prep_q, perm_q, LOG_H, *_uniform_args(x))


def test_the_binding_imports_nothing_of_the_prover():
    """``ops/quotient_cuda.py`` takes plain arguments: it imports nothing from
    ``stark``, so the imports run from the prover down to the binding only."""
    src = quotient_cuda.__loader__.get_source(quotient_cuda.__name__)
    assert "stark" not in "".join(l for l in src.splitlines() if l.lstrip().startswith(("import", "from")))


# ----------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _kernel_against_eager(chip, log_h: int, dev):
    x = _inputs(chip, log_h, dev)
    main_q, prep_q, perm_q = _ldes(chip, x, log_h)
    args = (chip, main_q, prep_q, perm_q, log_h, *_uniform_args(x))
    before = quotient_cuda.LAUNCHES["quotient_fold"]
    got = quotient.fold_chunks_kernel(*args)
    torch.cuda.synchronize()
    assert quotient_cuda.LAUNCHES["quotient_fold"] == before + 1
    want = quotient.fold_chunks_eager(*args)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cuda" and torch.equal(g, w), (chip.name, i)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CORE + RECURSION)
def test_card_kernel_equals_the_eager_fold(chips, cuda, name):
    _kernel_against_eager(chips[name], 10, cuda)


# the fixed heights of the fib2 benchmark guest's chips
FIB2_HEIGHTS = {"Cpu": 20, "AddSub": 20, "Branch": 18, "ShiftLeft": 18}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FIB2_HEIGHTS))
def test_card_kernel_equals_the_eager_fold_at_fib2_heights(chips, cuda, name):
    _kernel_against_eager(chips[name], FIB2_HEIGHTS[name], cuda)


def _fib_program(n_iters: int):
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


@pytest.fixture(scope="module")
def card_fib():
    """The fib guest proved on the card and on the CPU (the eager fold), the
    card's fold launches counted and the eager fold barred from it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from zkmips_tpu_torch.executor import execute_for_proving
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.utils import logger

    program = _fib_program(400)
    records, _ = execute_for_proving(program, shard_size=1 << 10)
    m = mips_machine(StarkConfig.test(), minimal=True)
    cpu_proofs = m.prove(m.setup(program, device="cpu"), records, device="cpu")
    pk = m.setup(program, device="cuda")

    def no_eager(chip, main_q, *args):
        if main_q.is_cuda:
            raise AssertionError("the eager fold ran on the card")
        return eager(chip, main_q, *args)

    eager = quotient.fold_chunks_eager
    before = quotient_cuda.LAUNCHES["quotient_fold"]
    logger.spans_reset()
    logger.configure(enabled=True, echo=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quotient, "fold_chunks_eager", no_eager)
        try:
            proofs = m.prove(pk, records, device="cuda", workers=1)
            notes = logger.notes_report()
        finally:
            logger.configure(enabled=False)
            logger.spans_reset()
    return {"m": m, "pk": pk, "program": program, "proofs": proofs, "cpu_proofs": cpu_proofs,
            "launches": quotient_cuda.LAUNCHES["quotient_fold"] - before, "notes": notes}


@pytest.mark.gpu
def test_card_fib_proof_verifies_and_equals_the_cpus(card_fib):
    from zkmips_tpu_torch.verifier import stark_codec

    r = card_fib
    assert len(r["proofs"]) >= 2
    assert r["m"].verify(r["pk"].vk, r["proofs"], r["program"])
    assert stark_codec.encode_core_proof(r["proofs"], config="test") == \
        stark_codec.encode_core_proof(r["cpu_proofs"], config="test")
    # one fold launch per chip of every shard, each noted under the quotient's span
    assert r["launches"] == sum(len(p.chip_names) for p in r["proofs"])
    tape_notes = {k: v for k, v in r["notes"].items() if "/quotient.tape." in k}
    assert all("prove.quotient/quotient.tape." in k for k in tape_notes)
    assert {k.rsplit(".", 1)[1] for k in tape_notes} == {n for p in r["proofs"] for n in p.chip_names}


@pytest.mark.gpu
def test_card_flipped_quotient_word_is_rejected_at_zeta(card_fib, monkeypatch):
    """The opening check refuses the flipped word first; with it passed over,
    the constraint identity at zeta refuses it too."""
    import copy

    from zkmips_tpu_torch.stark import pcs
    from zkmips_tpu_torch.stark.machine import VerificationError

    r = card_fib
    proofs = copy.deepcopy(r["proofs"])
    ov = proofs[0].opened[proofs[0].chip_names.index("Cpu")]
    ov.quotient[0][0] ^= 1
    with pytest.raises(VerificationError, match="pcs"):
        r["m"].verify(r["pk"].vk, proofs, r["program"])
    monkeypatch.setattr(pcs, "verify_batches", lambda *a, **k: None)
    with pytest.raises(VerificationError, match="constraint identity failed at zeta"):
        r["m"].verify(r["pk"].vk, proofs, r["program"])


def test_fold_kernel_source_names_every_opcode_and_kind():
    """The kernel's enums list the tape's opcodes and operand kinds in the
    tape module's order."""
    src = quotient_cuda.SOURCE.read_text()
    ops = ["ADD_BB", "SUB_BB", "MUL_BB", "NEG_B", "ADD_EE", "SUB_EE", "MUL_EE", "NEG_E",
           "ADD_EB", "SUB_EB", "SUB_BE", "MUL_EB", "FOLD_B", "FOLD_E"]
    kinds = ["K_BSLOT", "K_ESLOT", "K_UNI", "K_MAIN", "K_MAIN_NEXT", "K_PREP", "K_PREP_NEXT",
             "K_PERM", "K_PERM_NEXT", "K_SEL"]
    assert [getattr(qt, n) for n in ops] == list(range(len(ops)))
    assert [getattr(qt, n) for n in kinds] == list(range(len(kinds)))
    flat = " ".join(src.split())
    assert ", ".join(ops[:8]) + ", " + ", ".join(ops[8:]) in flat
    assert ", ".join(kinds[:7]) + ", " + ", ".join(kinds[7:]) in flat
    assert f"INDEX_BITS = {qt.INDEX_BITS}" in src
