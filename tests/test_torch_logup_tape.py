"""The LogUp tape (``stark/logup_tape.py``) against the eager permutation
trace (``permutation.generate_permutation_trace_eager``), bit for bit, for
every chip of the MIPS machine and of the recursion machine.

A plain torch evaluator of the tape, written as the kernels compute (the
tape over every row, the batch inversion, the chunk sums, the running sum by
tiles of rows and a scan of the tiles' totals), runs here on random
Montgomery inputs at 8 rows.  The kernels (``csrc/logup.cu``) have twins
marked ``gpu`` that run on a card and skip without one; this file imports no
JAX."""

import zlib

import numpy as np
import pytest
import torch

from zkmips_tpu_torch.machine.machine import core_chip_airs, mips_machine
from zkmips_tpu_torch.ops import ext4, field as f, logup_cuda
from zkmips_tpu_torch.recursion.machine import RecursionMachine
from zkmips_tpu_torch.stark import air, logup_tape as lt, permutation, quotient_tape as qt
from zkmips_tpu_torch.stark.chip import BaseAir, Chip

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


def _inputs(chip, h: int, dev="cpu") -> dict:
    """Random Montgomery traces and challenges for ``chip``, seeded by its name."""
    rng = np.random.default_rng(zlib.crc32(chip.name.encode()))
    prep = _rand(rng, (h, chip.preprocessed_width), dev) if chip.preprocessed_width else None
    return {"main": _rand(rng, (h, chip.main_width), dev), "prep": prep,
            "alpha": _rand(rng, (4,)), "beta": _rand(rng, (4,))}


def logup_plain(tape: lt.LogUpTape, main, prep, chal, tile: int = 128):
    """What the kernels compute, in plain torch: (perm_flat (H, 4 * width)
    int32, cumulative sum (4,) int32).  ``chal``: ``challenge_table``'s;
    ``tile``: the rows whose running sum one block scans."""
    h = main.shape[0]
    P = f.P
    mul = lambda x, y: x * y % P * f.R_INV % P
    w64 = lambda t: None if t is None else t.to(torch.int64) & 0xFFFFFFFF
    segs = {qt.K_MAIN: w64(main), qt.K_PREP: w64(prep)}
    consts, chal = w64(torch.from_numpy(tape.consts)), w64(chal)
    slots, den, mult = {}, {}, {}

    def get(word):
        kind, idx = qt.split(word)
        if kind == qt.K_BSLOT:
            return slots[idx]
        if kind == qt.K_UNI:
            return consts[idx].expand(h)
        return segs[kind][:, idx]

    for op, dst, a, b in tape.code.tolist():
        if op == qt.ADD_BB:
            slots[dst] = (get(a) + get(b)) % P
        elif op == qt.SUB_BB:
            slots[dst] = (get(a) - get(b)) % P
        elif op == qt.MUL_BB:
            slots[dst] = mul(get(a), get(b))
        elif op == qt.NEG_B:
            slots[dst] = (-get(a)) % P
        elif op == lt.LK_OPEN:
            d = chal[0].expand(h, 4).clone()
            d[:, 0] = (d[:, 0] + get(a)) % P
            den[dst] = d
        elif op == lt.LK_DEN:
            den[dst] = (den[dst] + mul(chal[1 + b], get(a)[:, None])) % P
        elif op == lt.LK_MULT:
            mult[dst] = (-get(a)) % P if b else get(a)
        else:
            raise ValueError(f"unknown opcode {op}")
    n = tape.n_lookups
    emul = lambda x, y: f.narrow(ext4._mul64(x, y) % P).to(torch.int64)
    inv = lambda x: ext4.inv(f.narrow(x)).to(torch.int64)
    if n > 2:  # the running products, one inverse, the back-multiplication
        pre = [den[0]]
        for i in range(1, n):
            pre.append(emul(pre[-1], den[i]))
        inv_p, invs = inv(pre[-1]), [None] * n
        for i in range(n - 1, 0, -1):
            invs[i], inv_p = emul(inv_p, pre[i - 1]), emul(inv_p, den[i])
        invs[0] = inv_p
    else:
        invs = [inv(den[i]) for i in range(n)]
    cols = [sum(mul(invs[i], mult[i][:, None]) for i in range(c, min(c + tape.batch_size, n))) % P
            for c in range(0, n, tape.batch_size)]
    row_sum = sum(cols) % P
    tiles = -(-h // tile)
    local = torch.cat([row_sum, row_sum.new_zeros((tiles * tile - h, 4))]).view(tiles, tile, 4).cumsum(1) % P
    totals = local[:, -1]
    before = (totals.cumsum(0) - totals) % P
    phi = ((local + before[:, None]) % P).view(-1, 4)[:h]
    return f.narrow(torch.cat(cols + [phi], dim=1)), f.narrow(totals.sum(0) % P)


def _tape_against_eager(chip, x, tile):
    want_flat, want_cum = permutation.generate_permutation_trace_eager(
        chip, x["prep"], x["main"], x["alpha"], x["beta"], chip.batch_size)
    tape = lt.chip_logup(chip, chip.batch_size)
    chal = lt.challenge_table(x["alpha"], x["beta"], tape.n_pows)
    flat, cum = logup_plain(tape, x["main"], x["prep"], chal, tile)
    assert flat.shape == want_flat.shape == (x["main"].shape[0], 4 * tape.width)
    assert torch.equal(flat, want_flat) and torch.equal(cum, want_cum), chip.name


@pytest.mark.parametrize("name", CORE + RECURSION)
def test_tape_evaluates_as_the_eager_path(chips, name):
    """At 8 rows in tiles of 3, so that the running sum crosses tiles and
    the last tile is ragged."""
    chip = chips[name]
    _tape_against_eager(chip, _inputs(chip, 1 << LOG_H), tile=3)


class _ZeroDenominator(BaseAir):
    """Lookups whose first denominator the test zeroes on row 0."""

    name = "ZeroDenominator"
    main_width = 3

    def __init__(self, many: bool):
        self.many = many

    def eval(self, b):
        b.send(air.LookupKind.Range, [b.main(0)], b.main(2))
        if self.many:
            b.send(air.LookupKind.Byte, [b.main(1), b.main(0)], b.main(2))
        b.receive(air.LookupKind.Range, [b.main(1)], 1)


def _zero_denominator_inputs(many: bool, h: int, dev="cpu"):
    """The chip, and inputs with alpha = -(kind + beta * main[0, 0]): the
    first lookup's denominator is 0 on row 0."""
    chip = Chip(_ZeroDenominator(many))
    rng = np.random.default_rng(9)
    main = f.to_monty(torch.from_numpy(rng.integers(0, 1000, size=(h, 3), dtype=np.int64)))
    beta = ext4.scalar(5, 1, 2, 3)
    d0 = ext4.add(ext4.scalar(int(air.LookupKind.Range)), ext4.mul_base(beta, main[0, 0]))
    return chip, {"main": main.to(dev), "prep": None, "alpha": ext4.neg(d0), "beta": beta}


@pytest.mark.parametrize("many", [True, False], ids=["batch_inversion", "each_alone"])
def test_tape_zeroes_the_fractions_the_eager_path_zeroes(many):
    """More than 2 lookups: the zero poisons the running product, so every
    fraction of row 0 is 0; 2 or fewer: only the zero's own."""
    chip, x = _zero_denominator_inputs(many, 16)
    _tape_against_eager(chip, x, tile=128)
    flat, _ = permutation.generate_permutation_trace_eager(chip, None, x["main"], x["alpha"], x["beta"])
    assert not flat[0, :4].any() if many else flat[0, :4].any()


def test_the_tape_is_compiled_once_a_chip(chips, monkeypatch):
    chip = chips["ShiftRight"]
    chip.__dict__.pop("_logup_tapes", None)
    calls = []
    compile_logup = lt.compile_logup
    monkeypatch.setattr(lt, "compile_logup", lambda c, bs: calls.append(c.name) or compile_logup(c, bs))
    first = lt.chip_logup(chip, chip.batch_size)
    assert lt.chip_logup(chip, chip.batch_size) is first and calls == ["ShiftRight"]
    assert first.on("cpu")[0] is first.on("cpu")[0]
    sends, receives = permutation.local_lookups(chip)
    assert first.n_lookups == len(sends) + len(receives)
    assert first.width == chip.perm_width_ext


def test_the_tape_refuses_what_the_kernel_cannot_read():
    class NextRow(BaseAir):
        name = "NextRow"
        main_width = 2

        def eval(self, b):
            b.send(air.LookupKind.Range, [b.main(0, 1)], b.main(1))

    with pytest.raises(ValueError, match="only the local main and preprocessed rows"):
        lt.compile_logup(Chip(NextRow()), 2)


def test_the_cpu_keeps_the_eager_path(chips, monkeypatch):
    chip = chips["AddSub"]
    x = _inputs(chip, 1 << LOG_H)
    before = dict(logup_cuda.LAUNCHES)
    monkeypatch.setattr(permutation, "generate_permutation_trace_kernel", None)  # never reached on the CPU
    flats, cums = permutation.generate_permutation_traces(
        [(chip, None, x["main"], chip.batch_size)], x["alpha"], x["beta"])
    assert logup_cuda.LAUNCHES == before
    want = permutation.generate_permutation_trace_eager(chip, None, x["main"], x["alpha"], x["beta"])
    assert torch.equal(flats[0], want[0]) and torch.equal(cums[0], want[1])
    tape = lt.chip_logup(chip, chip.batch_size)
    code, consts = tape.on("cpu")
    with pytest.raises(ValueError, match="not a CUDA device"):
        logup_cuda.permutation_trace(
            code, consts, x["main"], None, lt.challenge_table(x["alpha"], x["beta"], tape.n_pows),
            torch.zeros(4, dtype=torch.int32), n_base=tape.n_base, n_lookups=tape.n_lookups,
            batch_size=tape.batch_size)


def test_the_kernel_path_refuses_a_trace_the_tape_reads_and_lacks(chips):
    """The prover's side checks that the preprocessed trace the tape reads is
    given, before anything reaches the binding (which knows no tape)."""
    chip = chips["Program"]
    tape = lt.chip_logup(chip, chip.batch_size)
    assert air.PREPROCESSED in tape.reads
    x = _inputs(chip, 1 << LOG_H)
    with pytest.raises(ValueError, match="reads the preprocessed trace"):
        permutation.generate_permutation_trace_kernel(chip, tape, None, x["main"], None, None)


def test_rows_in_flight_keep_to_the_scratch_budget(chips):
    for name in ("Cpu", "KeccakSponge", "Bls12381Add", "Program"):
        tape = lt.chip_logup(chips[name], 2)
        n_base, n_ext = tape.n_base + tape.n_lookups, 2 * tape.n_lookups
        for h in (1, 16, 200, 1 << 12, 1 << 22):
            rows = logup_cuda.rows_in_flight(n_base, n_ext, h)
            assert rows % 128 == 0 and 128 <= rows <= max(128, -(-h // 128) * 128)
            assert rows == 128 or rows * (4 * n_base + 16 * n_ext) <= logup_cuda.SCRATCH_BYTES


def test_the_binding_imports_nothing_of_the_prover():
    """``ops/logup_cuda.py`` takes plain arguments: it imports nothing from
    ``stark``, so the imports run from the prover down to the binding only."""
    src = logup_cuda.__loader__.get_source(logup_cuda.__name__)
    assert "stark" not in "".join(l for l in src.splitlines() if l.lstrip().startswith(("import", "from")))


def test_kernel_source_names_every_opcode_and_kind():
    """The kernel's enums list the tapes' opcodes and operand kinds in the
    tape modules' order."""
    flat = " ".join(logup_cuda.SOURCE.read_text().split())
    assert [qt.ADD_BB, qt.SUB_BB, qt.MUL_BB, qt.NEG_B] == [0, 1, 2, 3]
    assert f"enum : int32_t {{ ADD_BB, SUB_BB, MUL_BB, NEG_B, LK_OPEN = {lt.LK_OPEN}, LK_DEN, LK_MULT }};" in flat
    assert (lt.LK_DEN, lt.LK_MULT) == (lt.LK_OPEN + 1, lt.LK_OPEN + 2)
    assert "enum : uint32_t { K_BSLOT, K_ESLOT, K_UNI, K_MAIN, K_MAIN_NEXT, K_PREP };" in flat
    assert (qt.K_BSLOT, qt.K_ESLOT, qt.K_UNI, qt.K_MAIN, qt.K_MAIN_NEXT, qt.K_PREP) == tuple(range(6))
    assert f"INDEX_BITS = {qt.INDEX_BITS}" in flat


# ----------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _kernels_against_eager(chip, x):
    before = logup_cuda.LAUNCHES["logup"]
    (flat,), (cum,) = permutation.generate_permutation_traces(
        [(chip, x["prep"], x["main"], chip.batch_size)], x["alpha"], x["beta"])
    assert logup_cuda.LAUNCHES["logup"] == before + logup_cuda.KERNELS_A_CHIP
    want_flat, want_cum = permutation.generate_permutation_trace_eager(
        chip, x["prep"], x["main"], x["alpha"], x["beta"], chip.batch_size)
    assert flat.device.type == "cuda" and torch.equal(flat, want_flat), chip.name
    assert torch.equal(cum, want_cum), chip.name


@pytest.mark.gpu
@pytest.mark.parametrize("name", CORE + RECURSION)
def test_card_kernels_equal_the_eager_path(chips, cuda, name):
    chip = chips[name]
    _kernels_against_eager(chip, _inputs(chip, 1 << 10, cuda))


# the fixed heights of the fib2 benchmark guest's chips
FIB2_HEIGHTS = {"Cpu": 20, "AddSub": 20, "Branch": 18, "ShiftLeft": 18}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FIB2_HEIGHTS))
def test_card_kernels_equal_the_eager_path_at_fib2_heights(chips, cuda, name):
    chip = chips[name]
    _kernels_against_eager(chip, _inputs(chip, 1 << FIB2_HEIGHTS[name], cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("many", [True, False], ids=["batch_inversion", "each_alone"])
def test_card_kernels_zero_the_fractions_the_eager_path_zeroes(cuda, many):
    chip, x = _zero_denominator_inputs(many, 300, cuda)
    _kernels_against_eager(chip, x)


class _OneFraction(BaseAir):
    """One send of no value: every row's sum is its multiplicity over alpha
    + the kind."""

    name = "OneFraction"
    main_width = 1

    def eval(self, b):
        b.send(air.LookupKind.Range, [], b.main(0))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1, 127, 128, 129, 4097, (1 << 16) + 5, 1 << 22])
def test_card_running_sum_crosses_tiles_with_words_at_p_minus_1(cuda, h):
    """alpha = 1 / T - the kind and multiplicity 1 make every row's sum T, whose
    words are all P - 1, so the running sum adds the largest words at every
    step; then random multiplicities.  Held to the eager path, whose scan is
    ``torch.cumsum``."""
    chip = Chip(_OneFraction())
    t = torch.full((4,), f.P - 1, dtype=torch.int32)
    alpha = ext4.sub(ext4.inv(t), ext4.scalar(int(air.LookupKind.Range)))
    ones = torch.full((h, 1), f.ONE, dtype=torch.int32, device=cuda)
    x = {"main": ones, "prep": None, "alpha": alpha, "beta": ext4.scalar(7)}
    _kernels_against_eager(chip, x)
    rng = np.random.default_rng(h)
    _kernels_against_eager(chip, dict(x, main=_rand(rng, (h, 1), cuda)))


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


@pytest.mark.gpu
def test_card_fib_proof_verifies_and_equals_the_cpus(cuda):
    """The fib guest proved on the card with the eager path barred there, and
    on the CPU: the same bytes, verified, the kernels launched for every
    chip with lookups and noted under the stage's span."""
    from zkmips_tpu_torch.executor import execute_for_proving
    from zkmips_tpu_torch.stark.machine import StarkConfig
    from zkmips_tpu_torch.utils import logger
    from zkmips_tpu_torch.verifier import stark_codec

    program = _fib_program(400)
    records, _ = execute_for_proving(program, shard_size=1 << 10)
    m = mips_machine(StarkConfig.test(), minimal=True)
    cpu_proofs = m.prove(m.setup(program, device="cpu"), records, device="cpu")
    pk = m.setup(program, device="cuda")
    eager = permutation.generate_permutation_trace_eager

    def no_eager(chip, prep, main, *args):
        if main.is_cuda:
            raise AssertionError("the eager LogUp trace ran on the card")
        return eager(chip, prep, main, *args)

    before = logup_cuda.LAUNCHES["logup"]
    logger.spans_reset()
    logger.configure(enabled=True, echo=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(permutation, "generate_permutation_trace_eager", no_eager)
        try:
            proofs = m.prove(pk, records, device="cuda", workers=1)
            notes = logger.notes_report()
        finally:
            logger.configure(enabled=False)
            logger.spans_reset()
    assert len(proofs) >= 2
    assert m.verify(pk.vk, proofs, program)
    assert stark_codec.encode_core_proof(proofs, config="test") == \
        stark_codec.encode_core_proof(cpu_proofs, config="test")
    with_lookups = [n for p in proofs for n in p.chip_names if any(permutation.local_lookups(m.machine.chip_map[n]))]
    assert logup_cuda.LAUNCHES["logup"] - before == logup_cuda.KERNELS_A_CHIP * len(with_lookups)
    tape_notes = {k for k in notes if "/perm.tape." in k}
    assert all("prove.perm_traces/perm.tape." in k for k in tape_notes)
    assert {k.rsplit(".", 1)[1] for k in tape_notes} == set(with_lookups)
