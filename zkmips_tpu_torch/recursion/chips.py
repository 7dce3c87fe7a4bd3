"""Recursion machine chips.

Analog of crates/recursion/core/src/chips/: program structure (addresses,
selectors, read multiplicities) is *preprocessed* per recursion program;
main traces carry only runtime values.  The memory argument is SSA-flavored:
every write sends [addr, v0..v3] once with multiplicity = number of reads;
every read receives it once (LogUp balances the counts).

The AIRs are the reference's (``zkmips_tpu/recursion/chips.py``) on the
port's builder; the fills are host numpy and return canonical uint32
traces, which ``StarkMachine.prove_shard`` uploads to the device.
"""

from __future__ import annotations

import numpy as np

from ..machine.gadgets import ColView, Schema
from ..machine.poseidon2_chip import (
    DIAG, RC_EXT_FIRST, RC_EXT_SECOND, RC_INTERNAL, _canon, _ext_linear_expr,
)
from ..ops import field as ff, poseidon2 as p2
from ..ops.poseidon2 import ROUNDS_P
from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from . import program as pr

MEM = LookupKind.Memory


def mem_msg(addr, v):
    return [addr, v[0], v[1], v[2], v[3]]


class RecMemConstAir(BaseAir):
    """Program constants: fully preprocessed writes (chips/mem/constant)."""

    name = "RecMemConst"
    preprocessed_width = 6  # addr, v0..3, mult
    main_width = 1  # unused filler (framework wants >= 1 main column)

    def eval(self, b: AirBuilder):
        addr = b.preprocessed(0)
        v = [b.preprocessed(1 + i) for i in range(4)]
        b.send(MEM, mem_msg(addr, v), b.preprocessed(5))

    def generate_preprocessed(self, program):
        rows = [
            (ins.addr, *ins.value, ins.mult)
            for ins in program.instructions
            if isinstance(ins, pr.MemConst)
        ]
        t = np.zeros((max(len(rows), 1), 6), dtype=np.uint32)
        for i, r in enumerate(rows):
            t[i] = r
        return t

    def generate_trace(self, record, output):
        n = sum(1 for ins in record.program.instructions if isinstance(ins, pr.MemConst))
        return np.zeros((max(n, 1), 1), dtype=np.uint32)


class RecMemVarAir(BaseAir):
    """Hint writes: addresses/mults preprocessed, values from the witness."""

    name = "RecMemVar"
    preprocessed_width = 3  # addr, mult, is_real
    main_width = 4  # v0..3

    def eval(self, b: AirBuilder):
        v = [b.main(i) for i in range(4)]
        b.send(MEM, mem_msg(b.preprocessed(0), v), b.preprocessed(1))

    def generate_preprocessed(self, program):
        rows = []
        for ins in program.instructions:
            if isinstance(ins, pr.Hint):
                rows.append((ins.addr, ins.mult, 1))
            elif isinstance(ins, (pr.HintBits, pr.HintExt2Felts)):
                rows.extend(
                    (a, m, 1) for a, m in zip(ins.output_addrs, ins.mults)
                )
        t = np.zeros((max(len(rows), 1), 3), dtype=np.uint32)
        for i, r in enumerate(rows):
            t[i] = r
        return t

    def generate_trace(self, record, output):
        events = record.hint_events
        t = np.zeros((max(len(events), 1), 4), dtype=np.uint32)
        for i, (_addr, val) in enumerate(events):
            t[i] = val
        return t


class _AluAir(BaseAir):
    """Shared base/ext ALU structure (chips/alu_base, alu_ext)."""

    preprocessed_width = 9  # is_add..is_div, is_assert, out, in1, in2, mult
    main_width = 12  # a(4), b(4), o(4)
    EXT = False

    def eval(self, b: AirBuilder):
        sels = [b.preprocessed(i) for i in range(5)]
        out_a, in1_a, in2_a = b.preprocessed(5), b.preprocessed(6), b.preprocessed(7)
        is_real = sels[0] + sels[1] + sels[2] + sels[3] + sels[4]
        a = [b.main(i) for i in range(4)]
        bb = [b.main(4 + i) for i in range(4)]
        o = [b.main(8 + i) for i in range(4)]
        b.receive(MEM, mem_msg(in1_a, a), is_real)
        b.receive(MEM, mem_msg(in2_a, bb), is_real)
        b.send(MEM, mem_msg(out_a, o), b.preprocessed(8))
        is_add, is_sub, is_mul, is_div, is_assert = sels
        if not self.EXT:
            b.when(is_add).assert_eq(o[0], a[0] + bb[0])
            b.when(is_sub).assert_eq(o[0] + bb[0], a[0])
            b.when(is_mul).assert_eq(o[0], a[0] * bb[0])
            b.when(is_div).assert_eq(o[0] * bb[0], a[0])
            b.when(is_assert).assert_eq(a[0], bb[0])
            for i in range(1, 4):
                b.when(is_real).assert_zero(o[i])
        else:
            for i in range(4):
                b.when(is_add).assert_eq(o[i], a[i] + bb[i])
                b.when(is_sub).assert_eq(o[i] + bb[i], a[i])
                b.when(is_assert).assert_eq(a[i], bb[i])
            mul_ab = _ext_mul_expr(a, bb)
            mul_ob = _ext_mul_expr(o, bb)
            for i in range(4):
                b.when(is_mul).assert_eq(o[i], mul_ab[i])
                b.when(is_div).assert_eq(mul_ob[i], a[i])

    def _events(self, record):
        return record.ext_alu_events if self.EXT else record.base_alu_events

    def generate_preprocessed(self, program):
        cls = pr.ExtAlu if self.EXT else pr.BaseAlu
        rows = []
        for ins in program.instructions:
            if isinstance(ins, cls):
                sel = [0, 0, 0, 0, 0]
                sel[int(ins.op)] = 1
                rows.append((*sel, ins.out, ins.in1, ins.in2, ins.mult))
        t = np.zeros((max(len(rows), 1), 9), dtype=np.uint32)
        for i, r in enumerate(rows):
            t[i] = r
        return t

    def generate_trace(self, record, output):
        events = self._events(record)
        t = np.zeros((max(len(events), 1), 12), dtype=np.uint32)
        for i, (_op, _out, _i1, _i2, a, bb, o, _m) in enumerate(events):
            t[i, 0:4] = a
            t[i, 4:8] = bb
            t[i, 8:12] = o
        return t


def _ext_mul_expr(a, b):
    """Schoolbook X^4 = 3 multiplication over Exprs."""
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            t = a[i] * b[j]
            c[i + j] = t if isinstance(c[i + j], int) else c[i + j] + t
    out = []
    for k in range(4):
        e = c[k]
        if k + 4 <= 6 and not isinstance(c[k + 4], int):
            e = e + c[k + 4] * 3
        out.append(e)
    return out


class RecBaseAluAir(_AluAir):
    name = "RecBaseAlu"
    EXT = False


class RecExtAluAir(_AluAir):
    name = "RecExtAlu"
    EXT = True


class RecPoseidon2Air(BaseAir):
    """One row per permutation; external-round outputs + internal lane-0
    s-boxes witnessed, linear layers as expressions (chips/poseidon2_wide)."""

    name = "RecPoseidon2"

    def __init__(self):
        self.preprocessed_width = 49  # 16 in addrs + 16 out addrs + 16 mults + is_real
        names = [f"in{i}" for i in range(16)]
        for r in range(8):
            names += [f"x{r}_{i}" for i in range(16)]
        names += [f"t{r}" for r in range(ROUNDS_P)]
        self.schema = Schema(names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = b.preprocessed(48)
        inp = [col(f"in{i}") for i in range(16)]
        for i in range(16):
            b.receive(MEM, mem_msg(b.preprocessed(i), _block(inp[i])), is_real)

        state = _ext_linear_expr(inp)
        widx = 0
        for r in range(4):
            sb = [col(f"x{widx}_{i}") for i in range(16)]
            for i in range(16):
                e = state[i] + int(_canon(RC_EXT_FIRST[r, i]))
                b.when(is_real).assert_eq(sb[i], e * e * e)
            state = _ext_linear_expr(sb)
            widx += 1
        for r in range(ROUNDS_P):
            t = col(f"t{r}")
            e = state[0] + int(_canon(RC_INTERNAL[r]))
            b.when(is_real).assert_eq(t, e * e * e)
            state = [t] + state[1:]
            total = state[0]
            for s_ in state[1:]:
                total = total + s_
            state = [state[i] * int(_canon(DIAG[i])) + total for i in range(16)]
        for r in range(4):
            sb = [col(f"x{widx}_{i}") for i in range(16)]
            for i in range(16):
                e = state[i] + int(_canon(RC_EXT_SECOND[r, i]))
                b.when(is_real).assert_eq(sb[i], e * e * e)
            state = _ext_linear_expr(sb)
            widx += 1
        for i in range(16):
            b.send(MEM, mem_msg(b.preprocessed(16 + i), _block(state[i])), b.preprocessed(32 + i))

    def generate_preprocessed(self, program):
        rows = []
        for ins in program.instructions:
            if isinstance(ins, pr.Poseidon2):
                rows.append((*ins.inp, *ins.out, *ins.mults, 1))
        t = np.zeros((max(len(rows), 1), 49), dtype=np.uint32)
        for i, r in enumerate(rows):
            t[i] = r
        return t

    def generate_trace(self, record, output):
        """Vectorized witness replay over all events at once: the same round
        structure as eval(), batched on an (N, 16) array of canonical values
        (the permutation's arithmetic commutes with the Montgomery map)."""
        events = record.poseidon2_events
        s = self.schema
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32)
        if not events:
            return t
        n = len(events)
        in_vals = np.array([ev[1] for ev in events], dtype=np.int64)  # canonical
        t[:n, s.idx("in0") : s.idx("in0") + 16] = in_vals

        def cube(x):
            return x * x % ff.P * x % ff.P

        state = _ext_linear_rows(in_vals)
        widx = 0
        for r in range(4):
            state = cube((state + _RC1[r]) % ff.P)
            t[:n, s.idx(f"x{widx}_0") : s.idx(f"x{widx}_0") + 16] = state
            state = _ext_linear_rows(state)
            widx += 1
        for r in range(ROUNDS_P):
            s0 = cube((state[:, 0] + _RCI[r]) % ff.P)
            t[:n, s.idx(f"t{r}")] = s0
            state = np.concatenate([s0[:, None], state[:, 1:]], axis=1)
            total = state.sum(axis=1, keepdims=True) % ff.P
            state = (state * _DIAG_C % ff.P + total) % ff.P
        for r in range(4):
            state = cube((state + _RC2[r]) % ff.P)
            t[:n, s.idx(f"x{widx}_0") : s.idx(f"x{widx}_0") + 16] = state
            state = _ext_linear_rows(state)
            widx += 1
        return t


# the permutation's constants as canonical int64 arrays, for the fill
_RC1 = np.array([[_canon(c) for c in row] for row in RC_EXT_FIRST], dtype=np.int64)
_RCI = np.array([_canon(c) for c in RC_INTERNAL], dtype=np.int64)
_RC2 = np.array([[_canon(c) for c in row] for row in RC_EXT_SECOND], dtype=np.int64)
_DIAG_C = np.array([_canon(c) for c in DIAG], dtype=np.int64)


def _ext_linear_rows(state: np.ndarray) -> np.ndarray:
    """The external linear layer on (N, 16) canonical int64 rows (entries of
    the matrix are small: every partial sum stays below 2^38)."""
    return (state @ p2.EXT_MATRIX.T) % ff.P


def _block(e):
    return [e, 0, 0, 0]


class RecSelectAir(BaseAir):
    """Conditional swap (chips/select)."""

    name = "RecSelect"
    preprocessed_width = 8  # bit, out1, out2, in1, in2, mult1, mult2, is_real
    main_width = 3  # bit_v, a, b  (base values only)

    def eval(self, b: AirBuilder):
        is_real = b.preprocessed(7)
        bit, a, bb = b.main(0), b.main(1), b.main(2)
        b.when(is_real).assert_bool(bit)
        b.receive(MEM, mem_msg(b.preprocessed(0), _block(bit)), is_real)
        b.receive(MEM, mem_msg(b.preprocessed(3), _block(a)), is_real)
        b.receive(MEM, mem_msg(b.preprocessed(4), _block(bb)), is_real)
        o1 = a + bit * (bb - a)
        o2 = bb + bit * (a - bb)
        b.send(MEM, mem_msg(b.preprocessed(1), _block(o1)), b.preprocessed(5))
        b.send(MEM, mem_msg(b.preprocessed(2), _block(o2)), b.preprocessed(6))

    def generate_preprocessed(self, program):
        rows = []
        for ins in program.instructions:
            if isinstance(ins, pr.Select):
                rows.append((ins.bit, ins.out1, ins.out2, ins.in1, ins.in2, ins.mult1, ins.mult2, 1))
        t = np.zeros((max(len(rows), 1), 8), dtype=np.uint32)
        for i, r in enumerate(rows):
            t[i] = r
        return t

    def generate_trace(self, record, output):
        events = record.select_events
        t = np.zeros((max(len(events), 1), 3), dtype=np.uint32)
        for i, (_ins, bit, a, bb, _o1, _o2) in enumerate(events):
            t[i] = (bit, a[0], bb[0])
        return t


class RecExpReverseBitsAir(BaseAir):
    """Exp-reverse-bits chip: one row per exponent bit (square-and-multiply).

    Analog of the reference ExpReverseBitsLenChip (reference:
    crates/recursion/core/src/chips/exp_reverse_bits.rs) — it exists there
    because lowering the FRI x-recovery power ladder to ALU+Select chains
    bloats recursion traces (3 ALU rows + 1 Select row per bit vs 1 row
    here).  Row r of an event holds sq = acc_{r-1}^2 and
    acc_r = sq * (bit ? base : 1); the last row's acc is the result.
    All arithmetic constraints hold on all-zero padding rows, so only the
    memory multiplicities carry is_real guards (keeps max degree at 3).
    """

    name = "RecExpReverseBits"
    preprocessed_width = 7  # bit_addr, base_addr, out_addr, out_mult, is_first, is_cont, is_real
    main_width = 4  # x (base), b (bit), sq, acc

    def eval(self, b: AirBuilder):
        bit_addr, base_addr, out_addr = (b.preprocessed(i) for i in range(3))
        out_mult, is_first, is_real = b.preprocessed(3), b.preprocessed(4), b.preprocessed(6)
        is_cont_next = b.preprocessed(5, offset=1)
        x, bit, sq, acc = (b.main(i) for i in range(4))
        x_next, sq_next = b.main(0, offset=1), b.main(2, offset=1)

        b.assert_bool(bit)  # padding rows: 0 is boolean
        # acc = sq * (1 + bit * (x - 1))  (degree 3; padding: 0 == 0)
        b.assert_eq(acc, sq + sq * bit * (x - 1))
        # first row of an event starts the ladder at 1
        b.when(is_first).assert_one(sq)
        # continuation rows: square the previous accumulator, same base.
        # is_cont is never set on trace row 0, so the cyclic wrap of the
        # offset-1 access at the last row is inert.
        b.when(is_cont_next).assert_eq(sq_next, acc * acc)
        b.when(is_cont_next).assert_eq(x_next, x)

        b.receive(MEM, mem_msg(bit_addr, _block(bit)), is_real)
        b.receive(MEM, mem_msg(base_addr, _block(x)), is_first)
        b.send(MEM, mem_msg(out_addr, _block(acc)), out_mult)

    def generate_preprocessed(self, program):
        rows = []
        for ins in program.instructions:
            if not isinstance(ins, pr.ExpReverseBitsLen):
                continue
            n = len(ins.bit_addrs)
            for k, ba in enumerate(ins.bit_addrs):
                last = k == n - 1
                rows.append((
                    ba, ins.base, ins.out if last else 0,
                    ins.mult if last else 0,
                    1 if k == 0 else 0, 0 if k == 0 else 1, 1,
                ))
        t = np.zeros((max(len(rows), 1), self.preprocessed_width), dtype=np.uint32)
        for i, r in enumerate(rows):
            t[i] = r
        return t

    def generate_trace(self, record, output):
        rows = []
        for _ins, base, bits, _val in record.exp_bits_events:
            acc = 1
            for bit in bits:
                sq = acc * acc % ff.P
                acc = sq * (base if bit else 1) % ff.P
                rows.append((base, bit, sq, acc))
        t = np.zeros((max(len(rows), 1), self.main_width), dtype=np.uint32)
        for i, r in enumerate(rows):
            t[i] = r
        return t


class RecPublicValuesAir(BaseAir):
    """Bind committed felts to the machine public values (chips/public_values).

    One row per public value with a one-hot index flag block (num_pv prep
    columns); parametric in the machine's pv count (8 for the digest-only
    machines, rec_pv.NUM_REC_PV for the aggregation record)."""

    def __init__(self, num_pv: int = 8):
        self.num_pv = num_pv
        self.name = "RecPublicValues"
        self.preprocessed_width = num_pv + 2  # addr, one-hot flags, is_real
        self.main_width = 1  # value

    def eval(self, b: AirBuilder):
        n = self.num_pv
        is_real = b.preprocessed(n + 1)
        v = b.main(0)
        b.receive(MEM, mem_msg(b.preprocessed(0), _block(v)), is_real)
        for i in range(n):
            b.when(b.preprocessed(1 + i)).assert_eq(v, b.public_value(i))

    def generate_preprocessed(self, program):
        commit = None
        for ins in program.instructions:
            if isinstance(ins, pr.CommitPublicValues):
                commit = ins
        n = self.num_pv
        t = np.zeros((n, n + 2), dtype=np.uint32)
        if commit is not None:
            assert len(commit.addrs) == n, (
                f"program commits {len(commit.addrs)} pvs, machine expects {n}"
            )
            for i in range(n):
                t[i, 0] = commit.addrs[i]
                t[i, 1 + i] = 1
                t[i, n + 1] = 1
        return t

    def generate_trace(self, record, output):
        n = self.num_pv
        t = np.zeros((n, 1), dtype=np.uint32)
        pvs = list(record.public_values)[:n]
        for i, v in enumerate(pvs):
            t[i, 0] = v
        return t


class RecFriFoldAir(BaseAir):
    """FRI fold accumulator chip: one row per (instruction, matrix) pair.

    Analog of the reference FriFoldChip (recursion chips/fri_fold): with
    committed values x, z, alpha, p(x), p(z), alpha_pow, ro the row enforces
      (ro' - ro) * (x - z) == alpha_pow * (p(x) - p(z))
      alpha_pow'           == alpha_pow * alpha
    and the nine memory interactions (7 reads, 2 multiplicity-weighted
    writes) against the flat recursion memory.
    """

    name = "RecFriFold"
    preprocessed_width = 12  # x,z,alpha,px,pz,api,roi,apo,roo addrs + 2 mults + is_real
    main_width = 33

    def eval(self, b: AirBuilder):
        addr = [b.preprocessed(i) for i in range(9)]
        apow_mult, ro_mult = b.preprocessed(9), b.preprocessed(10)
        is_real = b.preprocessed(11)
        x = b.main(0)
        z = [b.main(1 + i) for i in range(4)]
        alpha = [b.main(5 + i) for i in range(4)]
        px = [b.main(9 + i) for i in range(4)]
        pz = [b.main(13 + i) for i in range(4)]
        api = [b.main(17 + i) for i in range(4)]
        roi = [b.main(21 + i) for i in range(4)]
        apo = [b.main(25 + i) for i in range(4)]
        roo = [b.main(29 + i) for i in range(4)]

        b.receive(MEM, mem_msg(addr[0], [x, 0, 0, 0]), is_real)
        for a, blk in zip(addr[1:7], (z, alpha, px, pz, api, roi)):
            b.receive(MEM, mem_msg(a, blk), is_real)
        b.send(MEM, mem_msg(addr[7], apo), apow_mult)
        b.send(MEM, mem_msg(addr[8], roo), ro_mult)

        xz = [x - z[0], 0 - z[1], 0 - z[2], 0 - z[3]]
        lhs = _ext_mul_expr([roo[i] - roi[i] for i in range(4)], xz)
        rhs = _ext_mul_expr(api, [px[i] - pz[i] for i in range(4)])
        for i in range(4):
            b.when(is_real).assert_eq(lhs[i], rhs[i])
        prod = _ext_mul_expr(api, alpha)
        for i in range(4):
            b.when(is_real).assert_eq(apo[i], prod[i])

    def generate_preprocessed(self, program):
        rows = []
        for ins in program.instructions:
            if isinstance(ins, pr.FriFold):
                for m in range(len(ins.ps_at_z)):
                    rows.append((
                        ins.x, ins.z, ins.alpha, ins.mat_opening[m], ins.ps_at_z[m],
                        ins.alpha_pow_input[m], ins.ro_input[m],
                        ins.alpha_pow_output[m], ins.ro_output[m],
                        ins.alpha_pow_mults[m], ins.ro_mults[m], 1,
                    ))
        t = np.zeros((max(len(rows), 1), self.preprocessed_width), dtype=np.uint32)
        for i, r in enumerate(rows):
            t[i] = r
        return t

    def generate_trace(self, record, output):
        events = record.fri_fold_events
        t = np.zeros((max(len(events), 1), self.main_width), dtype=np.uint32)
        for i, (x, z, alpha, px, pz, api, roi, apo, roo, _ins, _m) in enumerate(events):
            t[i, 0] = x
            t[i, 1:5] = z
            t[i, 5:9] = alpha
            t[i, 9:13] = px
            t[i, 13:17] = pz
            t[i, 17:21] = api
            t[i, 21:25] = roi
            t[i, 25:29] = apo
            t[i, 29:33] = roo
        return t


class RecBatchFRIAir(BaseAir):
    """Batched FRI accumulation chip: one row per (instruction, matrix) with
    a running accumulator; the last row writes acc to memory (reference
    chips/batch_fri)."""

    name = "RecBatchFRI"
    preprocessed_width = 8  # px_a, pz_a, apow_a, acc_a, acc_mult, first, last, is_real
    main_width = 13  # px, pz(4), apow(4), acc(4)

    def eval(self, b: AirBuilder):
        px_a, pz_a, apow_a, acc_a = (b.preprocessed(i) for i in range(4))
        acc_mult = b.preprocessed(4)
        first, last, is_real = b.preprocessed(5), b.preprocessed(6), b.preprocessed(7)
        px = b.main(0)
        pz = [b.main(1 + i) for i in range(4)]
        apow = [b.main(5 + i) for i in range(4)]
        acc = [b.main(9 + i) for i in range(4)]

        b.receive(MEM, mem_msg(px_a, [px, 0, 0, 0]), is_real)
        b.receive(MEM, mem_msg(pz_a, pz), is_real)
        b.receive(MEM, mem_msg(apow_a, apow), is_real)
        b.send(MEM, mem_msg(acc_a, acc), acc_mult * last)

        term = _ext_mul_expr(apow, [pz[0] - px, pz[1], pz[2], pz[3]])
        for i in range(4):
            b.when(first).assert_eq(acc[i], term[i])
        # rows of one instruction are contiguous: acc chains forward
        nxt_term = _ext_mul_expr(
            [b.main(5 + i, 1) for i in range(4)],
            [b.main(1, 1) - b.main(0, 1), b.main(2, 1), b.main(3, 1), b.main(4, 1)],
        )
        for i in range(4):
            b.when_transition().when(is_real - last).assert_eq(
                b.main(9 + i, 1), acc[i] + nxt_term[i]
            )

    def generate_preprocessed(self, program):
        rows = []
        for ins in program.instructions:
            if isinstance(ins, pr.BatchFRI):
                n = len(ins.p_at_z)
                for m in range(n):
                    rows.append((
                        ins.p_at_x[m], ins.p_at_z[m], ins.alpha_pow[m], ins.acc,
                        ins.acc_mult, 1 if m == 0 else 0, 1 if m == n - 1 else 0, 1,
                    ))
        t = np.zeros((max(len(rows), 1), self.preprocessed_width), dtype=np.uint32)
        for i, r in enumerate(rows):
            t[i] = r
        return t

    def generate_trace(self, record, output):
        events = record.batch_fri_events
        t = np.zeros((max(len(events), 1), self.main_width), dtype=np.uint32)
        for i, (px, pz, apow, acc, _ins, _m) in enumerate(events):
            t[i, 0] = px
            t[i, 1:5] = pz
            t[i, 5:9] = apow
            t[i, 9:13] = acc
        return t
