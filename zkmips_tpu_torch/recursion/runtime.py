"""Recursion VM runtime: execute a RecursionProgram, collect chip events.

The Python interpreter (crates/recursion/core/src/runtime/mod.rs:76,260
analog): straight-line execution over a flat block memory with a witness
stream for hints.  Values are 4-tuples of canonical ints (base values use
coordinate 0).  ``RecursionMachine.execute`` runs the C interpreter
(``native_runtime``); this one is the reference the tests hold it against.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops import field as ff, poseidon2 as p2
from . import program as pr


@dataclass
class RecursionRecord:
    program: object = None
    mem_const_events: list = field(default_factory=list)  # (addr, value4, mult)
    base_alu_events: list = field(default_factory=list)  # (op, out_addr, a4, b4, o4, mult)
    ext_alu_events: list = field(default_factory=list)
    poseidon2_events: list = field(default_factory=list)  # (in_addrs, in_vals, out_addrs, out_vals, mults)
    select_events: list = field(default_factory=list)
    exp_bits_events: list = field(default_factory=list)
    fri_fold_events: list = field(default_factory=list)  # one per matrix index
    batch_fri_events: list = field(default_factory=list)  # one per matrix index
    hint_events: list = field(default_factory=list)
    public_values: list = field(default_factory=lambda: [0] * 8)


class RecursionRuntime:
    def __init__(self, program: pr.RecursionProgram, witness_stream=()):
        self.program = program
        self.memory: dict[int, tuple] = {}
        self.witness = list(witness_stream)
        self.witness_ptr = 0
        self.record = RecursionRecord(program=program)

    def _w(self, addr: int, value: tuple):
        assert addr not in self.memory, f"address {addr} written twice"
        self.memory[addr] = tuple(v % ff.P for v in value)

    def _r(self, addr: int) -> tuple:
        return self.memory[addr]

    def run(self) -> RecursionRecord:
        rec = self.record
        for ins in self.program.instructions:
            if isinstance(ins, pr.MemConst):
                self._w(ins.addr, ins.value)
                rec.mem_const_events.append((ins.addr, ins.value, ins.mult))
            elif isinstance(ins, pr.Hint):
                val = tuple(self.witness[self.witness_ptr])
                self.witness_ptr += 1
                self._w(ins.addr, val)
                rec.mem_const_events.append((ins.addr, val, ins.mult))
                rec.hint_events.append((ins.addr, val))
            elif isinstance(ins, pr.BaseAlu):
                a, b = self._r(ins.in1), self._r(ins.in2)
                if ins.op == pr.BaseOp.ASSERT_EQ:
                    if a[0] != b[0]:
                        raise AssertionError(
                            f"circuit assert failed (base): {a[0]} != {b[0]}"
                        )
                    o = (0, 0, 0, 0)
                else:
                    o = (_base_op(ins.op, a[0], b[0]), 0, 0, 0)
                    self._w(ins.out, o)
                rec.base_alu_events.append((ins.op, ins.out, ins.in1, ins.in2, a, b, o, ins.mult))
            elif isinstance(ins, pr.ExtAlu):
                a, b = self._r(ins.in1), self._r(ins.in2)
                if ins.op == pr.BaseOp.ASSERT_EQ:
                    if a != b:
                        raise AssertionError(
                            f"circuit assert failed (ext): {a} != {b}"
                        )
                    o = (0, 0, 0, 0)
                else:
                    o = _ext_op(ins.op, a, b)
                    self._w(ins.out, o)
                rec.ext_alu_events.append((ins.op, ins.out, ins.in1, ins.in2, a, b, o, ins.mult))
            elif isinstance(ins, pr.Poseidon2):
                vals = [self._r(a) for a in ins.inp]
                out = p2.permute_ints([ff.to_monty_int(v[0]) for v in vals])
                outs = [ff.from_monty_int(x) for x in out]
                for a, v in zip(ins.out, outs):
                    self._w(a, (v, 0, 0, 0))
                rec.poseidon2_events.append((ins.inp, [v[0] for v in vals], ins.out, outs, ins.mults))
            elif isinstance(ins, pr.Select):
                bit = self._r(ins.bit)[0]
                a, b = self._r(ins.in1), self._r(ins.in2)
                o1, o2 = (b, a) if bit else (a, b)
                self._w(ins.out1, o1)
                self._w(ins.out2, o2)
                rec.select_events.append((ins, bit, a, b, o1, o2))
            elif isinstance(ins, pr.ExpReverseBitsLen):
                base = self._r(ins.base)[0]
                bits = [self._r(a)[0] for a in ins.bit_addrs]
                exp = 0
                for bit in bits:  # reversed bit order
                    exp = exp * 2 + bit
                val = pow(base, exp, ff.P)
                self._w(ins.out, (val, 0, 0, 0))
                rec.exp_bits_events.append((ins, base, bits, val))
            elif isinstance(ins, pr.HintBits):
                v = self._r(ins.value_addr)[0]
                for k, addr in enumerate(ins.output_addrs):
                    bit = (v >> k) & 1
                    self._w(addr, (bit, 0, 0, 0))
                    rec.hint_events.append((addr, (bit, 0, 0, 0)))
            elif isinstance(ins, pr.HintExt2Felts):
                blk = self._r(ins.value_addr)
                for k, addr in enumerate(ins.output_addrs):
                    self._w(addr, (blk[k], 0, 0, 0))
                    rec.hint_events.append((addr, (blk[k], 0, 0, 0)))
            elif isinstance(ins, pr.Print):
                print(f"[recursion print] {ins.label}: {self._r(ins.addr)}")
            elif isinstance(ins, pr.FriFold):
                x = self._r(ins.x)[0]
                z = self._r(ins.z)
                alpha = self._r(ins.alpha)
                xz = _ext_sub((x, 0, 0, 0), z)
                inv_xz = _ext_inv(xz)
                for m in range(len(ins.ps_at_z)):
                    p_at_x = self._r(ins.mat_opening[m])
                    p_at_z = self._r(ins.ps_at_z[m])
                    apow = self._r(ins.alpha_pow_input[m])
                    ro = self._r(ins.ro_input[m])
                    q = _ext_mul(_ext_sub(p_at_x, p_at_z), inv_xz)
                    new_ro = _ext_add(ro, _ext_mul(apow, q))
                    new_apow = _ext_mul(apow, alpha)
                    self._w(ins.ro_output[m], new_ro)
                    self._w(ins.alpha_pow_output[m], new_apow)
                    rec.fri_fold_events.append(
                        (x, z, alpha, p_at_x, p_at_z, apow, ro, new_apow, new_ro,
                         ins, m)
                    )
            elif isinstance(ins, pr.BatchFRI):
                acc = (0, 0, 0, 0)
                n = len(ins.p_at_z)
                for m in range(n):
                    px = self._r(ins.p_at_x[m])[0]
                    pz = self._r(ins.p_at_z[m])
                    apow = self._r(ins.alpha_pow[m])
                    acc = _ext_add(acc, _ext_mul(apow, _ext_sub(pz, (px, 0, 0, 0))))
                    rec.batch_fri_events.append((px, pz, apow, acc, ins, m))
                self._w(ins.acc, acc)
            elif isinstance(ins, pr.CommitPublicValues):
                rec.public_values = [self._r(a)[0] for a in ins.addrs]
            else:
                raise TypeError(ins)
        return rec


def _base_op(op: pr.BaseOp, a: int, b: int) -> int:
    if op == pr.BaseOp.ADD:
        return (a + b) % ff.P
    if op == pr.BaseOp.SUB:
        return (a - b) % ff.P
    if op == pr.BaseOp.MUL:
        return a * b % ff.P
    return a * pow(b, ff.P - 2, ff.P) % ff.P


def _ext_op(op: pr.BaseOp, a: tuple, b: tuple) -> tuple:
    """Quartic-extension op on canonical int 4-tuples (X^4 = 3).

    Pure-Python int arithmetic: the runtime executes one op per instruction,
    where per-op numpy/Montgomery round-trips dominate by ~100x.
    """
    P = ff.P
    if op == pr.BaseOp.ADD:
        return tuple((x + y) % P for x, y in zip(a, b))
    if op == pr.BaseOp.SUB:
        return tuple((x - y) % P for x, y in zip(a, b))
    if op == pr.BaseOp.MUL:
        return _ext_mul_int(a, b)
    return _ext_mul_int(a, _ext_inv_int(b))


def _ext_mul_int(a: tuple, b: tuple) -> tuple:
    P = ff.P
    c = [0] * 7
    for i in range(4):
        ai = a[i]
        if ai:
            for j in range(4):
                c[i + j] += ai * b[j]
    return (
        (c[0] + 3 * c[4]) % P,
        (c[1] + 3 * c[5]) % P,
        (c[2] + 3 * c[6]) % P,
        c[3] % P,
    )


def _ext_inv_int(a: tuple) -> tuple:
    """Inverse in F_p[X]/(X^4 - 3) via conjugate products.

    With the Frobenius x -> x^p acting as X -> u*X for u = 3^((p-1)/4),
    N(a) = a * a^p * a^{p^2} * a^{p^3} is in F_p, so
    a^{-1} = (conj product) / N(a).
    """
    P = ff.P
    u = _FROB_U
    # a^{p^k}: coordinate i scaled by u^(i*k)
    conj = [tuple(a[i] * pow(u, i * k, P) % P for i in range(4)) for k in (1, 2, 3)]
    prod = _ext_mul_int(conj[0], conj[1])
    prod = _ext_mul_int(prod, conj[2])
    norm = _ext_mul_int(a, prod)
    assert norm[1] == norm[2] == norm[3] == 0, "norm not in base field"
    ninv = pow(norm[0], P - 2, P)
    return tuple(x * ninv % P for x in prod)


_FROB_U = pow(3, (ff.P - 1) // 4, ff.P)


def _ext_add(a: tuple, b: tuple) -> tuple:
    return _ext_op(pr.BaseOp.ADD, a, b)


def _ext_sub(a: tuple, b: tuple) -> tuple:
    return _ext_op(pr.BaseOp.SUB, a, b)


def _ext_mul(a: tuple, b: tuple) -> tuple:
    return _ext_mul_int(a, b)


def _ext_inv(a: tuple) -> tuple:
    return _ext_inv_int(a)
