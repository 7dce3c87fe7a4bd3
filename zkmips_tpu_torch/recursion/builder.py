"""DSL builder: variable programs compiled to flat-memory instructions.

Single-pass analog of crates/recursion/compiler (Builder + AsmCompiler):
``Felt``/``Ext`` handles wrap static addresses; arithmetic emits ALU
instructions; read multiplicities are counted after the fact and patched
into the emitted instructions (the reference's multiplicity counting,
circuit/compiler.rs:28-210).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..ops import field as ff
from . import program as pr


@dataclass(frozen=True)
class Felt:
    addr: int


@dataclass(frozen=True)
class Ext:
    addr: int


class Builder:
    def __init__(self):
        self.instructions: list = []
        self._next_addr = 0
        self._reads: dict[int, int] = {}
        self._const_memo: dict[tuple, object] = {}

    # ------------------------------------------------------------ allocation

    def _alloc(self, cells: int) -> int:
        a = self._next_addr
        self._next_addr += cells
        return a

    def _read(self, addr: int):
        self._reads[addr] = self._reads.get(addr, 0) + 1

    # ------------------------------------------------------------- constants

    def felt(self, value: int) -> Felt:
        a = self._alloc(4)
        self.instructions.append(pr.MemConst(a, (value % ff.P, 0, 0, 0), 0))
        return Felt(a)

    def ext(self, c0: int, c1: int = 0, c2: int = 0, c3: int = 0) -> Ext:
        a = self._alloc(4)
        self.instructions.append(pr.MemConst(a, (c0 % ff.P, c1 % ff.P, c2 % ff.P, c3 % ff.P), 0))
        return Ext(a)

    def hint_felt(self) -> Felt:
        a = self._alloc(4)
        self.instructions.append(pr.Hint(a, 0))
        return Felt(a)

    def hint_ext(self) -> Ext:
        a = self._alloc(4)
        self.instructions.append(pr.Hint(a, 0))
        return Ext(a)

    # ----------------------------------------------------- memoized constants

    def const_felt(self, value: int) -> Felt:
        """Deduplicated felt constant (multiplicity counting handles reuse)."""
        key = ("f", value % ff.P)
        v = self._const_memo.get(key)
        if v is None:
            v = self.felt(value)
            self._const_memo[key] = v
        return v

    def const_ext(self, coords) -> Ext:
        key = ("e", tuple(int(c) % ff.P for c in coords))
        v = self._const_memo.get(key)
        if v is None:
            v = self.ext(*key[1])
            self._const_memo[key] = v
        return v

    # ------------------------------------------------------------ arithmetic

    def _alu(self, op, x, y):
        """Binary op; result is Ext if either operand is Ext (felt blocks are
        valid ext blocks with zero high coordinates)."""
        is_ext = isinstance(x, Ext) or isinstance(y, Ext)
        cls = pr.ExtAlu if is_ext else pr.BaseAlu
        out = self._alloc(4)
        self._read(x.addr)
        self._read(y.addr)
        self.instructions.append(cls(op, out, x.addr, y.addr, 0))
        return (Ext if is_ext else Felt)(out)

    def add(self, x, y):
        return self._alu(pr.BaseOp.ADD, x, y)

    def sub(self, x, y):
        return self._alu(pr.BaseOp.SUB, x, y)

    def mul(self, x, y):
        return self._alu(pr.BaseOp.MUL, x, y)

    def div(self, x, y):
        return self._alu(pr.BaseOp.DIV, x, y)

    def assert_eq(self, x, y):
        """Constrain x == y (base compare unless either side is Ext)."""
        is_ext = isinstance(x, Ext) or isinstance(y, Ext)
        cls = pr.ExtAlu if is_ext else pr.BaseAlu
        self._read(x.addr)
        self._read(y.addr)
        self.instructions.append(cls(pr.BaseOp.ASSERT_EQ, 0, x.addr, y.addr, 0))

    def assert_zero(self, x):
        zero = self.const_ext((0, 0, 0, 0)) if isinstance(x, Ext) else self.const_felt(0)
        self.assert_eq(x, zero)

    # ------------------------------------------------------------ primitives

    def poseidon2(self, inputs: list[Felt]) -> list[Felt]:
        assert len(inputs) == 16
        outs = [self._alloc(4) for _ in range(16)]
        for x in inputs:
            self._read(x.addr)
        self.instructions.append(
            pr.Poseidon2(tuple(outs), tuple(x.addr for x in inputs), (0,) * 16)
        )
        return [Felt(a) for a in outs]

    def select(self, bit: Felt, x: Felt, y: Felt) -> tuple[Felt, Felt]:
        """(bit ? y : x, bit ? x : y)."""
        o1, o2 = self._alloc(4), self._alloc(4)
        for v in (bit, x, y):
            self._read(v.addr)
        self.instructions.append(pr.Select(bit.addr, o1, o2, x.addr, y.addr, 0, 0))
        return Felt(o1), Felt(o2)

    def exp_reverse_bits(self, base: Felt, bits: list[Felt]) -> Felt:
        """base^(reverse_bits(bits)) as ONE ExpReverseBitsLen instruction
        (bits[0] carries the highest weight).  The dedicated chip costs one
        row per bit and enforces bit booleanity, vs 3 ALU + 1 Select rows
        for the square-and-multiply lowering (reference:
        crates/recursion/core/src/chips/exp_reverse_bits.rs)."""
        if not bits:
            return self.const_felt(1)
        self._read(base.addr)
        for bit in bits:
            self._read(bit.addr)
        out = self._alloc(4)
        self.instructions.append(
            pr.ExpReverseBitsLen(out, base.addr, tuple(b.addr for b in bits), 0)
        )
        return Felt(out)

    # ------------------------------------------------- ext <-> felt plumbing

    def felts2ext(self, felts) -> Ext:
        """Ext with coordinates (f0, f1, f2, f3): sum f_c * X^c."""
        assert len(felts) == 4
        acc = None
        for c, fv in enumerate(felts):
            if c == 0:
                term = fv
            else:
                mono = [0, 0, 0, 0]
                mono[c] = 1
                term = self.mul(self.const_ext(mono), fv)
            acc = term if acc is None else self.add(acc, term)
        return Ext(acc.addr)

    def ext_to_felts(self, value: Ext) -> list:
        """Split an ext into its 4 coordinate felts, CONSTRAINED: the hinted
        parts are recomposed and asserted equal to ``value``."""
        parts = self.ext2felts(value)
        self.assert_eq(self.felts2ext(parts), value)
        return parts

    def num2bits(self, value: Felt, num_bits: int = 31) -> list:
        """Constrained 31-bit LSB-first decomposition of a canonical felt.

        Booleanity, recomposition, and the canonical-range check (if the top
        7 bits are all one — i.e. v >= P - 1 = 0b1111111 << 24 — the low 24
        bits must all be zero) are asserted, so the decomposition is unique.
        Returns the low ``num_bits`` bits.
        """
        bits = self.hint_bits(value, 31)
        for bit in bits:
            self.assert_eq(self.mul(bit, bit), bit)
        acc = None
        for k, bit in enumerate(bits):
            term = bit if k == 0 else self.mul(bit, self.const_felt(1 << k))
            acc = term if acc is None else self.add(acc, term)
        self.assert_eq(acc, value)
        prod = bits[24]
        for k in range(25, 31):
            prod = self.mul(prod, bits[k])
        low = bits[0]
        for k in range(1, 24):
            low = self.add(low, bits[k])
        self.assert_zero(self.mul(prod, low))
        return bits[:num_bits]

    def commit_public_values(self, felts: list[Felt]):
        for x in felts:
            self._read(x.addr)
        self.instructions.append(pr.CommitPublicValues(tuple(x.addr for x in felts)))

    # -------------------------------------------------------------- compile

    def hint_bits(self, value: Felt, num_bits: int) -> list:
        """Bit-decompose a felt (LSB first).  The decomposition itself is
        UNCONSTRAINED (a hint): the caller must bind it with booleanity +
        recomposition constraints against ``value``."""
        addrs = tuple(self._alloc(4) for _ in range(num_bits))
        self.instructions.append(pr.HintBits(addrs, value.addr, (0,) * num_bits))
        return [Felt(a) for a in addrs]

    def ext2felts(self, value: Ext) -> list:
        """Split an ext into 4 felts; unconstrained hint like hint_bits."""
        addrs = tuple(self._alloc(4) for _ in range(4))
        self.instructions.append(pr.HintExt2Felts(addrs, value.addr, (0, 0, 0, 0)))
        return [Felt(a) for a in addrs]

    def print_(self, v, label: str = ""):
        self.instructions.append(pr.Print(v.addr, label))

    def batch_fri(self, p_at_x: list, p_at_z: list, alpha_pow: list) -> Ext:
        """acc = sum alpha_pow[m] * (p_at_z[m] - p_at_x[m]); p_at_x are felts."""
        n = len(p_at_z)
        assert len(p_at_x) == n and len(alpha_pow) == n
        for m in range(n):
            self._read(p_at_x[m].addr)
            self._read(p_at_z[m].addr)
            self._read(alpha_pow[m].addr)
        acc = self._alloc(4)
        self.instructions.append(pr.BatchFRI(
            acc, tuple(v.addr for v in p_at_x), tuple(v.addr for v in p_at_z),
            tuple(v.addr for v in alpha_pow), 0,
        ))
        return Ext(acc)

    def fri_fold(self, x: Felt, z: Ext, alpha: Ext, mat_opening: list,
                 ps_at_z: list, alpha_pow: Ext, ro: Ext):
        """Chained FRI fold over all matrices; returns the final
        (alpha_pow, ro) handles (reference builder ExtFromBaseSlice + FriFold
        emission)."""
        n = len(ps_at_z)
        assert len(mat_opening) == n
        self._read(x.addr)
        self._read(z.addr)
        self._read(alpha.addr)
        api = [alpha_pow.addr]
        roi = [ro.addr]
        apo, roo = [], []
        for m in range(n):
            self._read(mat_opening[m].addr)
            self._read(ps_at_z[m].addr)
            self._read(api[-1])
            self._read(roi[-1])
            ao, ro_ = self._alloc(4), self._alloc(4)
            apo.append(ao)
            roo.append(ro_)
            if m + 1 < n:
                api.append(ao)
                roi.append(ro_)
        # x/z/alpha are read once per matrix row
        for _ in range(n - 1):
            self._read(x.addr)
            self._read(z.addr)
            self._read(alpha.addr)
        self.instructions.append(pr.FriFold(
            x.addr, z.addr, alpha.addr,
            tuple(v.addr for v in mat_opening), tuple(v.addr for v in ps_at_z),
            tuple(api), tuple(roi), tuple(apo), tuple(roo),
            (0,) * n, (0,) * n,
        ))
        return Ext(apo[-1]), Ext(roo[-1])

    def compile(self) -> pr.RecursionProgram:
        """Patch read multiplicities into the write instructions."""
        out = []
        for ins in self.instructions:
            if isinstance(ins, (pr.MemConst, pr.Hint)):
                out.append(replace(ins, mult=self._reads.get(ins.addr, 0)))
            elif isinstance(ins, (pr.BaseAlu, pr.ExtAlu)):
                if ins.op == pr.BaseOp.ASSERT_EQ:
                    out.append(ins)  # asserts write nothing; mult stays 0
                else:
                    out.append(replace(ins, mult=self._reads.get(ins.out, 0)))
            elif isinstance(ins, pr.Poseidon2):
                out.append(replace(ins, mults=tuple(self._reads.get(a, 0) for a in ins.out)))
            elif isinstance(ins, pr.Select):
                out.append(
                    replace(ins, mult1=self._reads.get(ins.out1, 0), mult2=self._reads.get(ins.out2, 0))
                )
            elif isinstance(ins, pr.ExpReverseBitsLen):
                out.append(replace(ins, mult=self._reads.get(ins.out, 0)))
            elif isinstance(ins, (pr.HintBits, pr.HintExt2Felts)):
                out.append(replace(
                    ins, mults=tuple(self._reads.get(a, 0) for a in ins.output_addrs)
                ))
            elif isinstance(ins, pr.BatchFRI):
                out.append(replace(ins, acc_mult=self._reads.get(ins.acc, 0)))
            elif isinstance(ins, pr.FriFold):
                out.append(replace(
                    ins,
                    alpha_pow_mults=tuple(self._reads.get(a, 0) for a in ins.alpha_pow_output),
                    ro_mults=tuple(self._reads.get(a, 0) for a in ins.ro_output),
                ))
            else:
                out.append(ins)
        return pr.RecursionProgram(out, self._next_addr)
