"""Shift chips: ShiftLeft (SLL) and ShiftRight (SRL/SRA/ROR).

Byte-granular shift verification (the analog of crates/core/machine/src/alu/
sll + sr, redesigned for 16-bit limb words): a shift by s splits into a
multiply by 2^(s mod 8) — verified byte-by-byte against the POW2 byte-table
entry with byte product decompositions — and a byte rotation by s div 8
selected by the two high bits of s.  Right shifts and rotations verify the
inverse relation in = q*2^s + r with r < 2^s, the range proof being a second
wrap-free shift gadget (r * 2^(32-s) < 2^32).  SRA flips input and output by
the sign (x >>a s == ~(~x >>l s)).
"""

from __future__ import annotations

import numpy as np

from ..executor.opcodes import Opcode
from ..stark.air import AirBuilder
from .gadgets import ByteSink, ColView, send_byte_op, send_u16_check, send_u8_pair
from .instr_chip import InstrAir
from .lookups import ByteOpcode

O = Opcode


class ShiftGadget:
    """out = in_bytes << s (mod 2^32), plus the discarded-high-bytes sum."""

    def __init__(self, prefix: str):
        self.p = prefix

    def cols(self) -> list[str]:
        p = self.p
        return [f"{p}_m"] + [f"{p}_lo{i}" for i in range(4)] + [f"{p}_hi{i}" for i in range(4)]

    def constrain(self, b: AirBuilder, col: ColView, in_bytes, sbits, mult):
        """Returns (out_bytes[4], wrap_sum_expr).  sbits = [s0..s4] exprs."""
        p = self.p
        m = col(f"{p}_m")
        s_low3 = sbits[0] + sbits[1] * 2 + sbits[2] * 4
        send_byte_op(b, ByteOpcode.POW2, m, s_low3, 0, mult)
        lo = [col(f"{p}_lo{i}") for i in range(4)]
        hi = [col(f"{p}_hi{i}") for i in range(4)]
        for i in range(4):
            b.when(mult).assert_eq(in_bytes[i] * m, hi[i] * 256 + lo[i])
            send_u8_pair(b, lo[i], hi[i], mult)
        # r_j = true byte j of (in * 2^(s mod 8)); k = byte rotation
        r = [lo[0], lo[1] + hi[0], lo[2] + hi[1], lo[3] + hi[2], hi[3], 0, 0, 0]
        s3, s4 = sbits[3], sbits[4]
        ksel = [(1 - s3) * (1 - s4), s3 * (1 - s4), (1 - s3) * s4, s3 * s4]
        out = []
        for j in range(4):
            e = 0
            for k in range(4):
                if j - k >= 0:
                    e = e + ksel[k] * r[j - k]
            out.append(e)
        wrap = 0
        for t in range(4, 8):
            for k in range(4):
                if 0 <= t - k <= 4 and not (isinstance(r[t - k], int) and r[t - k] == 0):
                    wrap = wrap + ksel[k] * r[t - k]
        return out, wrap

    def fill(self, t, schema, i, value: int, s: int, sink: ByteSink):
        p = self.p
        m = 1 << (s & 7)
        t[i, schema.idx(f"{p}_m")] = m
        sink.pow2(np.array([m], dtype=np.uint32), np.array([s & 7], dtype=np.uint32))
        for j in range(4):
            byte = (value >> (8 * j)) & 0xFF
            prod = byte * m
            lo, hi = prod & 0xFF, prod >> 8
            t[i, schema.idx(f"{p}_lo{j}")] = lo
            t[i, schema.idx(f"{p}_hi{j}")] = hi
            sink.u8pair(np.array([lo], dtype=np.uint32), np.array([hi], dtype=np.uint32))

    def fill_vec(self, t, schema, rows, value, s, sink: ByteSink):
        """Vectorized fill over row indices; value/s are uint32 arrays."""
        p = self.p
        s = s.astype(np.uint32)
        m = (np.uint32(1) << (s & np.uint32(7))).astype(np.uint32)
        t[rows, schema.idx(f"{p}_m")] = m
        sink.pow2(m, s & np.uint32(7))
        for j in range(4):
            byte = (value >> np.uint32(8 * j)) & np.uint32(0xFF)
            prod = byte * m
            lo, hi = prod & np.uint32(0xFF), prod >> np.uint32(8)
            t[rows, schema.idx(f"{p}_lo{j}")] = lo
            t[rows, schema.idx(f"{p}_hi{j}")] = hi
            sink.u8pair(lo, hi)


def _sbit_cols(prefix):
    return [f"{prefix}{i}" for i in range(5)]


def _decompose_shift(b, col, sels_prefix: str, c_lo, mult, suffix=""):
    """s = c mod 32 via bits; c_lo = s + 32 * rest, rest < 2^11."""
    sbits = [col(f"s{suffix}{i}") for i in range(5)]
    for s_ in sbits:
        b.assert_bool(s_)
    s = sbits[0] + sbits[1] * 2 + sbits[2] * 4 + sbits[3] * 8 + sbits[4] * 16
    rest = col(f"c_rest{suffix}")
    b.when(mult).assert_eq(c_lo, s + rest * 32)
    send_u16_check(b, rest * 32, mult)
    return sbits, s


class ShiftLeftAir(InstrAir):
    name = "ShiftLeft"
    OPCODES = [O.SLL]
    EXTRA_COLS = (
        _sbit_cols("s") + ["c_rest"] + [f"bb{i}" for i in range(4)] + ShiftGadget("g").cols()
    )

    def __init__(self):
        super().__init__()
        self.gadget = ShiftGadget("g")

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_real = col("is_real")
        a, bw, cw = col.word("a"), col.word("b"), col.word("c")
        sbits, _s = _decompose_shift(b, col, "s", cw.lo, is_real)
        bb = [col(f"bb{i}") for i in range(4)]
        b.when(is_real).assert_eq(bw.lo, bb[0] + bb[1] * 256)
        b.when(is_real).assert_eq(bw.hi, bb[2] + bb[3] * 256)
        send_u8_pair(b, bb[0], bb[1], is_real)
        send_u8_pair(b, bb[2], bb[3], is_real)
        out, _wrap = self.gadget.constrain(b, col, bb, sbits, is_real)
        b.when(is_real).assert_eq(a.lo, out[0] + out[1] * 256)
        b.when(is_real).assert_eq(a.hi, out[2] + out[3] * 256)

    def fill_vec(self, t, events, ops, sink: ByteSink) -> bool:
        s = self.schema
        rows = np.arange(t.shape[0])
        bb = t[:, s.idx("b_lo")] | (t[:, s.idx("b_hi")] << np.uint32(16))
        c = t[:, s.idx("c_lo")]
        sh = c & np.uint32(31)
        for j in range(5):
            t[:, s.idx(f"s{j}")] = (sh >> np.uint32(j)) & 1
        rest = c >> np.uint32(5)
        t[:, s.idx("c_rest")] = rest
        sink.u16(rest * 32)
        for j in range(4):
            t[:, s.idx(f"bb{j}")] = (bb >> np.uint32(8 * j)) & np.uint32(0xFF)
        sink.u8pair(bb & 0xFF, (bb >> np.uint32(8)) & 0xFF)
        sink.u8pair((bb >> np.uint32(16)) & 0xFF, bb >> np.uint32(24))
        self.gadget.fill_vec(t, s, rows, bb, sh, sink)
        return True

    def nested_of(self, record):
        ops = set(self.OPCODES)
        return [e for e in record.nested_alu_events if e.opcode in ops]


class ShiftRightAir(InstrAir):
    name = "ShiftRight"
    OPCODES = [O.SRL, O.SRA, O.ROR]
    EXTRA_COLS = (
        _sbit_cols("s") + ["c_rest", "s_zero", "s_inv", "b_h0", "b_h1", "msb_b", "f"]
        + [f"q{x}" for x in ("_lo", "_hi")] + [f"qb{i}" for i in range(4)]
        + [f"r{x}" for x in ("_lo", "_hi")] + [f"rb{i}" for i in range(4)]
        + _sbit_cols("t") + ["carry"]
        + ShiftGadget("gq").cols() + ShiftGadget("gr").cols()
    )

    def __init__(self):
        super().__init__()
        self.gq = ShiftGadget("gq")
        self.gr = ShiftGadget("gr")

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_srl, is_sra, is_ror = sels
        is_real = col("is_real")
        a, bw, cw = col.word("a"), col.word("b"), col.word("c")
        sbits, s = _decompose_shift(b, col, "s", cw.lo, is_real)
        # s == 0 flag
        sz, sinv = col("s_zero"), col("s_inv")
        b.assert_bool(sz)
        b.assert_zero(sz * s)
        b.when(is_real).assert_zero(sz + s * sinv - 1)
        # SRA sign: f = is_sra * msb(b)
        b.when(is_real).assert_eq(bw.hi, col("b_h0") + col("b_h1") * 256)
        send_u8_pair(b, col("b_h0"), col("b_h1"), is_real)
        send_byte_op(b, ByteOpcode.MSB, col("msb_b"), col("b_h1"), 0, is_real)
        f = col("f")
        b.assert_eq(f, is_sra * col("msb_b"))
        # flipped input / output (identity unless SRA with sign set)
        in_lo = bw.lo + f * (65535 - 2 * bw.lo)
        in_hi = bw.hi + f * (65535 - 2 * bw.hi)
        out_lo = a.lo + f * (65535 - 2 * a.lo)
        out_hi = a.hi + f * (65535 - 2 * a.hi)

        q, r = col.word("q"), col.word("r")
        qb = [col(f"qb{i}") for i in range(4)]
        rb = [col(f"rb{i}") for i in range(4)]
        for w_, bs in ((q, qb), (r, rb)):
            b.when(is_real).assert_eq(w_.lo, bs[0] + bs[1] * 256)
            b.when(is_real).assert_eq(w_.hi, bs[2] + bs[3] * 256)
            send_u8_pair(b, bs[0], bs[1], is_real)
            send_u8_pair(b, bs[2], bs[3], is_real)

        # gadget A: q << s (wrap-free) + r == in
        outq, wrapq = self.gq.constrain(b, col, qb, sbits, is_real)
        b.when(is_real).assert_zero(wrapq)
        v1_lo = outq[0] + outq[1] * 256
        v1_hi = outq[2] + outq[3] * 256
        carry = col("carry")
        b.assert_bool(carry)
        b.when(is_real).assert_eq(v1_lo + r.lo, in_lo + carry * 65536)
        b.when(is_real).assert_eq(v1_hi + r.hi + carry, in_hi)

        # gadget B: r << (32 - s) wrap-free  (=> r < 2^s); t bits witness 32-s
        tbits = [col(f"t{i}") for i in range(5)]
        for t_ in tbits:
            b.assert_bool(t_)
        t_val = tbits[0] + tbits[1] * 2 + tbits[2] * 4 + tbits[3] * 8 + tbits[4] * 16
        nz = is_real * (1 - sz)
        b.when(nz).assert_eq(t_val + s, 32)
        outr, wrapr = self.gr.constrain(b, col, rb, tbits, nz)
        b.when(nz).assert_zero(wrapr)
        # s == 0: r must be 0 and out == in
        b.when(is_real).when(sz).assert_zero(r.lo + r.hi)

        # result: srl/sra: out' == q ; ror: out == q + (r << 32-s)
        rs_lo = outr[0] + outr[1] * 256
        rs_hi = outr[2] + outr[3] * 256
        w = b.when(is_real)
        w.when(is_srl + is_sra).assert_eq(out_lo, q.lo)
        w.when(is_srl + is_sra).assert_eq(out_hi, q.hi)
        w.when(is_ror).assert_eq(a.lo, q.lo + rs_lo)
        w.when(is_ror).assert_eq(a.hi, q.hi + rs_hi)

    def nested_of(self, record):
        ops = set(self.OPCODES)
        return [e for e in record.nested_alu_events if e.opcode in ops]

    def fill_vec(self, t, events, ops, sink: ByteSink) -> bool:
        from ..ops import field as ff

        s = self.schema
        n = t.shape[0]
        a = t[:, s.idx("a_lo")] | (t[:, s.idx("a_hi")] << np.uint32(16))
        bb = t[:, s.idx("b_lo")] | (t[:, s.idx("b_hi")] << np.uint32(16))
        c = t[:, s.idx("c_lo")]
        sh = c & np.uint32(31)
        for j in range(5):
            t[:, s.idx(f"s{j}")] = (sh >> np.uint32(j)) & 1
        rest = c >> np.uint32(5)
        t[:, s.idx("c_rest")] = rest
        sink.u16(rest * 32)
        global _SH_INV_LUT
        if _SH_INV_LUT is None:
            _SH_INV_LUT = np.array([0] + [ff.inv_int(v) for v in range(1, 32)], dtype=np.uint32)
        zero = sh == 0
        t[:, s.idx("s_zero")] = zero
        t[:, s.idx("s_inv")] = _SH_INV_LUT[sh]
        b_hi = bb >> np.uint32(16)
        h0, h1 = b_hi & np.uint32(0xFF), b_hi >> np.uint32(8)
        t[:, s.idx("b_h0")], t[:, s.idx("b_h1")] = h0, h1
        sink.u8pair(h0, h1)
        msb = bb >> np.uint32(31)
        t[:, s.idx("msb_b")] = msb
        sink.msb(msb, h1)
        flip = (ops.array == int(O.SRA)) & (msb == 1)
        t[:, s.idx("f")] = flip
        in_v = np.where(flip, ~bb, bb)
        out_v = np.where(flip, ~a, a)
        is_ror = ops.array == int(O.ROR)
        q_v = np.where(is_ror, bb >> sh, out_v)
        shifted = ((q_v.astype(np.uint64) << sh) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        r_v = np.where(is_ror, bb & ((np.uint32(1) << sh) - np.uint32(1)), in_v - shifted)
        shifted = ((q_v.astype(np.uint64) << sh) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        t[:, s.idx("q_lo")], t[:, s.idx("q_hi")] = q_v & 0xFFFF, q_v >> np.uint32(16)
        t[:, s.idx("r_lo")], t[:, s.idx("r_hi")] = r_v & 0xFFFF, r_v >> np.uint32(16)
        for j in range(4):
            t[:, s.idx(f"qb{j}")] = (q_v >> np.uint32(8 * j)) & np.uint32(0xFF)
            t[:, s.idx(f"rb{j}")] = (r_v >> np.uint32(8 * j)) & np.uint32(0xFF)
        sink.u8pair(q_v & 0xFF, (q_v >> np.uint32(8)) & 0xFF)
        sink.u8pair((q_v >> np.uint32(16)) & 0xFF, q_v >> np.uint32(24))
        sink.u8pair(r_v & 0xFF, (r_v >> np.uint32(8)) & 0xFF)
        sink.u8pair((r_v >> np.uint32(16)) & 0xFF, r_v >> np.uint32(24))
        self.gq.fill_vec(t, s, np.arange(n), q_v, sh, sink)
        t[:, s.idx("carry")] = ((shifted & np.uint32(0xFFFF)) + (r_v & np.uint32(0xFFFF))) >= 65536
        nz = np.nonzero(~zero)[0]
        if nz.size:
            tv = (np.uint32(32) - sh[nz]).astype(np.uint32)
            for j in range(5):
                t[nz, s.idx(f"t{j}")] = (tv >> np.uint32(j)) & 1
            self.gr.fill_vec(t, s, nz, r_v[nz], tv, sink)
        return True


_SH_INV_LUT = None
