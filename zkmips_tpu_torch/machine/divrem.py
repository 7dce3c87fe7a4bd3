"""DivRem chip: DIV / DIVU / MOD / MODU verified through the Mul chip.

Analog of crates/core/machine/src/alu/divrem: the quotient identity
b == q*c + r is checked via a nested MULT/MULTU request (the 64-bit product),
a 64-bit sign-extended addition, |r| < |c| via a nested SLTU on witnessed
absolute values, and truncation sign rules (sign(r) == sign(b) or r == 0).
"""

from __future__ import annotations

import numpy as np

from ..executor.opcodes import Opcode
from ..ops import field as ff
from ..stark.air import AirBuilder, LookupKind
from .gadgets import ByteSink, ColView, send_byte_op, send_u16_check, send_u8_pair
from .instr_chip import InstrAir, NestedAluEvent
from .lookups import ByteOpcode, nested_alu_msg

O = Opcode


def _abs_cols(p):
    return [f"{p}_lo", f"{p}_hi", f"{p}_k0", f"{p}_k1"]


class DivRemAir(InstrAir):
    name = "DivRem"
    OPCODES = [O.DIV, O.DIVU, O.MOD, O.MODU]
    EXTRA_COLS = (
        ["q_lo", "q_hi", "r_lo", "r_hi", "ml_lo", "ml_hi", "mh_lo", "mh_hi", "cinv"]
        + ["b_h1b", "b_h0b", "msb_b", "r_h1b", "r_h0b", "msb_r", "c_h1b", "c_h0b", "msb_c"]
        + ["t0", "t1", "t2", "t3", "z_r", "rinv", "w1"]
        + _abs_cols("ar") + _abs_cols("ac")
    )

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_div, is_divu, is_mod, is_modu = sels
        signed = is_div + is_mod
        is_real = col("is_real")
        a, bw, cw = col.word("a"), col.word("b"), col.word("c")
        q, r = col.word("q"), col.word("r")
        ml, mh = col.word("ml"), col.word("mh")

        # c != 0 (limbs are u16 by induction, so the sum detects zero)
        b.when(is_real).assert_eq((cw.lo + cw.hi) * col("cinv"), is_real)

        # r limbs and q limbs range checked (q also byte-checked inside Mul)
        for v in (r.lo, r.hi, q.lo, q.hi):
            send_u16_check(b, v, is_real)

        # nested product: (mh:ml) = q * c  (signed MULT for DIV/MOD)
        mult_opcode = signed * int(O.MULT) + (is_divu + is_modu) * int(O.MULTU)
        b.send(
            LookupKind.Instruction,
            nested_alu_msg(mult_opcode, ml, q, cw, hi_w=mh, is_write_hi=1),
            is_real,
        )

        # sign bits of b, c, r
        for w_, p in ((bw, "b"), (cw, "c"), (r, "r")):
            b.when(is_real).assert_eq(w_.hi, col(f"{p}_h0b") + col(f"{p}_h1b") * 256)
            send_u8_pair(b, col(f"{p}_h0b"), col(f"{p}_h1b"), is_real)
            send_byte_op(b, ByteOpcode.MSB, col(f"msb_{p}"), col(f"{p}_h1b"), 0, is_real)
        sm_b = signed * col("msb_b")
        sm_r = signed * col("msb_r")

        # 64-bit identity: (mh:ml) + sext(r) == sext(b)
        t0, t1, t2, t3 = col("t0"), col("t1"), col("t2"), col("t3")
        for t_ in (t0, t1, t2, t3):
            b.assert_bool(t_)
        b.when(is_real).assert_eq(ml.lo + r.lo, bw.lo + t0 * 65536)
        b.when(is_real).assert_eq(ml.hi + r.hi + t0, bw.hi + t1 * 65536)
        b.when(is_real).assert_eq(mh.lo + sm_r * 65535 + t1, sm_b * 65535 + t2 * 65536)
        b.when(is_real).assert_eq(mh.hi + sm_r * 65535 + t2, sm_b * 65535 + t3 * 65536)

        # r == 0 flag + truncation sign rules
        z_r = col("z_r")
        b.assert_bool(z_r)
        b.assert_zero(z_r * (r.lo + r.hi))
        b.when(is_real).assert_zero(z_r + (r.lo + r.hi) * col("rinv") - 1)
        b.assert_zero(signed * col("msb_r") * (1 - col("msb_b")))
        w1 = col("w1")
        b.assert_eq(w1, col("msb_b") * (1 - col("msb_r")))
        b.assert_zero(signed * w1 * (1 - z_r))

        # |r| < |c| via witnessed absolute values + nested SLTU
        for w_, p, msb in ((r, "ar", sm_r), ((cw), "ac", signed * col("msb_c"))):
            alo, ahi = col(f"{p}_lo"), col(f"{p}_hi")
            k0, k1 = col(f"{p}_k0"), col(f"{p}_k1")
            b.assert_bool(k0)
            b.assert_bool(k1)
            # msb set: w + abs == 2^32 (or both zero); else abs == w
            b.when(msb).assert_eq(w_.lo + alo, k0 * 65536)
            b.when(msb).assert_eq(w_.hi + ahi + k0, k1 * 65536)
            nm = is_real - msb
            b.when(nm).assert_eq(alo, w_.lo)
            b.when(nm).assert_eq(ahi, w_.hi)
            send_u16_check(b, alo, is_real)
            send_u16_check(b, ahi, is_real)
        one = (1, 0)
        b.send(
            LookupKind.Instruction,
            nested_alu_msg(int(O.SLTU), one, col.word("ar"), col.word("ac")),
            is_real,
        )

        # destination: DIV/DIVU write lo=q (a) and hi=r (hiw); MOD/MODU a=r
        hiw = col.word("hiw")
        wq = is_div + is_divu
        b.when(wq).assert_eq(a.lo, q.lo)
        b.when(wq).assert_eq(a.hi, q.hi)
        b.when(wq).assert_eq(hiw.lo, r.lo)
        b.when(wq).assert_eq(hiw.hi, r.hi)
        b.when(is_mod + is_modu).assert_eq(a.lo, r.lo)
        b.when(is_mod + is_modu).assert_eq(a.hi, r.hi)

    # ------------------------------------------------------------ trace side

    def generate_dependencies(self, record, output):
        from ..executor.columnar import indices_of

        cpu = record.cpu_events
        for i in indices_of(record, (O.DIV, O.DIVU, O.MOD, O.MODU)):
            e = cpu[i]
            op = e.instruction.opcode
            bb, c = int(e.b), int(e.c)
            q, r = _qr(op, bb, c)
            signed = op in (O.DIV, O.MOD)
            full = (_s(q) * _s(c)) & 0xFFFFFFFFFFFFFFFF if signed else (q * c)
            ml, mh = full & 0xFFFFFFFF, (full >> 32) & 0xFFFFFFFF
            record.nested_alu_events.append(
                NestedAluEvent(O.MULT if signed else O.MULTU, ml, q, c, hiw=mh)
            )
            ar = _abs(r) if signed else r
            ac = _abs(c) if signed else c
            record.nested_alu_events.append(NestedAluEvent(O.SLTU, 1, ar, ac))

    def fill_op(self, t, i, e, op, sink: ByteSink):
        s = self.schema
        bb, c = int(e.b), int(e.c)
        q, r = _qr(op, bb, c)
        signed = op in (O.DIV, O.MOD)
        full = (_s(q) * _s(c)) & 0xFFFFFFFFFFFFFFFF if signed else (q * c)
        ml, mh = full & 0xFFFFFFFF, (full >> 32) & 0xFFFFFFFF
        vals = {"q": q, "r": r, "ml": ml, "mh": mh}
        for p, v in vals.items():
            t[i, s.idx(f"{p}_lo")] = v & 0xFFFF
            t[i, s.idx(f"{p}_hi")] = v >> 16
        for v in (r & 0xFFFF, r >> 16, q & 0xFFFF, q >> 16):
            sink.u16(np.array([v], dtype=np.uint32))
        t[i, s.idx("cinv")] = ff.inv_int(((c & 0xFFFF) + (c >> 16)) % ff.P)
        for p, v in (("b", bb), ("c", c), ("r", r)):
            hi = v >> 16
            t[i, s.idx(f"{p}_h0b")], t[i, s.idx(f"{p}_h1b")] = hi & 0xFF, hi >> 8
            sink.u8pair(np.array([hi & 0xFF], dtype=np.uint32), np.array([hi >> 8], dtype=np.uint32))
            t[i, s.idx(f"msb_{p}")] = v >> 31
            sink.msb(np.array([v >> 31], dtype=np.uint32), np.array([hi >> 8], dtype=np.uint32))
        sm_b = (bb >> 31) if signed else 0
        sm_r = (r >> 31) if signed else 0
        t0 = 1 if ((ml & 0xFFFF) + (r & 0xFFFF)) >= 65536 else 0
        t1 = 1 if ((ml >> 16) + (r >> 16) + t0) >= 65536 else 0
        t2 = 1 if ((mh & 0xFFFF) + sm_r * 65535 + t1) >= 65536 else 0
        t3 = 1 if ((mh >> 16) + sm_r * 65535 + t2) >= 65536 else 0
        for j, v in enumerate((t0, t1, t2, t3)):
            t[i, s.idx(f"t{j}")] = v
        z_r = int(r == 0)
        t[i, s.idx("z_r")] = z_r
        if r:
            t[i, s.idx("rinv")] = ff.inv_int(((r & 0xFFFF) + (r >> 16)) % ff.P)
        t[i, s.idx("w1")] = (bb >> 31) * (1 - (r >> 31))
        for p, v, m in (("ar", r, sm_r), ("ac", c, signed * (c >> 31))):
            av = _abs(v) if m else v
            t[i, s.idx(f"{p}_lo")] = av & 0xFFFF
            t[i, s.idx(f"{p}_hi")] = av >> 16
            sink.u16(np.array([av & 0xFFFF], dtype=np.uint32))
            sink.u16(np.array([av >> 16], dtype=np.uint32))
            if m:
                k0 = 1 if ((v & 0xFFFF) + (av & 0xFFFF)) > 0 else 0
                k1 = 1 if ((v >> 16) + (av >> 16) + k0) > 0 else 0
                t[i, s.idx(f"{p}_k0")] = k0
                t[i, s.idx(f"{p}_k1")] = k1


def _s(x):
    return x - (1 << 32) if x >> 31 else x


def _abs(x):
    return ((1 << 32) - x) & 0xFFFFFFFF if x >> 31 else x


def _qr(op, bb, c):
    if op in (O.DIVU, O.MODU):
        return bb // c, bb % c
    sb, sc = _s(bb), _s(c)
    qq = abs(sb) // abs(sc)
    if (sb < 0) != (sc < 0):
        qq = -qq
    rr = abs(sb) % abs(sc)
    if sb < 0:
        rr = -rr
    return qq & 0xFFFFFFFF, rr & 0xFFFFFFFF
