"""Misc instruction chips: MiscInstr (WSBH/SEXT/EXT/INS/TEQ/MADD family) and
MovCond (MOVZ/MOVN).

Analog of crates/core/machine/src/misc/: bit-field ops (EXT/INS) verify
through nested shift requests (the reference does the same with its SLL/SRL/
ROR event bumps, executor.rs:1500-1510); the multiply-accumulate family
verifies through nested MULT/MULTU plus a 64-bit add/sub against the
previous (HI, LO) pair carried in the dispatch message.
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
MASK32 = 0xFFFFFFFF


class MovCondAir(InstrAir):
    name = "MovCond"
    OPCODES = [O.MEQ, O.MNE]
    EXTRA_COLS = ["cz", "cinv", "mov"]

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        is_meq, is_mne = sels
        is_real = col("is_real")
        a, bw, cw, pa = col.word("a"), col.word("b"), col.word("c"), col.word("pa")
        cz, cinv = col("cz"), col("cinv")
        b.assert_bool(cz)
        b.assert_zero(cz * (cw.lo + cw.hi))
        b.when(is_real).assert_zero(cz + (cw.lo + cw.hi) * cinv - 1)
        mov = col("mov")
        b.when(is_real).assert_eq(mov, is_meq * cz + is_mne * (1 - cz))
        b.when(is_real).assert_eq(a.lo, mov * bw.lo + (1 - mov) * pa.lo)
        b.when(is_real).assert_eq(a.hi, mov * bw.hi + (1 - mov) * pa.hi)

    def fill_op(self, t, i, e, op, sink):
        s = self.schema
        c = int(e.c)
        cz = int(c == 0)
        t[i, s.idx("cz")] = cz
        if c:
            t[i, s.idx("cinv")] = ff.inv_int(((c & 0xFFFF) + (c >> 16)) % ff.P)
        t[i, s.idx("mov")] = int((c == 0) if op == O.MEQ else (c != 0))


class MiscInstrAir(InstrAir):
    name = "MiscInstrs"
    OPCODES = [O.WSBH, O.SEXT, O.EXT, O.INS, O.TEQ, O.MADD, O.MADDU, O.MSUB, O.MSUBU]
    EXTRA_COLS = (
        [f"b_b{i}" for i in range(4)]  # byte decomposition of b
        + ["msb8", "msb16", "b_h1x"]  # sign bytes for SEXT
        + ["zl", "zl_inv", "zh", "zh_inv"]  # TEQ inequality
        + ["msbd", "lsb", "sh1", "t1_lo", "t1_hi", "t2_lo", "t2_hi",
           "u1_lo", "u1_hi", "u2_lo", "u2_hi", "u2b_lo", "u2b_hi", "u3_lo", "u3_hi"]  # EXT/INS shifts
        + ["ml_lo", "ml_hi", "mh_lo", "mh_hi", "k0", "k1", "k2", "k3"]  # MADD family
    )

    def eval_op(self, b: AirBuilder, col: ColView, sels):
        (is_wsbh, is_sext, is_ext, is_ins, is_teq, is_madd, is_maddu, is_msub, is_msubu) = sels
        is_real = col("is_real")
        a, bw, cw, pa = col.word("a"), col.word("b"), col.word("c"), col.word("pa")
        hp, hiw = col.word("hp"), col.word("hiw")

        # byte decomposition of b (used by WSBH and SEXT)
        bb = [col(f"b_b{i}") for i in range(4)]
        dec = is_wsbh + is_sext
        b.when(dec).assert_eq(bw.lo, bb[0] + bb[1] * 256)
        b.when(dec).assert_eq(bw.hi, bb[2] + bb[3] * 256)
        send_u8_pair(b, bb[0], bb[1], dec)
        send_u8_pair(b, bb[2], bb[3], dec)

        # WSBH: a = [b1, b0, b3, b2] bytewise
        b.when(is_wsbh).assert_eq(a.lo, bb[1] + bb[0] * 256)
        b.when(is_wsbh).assert_eq(a.hi, bb[3] + bb[2] * 256)

        # SEXT: c = 0 -> SEB, c > 0 -> SEH (c in {0, 1} from the decoder)
        send_byte_op(b, ByteOpcode.MSB, col("msb8"), bb[0], 0, is_sext)
        send_byte_op(b, ByteOpcode.MSB, col("msb16"), bb[1], 0, is_sext)
        seb = is_sext * (1 - cw.lo)
        seh = is_sext * cw.lo
        b.when(seb).assert_eq(a.lo, bb[0] + col("msb8") * 0xFF00)
        b.when(seb).assert_eq(a.hi, col("msb8") * 0xFFFF)
        b.when(seh).assert_eq(a.lo, bw.lo)
        b.when(seh).assert_eq(a.hi, col("msb16") * 0xFFFF)

        # TEQ: a != b (trap rows never make it into the trace)
        for zname, iname, d in (("zl", "zl_inv", a.lo - bw.lo), ("zh", "zh_inv", a.hi - bw.hi)):
            z = col(zname)
            b.assert_bool(z)
            b.assert_zero(z * d)
            b.when(is_teq).assert_zero(z + d * col(iname) - 1)
        b.when(is_teq).assert_zero(col("zl") * col("zh"))

        # EXT: a = (b << (31-msbd-lsb)) >> (31-msbd); c = msbd*32 + lsb
        msbd, lsb = col("msbd"), col("lsb")
        bitfield = is_ext + is_ins
        b.when(bitfield).assert_eq(cw.lo, msbd * 32 + lsb)
        send_u8_pair(b, msbd, lsb, bitfield)
        sh1 = col("sh1")
        t1, t2 = col.word("t1"), col.word("t2")
        # EXT: sh1 = 31 - msbd - lsb >= 0 (witnessed; < 32 checked via u16)
        b.when(is_ext).assert_eq(sh1 + msbd + lsb, 31)
        send_u16_check(b, sh1 * 2048, bitfield)
        b.send(LookupKind.Instruction, nested_alu_msg(int(O.SLL), t1, bw, (sh1, 0)), is_ext)
        b.send(LookupKind.Instruction, nested_alu_msg(int(O.SRL), a, t1, (sh1 + lsb, 0)), is_ext)

        # INS (msbd here is the field's msb): with sh1 = 31 - msb,
        #   t2 = (b & mask_w) << lsb  via t1 = b << (sh1 + lsb); t2 = t1 >> sh1
        #   u3 = pa & mask_field      via u1 = pa << sh1; u2 = u1 >> sh1;
        #                                 u2b = u2 >> lsb; u3 = u2b << lsb
        #   a  = pa - u3 + t2
        u1, u2, u2b, u3 = col.word("u1"), col.word("u2"), col.word("u2b"), col.word("u3")
        b.when(is_ins).assert_eq(sh1 + msbd, 31)
        b.send(LookupKind.Instruction, nested_alu_msg(int(O.SLL), t1, bw, (sh1 + lsb, 0)), is_ins)
        b.send(LookupKind.Instruction, nested_alu_msg(int(O.SRL), t2, t1, (sh1, 0)), is_ins)
        b.send(LookupKind.Instruction, nested_alu_msg(int(O.SLL), u1, pa, (sh1, 0)), is_ins)
        b.send(LookupKind.Instruction, nested_alu_msg(int(O.SRL), u2, u1, (sh1, 0)), is_ins)
        b.send(LookupKind.Instruction, nested_alu_msg(int(O.SRL), u2b, u2, (lsb, 0)), is_ins)
        b.send(LookupKind.Instruction, nested_alu_msg(int(O.SLL), u3, u2b, (lsb, 0)), is_ins)
        b.when(is_ins).assert_eq(a.lo + u3.lo, pa.lo + t2.lo)
        b.when(is_ins).assert_eq(a.hi + u3.hi, pa.hi + t2.hi)

        # MADD/MADDU/MSUB/MSUBU: (hiw:a) = (hp:pa) +- b*c
        is_macc = is_madd + is_maddu + is_msub + is_msubu
        add_op = is_madd + is_maddu
        signed_mul = is_madd + is_msub
        ml, mh = col.word("ml"), col.word("mh")
        mult_opcode = signed_mul * int(O.MULT) + (is_maddu + is_msubu) * int(O.MULTU)
        b.send(
            LookupKind.Instruction,
            nested_alu_msg(mult_opcode, ml, bw, cw, hi_w=mh, is_write_hi=1),
            is_macc,
        )
        k0, k1, k2 = col("k0"), col("k1"), col("k2")
        b.assert_bool(k0)
        b.assert_bool(k1)
        b.assert_bool(k2)
        # add: (hp:pa) + (mh:ml) == (hiw:a) mod 2^64
        wa = b.when(add_op)
        wa.assert_eq(pa.lo + ml.lo, a.lo + k0 * 65536)
        wa.assert_eq(pa.hi + ml.hi + k0, a.hi + k1 * 65536)
        wa.assert_eq(hp.lo + mh.lo + k1, hiw.lo + k2 * 65536)
        k3 = col("k3")
        b.assert_bool(k3)
        wa.assert_eq(hp.hi + mh.hi + k2, hiw.hi + k3 * 65536)
        # sub: (hp:pa) - (mh:ml) == (hiw:a)  <=> (hiw:a) + (mh:ml) == (hp:pa)
        ws = b.when(is_msub + is_msubu)
        ws.assert_eq(a.lo + ml.lo, pa.lo + k0 * 65536)
        ws.assert_eq(a.hi + ml.hi + k0, pa.hi + k1 * 65536)
        ws.assert_eq(hiw.lo + mh.lo + k1, hp.lo + k2 * 65536)
        ws.assert_eq(hiw.hi + mh.hi + k2, hp.hi + k3 * 65536)

    def fill_op(self, t, i, e, op, sink: ByteSink):
        s = self.schema
        a, bb, c, pa = int(e.a), int(e.b), int(e.c), int(e.hi_or_prev_a or 0)
        if op in (O.WSBH, O.SEXT):
            for j in range(4):
                t[i, s.idx(f"b_b{j}")] = (bb >> (8 * j)) & 0xFF
            sink.u8pair(np.array([bb & 0xFF], dtype=np.uint32), np.array([(bb >> 8) & 0xFF], dtype=np.uint32))
            sink.u8pair(np.array([(bb >> 16) & 0xFF], dtype=np.uint32), np.array([(bb >> 24) & 0xFF], dtype=np.uint32))
        if op == O.SEXT:
            m8, m16 = (bb >> 7) & 1, (bb >> 15) & 1
            t[i, s.idx("msb8")], t[i, s.idx("msb16")] = m8, m16
            sink.msb(np.array([m8], dtype=np.uint32), np.array([bb & 0xFF], dtype=np.uint32))
            sink.msb(np.array([m16], dtype=np.uint32), np.array([(bb >> 8) & 0xFF], dtype=np.uint32))
        if op == O.TEQ:
            dl = ((a & 0xFFFF) - (bb & 0xFFFF)) % ff.P
            dh = ((a >> 16) - (bb >> 16)) % ff.P
            t[i, s.idx("zl")] = int(dl == 0)
            t[i, s.idx("zh")] = int(dh == 0)
            if dl:
                t[i, s.idx("zl_inv")] = ff.inv_int(dl)
            if dh:
                t[i, s.idx("zh_inv")] = ff.inv_int(dh)
        if op in (O.EXT, O.INS):
            msbd, lsb = c >> 5, c & 0x1F
            t[i, s.idx("msbd")], t[i, s.idx("lsb")] = msbd, lsb
            sink.u8pair(np.array([msbd], dtype=np.uint32), np.array([lsb], dtype=np.uint32))
            if op == O.EXT:
                sh1 = 31 - msbd - lsb
            else:
                sh1 = 31 - msbd
            t[i, s.idx("sh1")] = sh1
            sink.u16(np.array([sh1 * 2048], dtype=np.uint32))
            if op == O.EXT:
                t1 = (bb << sh1) & MASK32
                t[i, s.idx("t1_lo")], t[i, s.idx("t1_hi")] = t1 & 0xFFFF, t1 >> 16
            else:
                t1 = (bb << (sh1 + lsb)) & MASK32
                t2 = t1 >> sh1
                u1 = (pa << sh1) & MASK32
                u2 = u1 >> sh1
                u2b = u2 >> lsb
                u3 = (u2b << lsb) & MASK32
                for nm, v in (("t1", t1), ("t2", t2), ("u1", u1), ("u2", u2), ("u2b", u2b), ("u3", u3)):
                    t[i, s.idx(f"{nm}_lo")], t[i, s.idx(f"{nm}_hi")] = v & 0xFFFF, v >> 16
        if op in (O.MADD, O.MADDU, O.MSUB, O.MSUBU):
            hp = int(e.access.hi.prev_value) if e.access.hi is not None else 0
            hiw = int(e.access.hi.value) if e.access.hi is not None else 0
            signed = op in (O.MADD, O.MSUB)
            full = ((_s(bb) * _s(c)) & 0xFFFFFFFFFFFFFFFF) if signed else (bb * c)
            ml, mh = full & MASK32, (full >> 32) & MASK32
            t[i, s.idx("ml_lo")], t[i, s.idx("ml_hi")] = ml & 0xFFFF, ml >> 16
            t[i, s.idx("mh_lo")], t[i, s.idx("mh_hi")] = mh & 0xFFFF, mh >> 16
            if op in (O.MADD, O.MADDU):
                x, y = (pa, hp), (a, hiw)  # x + ml == y
            else:
                x, y = (a, hiw), (pa, hp)
            k0 = 1 if ((x[0] & 0xFFFF) + (ml & 0xFFFF)) >= 65536 else 0
            k1 = 1 if (((x[0] >> 16)) + (ml >> 16) + k0) >= 65536 else 0
            k2 = 1 if ((x[1] & 0xFFFF) + (mh & 0xFFFF) + k1) >= 65536 else 0
            k3 = 1 if (((x[1] >> 16)) + (mh >> 16) + k2) >= 65536 else 0
            t[i, s.idx("k0")], t[i, s.idx("k1")], t[i, s.idx("k2")] = k0, k1, k2
            t[i, s.idx("k3")] = k3

    def generate_dependencies(self, record, output):
        from ..executor.columnar import indices_of

        cpu = record.cpu_events
        for i in indices_of(record, (O.EXT, O.INS, O.MADD, O.MADDU, O.MSUB, O.MSUBU)):
            e = cpu[i]
            op = e.instruction.opcode
            a, bb, c, pa = int(e.a), int(e.b), int(e.c), int(e.hi_or_prev_a or 0)
            if op == O.EXT:
                msbd, lsb = c >> 5, c & 0x1F
                sh1 = 31 - msbd - lsb
                t1 = (bb << sh1) & MASK32
                record.nested_alu_events.append(NestedAluEvent(O.SLL, t1, bb, sh1))
                record.nested_alu_events.append(NestedAluEvent(O.SRL, a, t1, sh1 + lsb))
            elif op == O.INS:
                msb, lsb = c >> 5, c & 0x1F
                sh1 = 31 - msb
                t1 = (bb << (sh1 + lsb)) & MASK32
                t2 = t1 >> sh1
                u1 = (pa << sh1) & MASK32
                u2 = u1 >> sh1
                u2b = u2 >> lsb
                u3 = (u2b << lsb) & MASK32
                record.nested_alu_events.append(NestedAluEvent(O.SLL, t1, bb, sh1 + lsb))
                record.nested_alu_events.append(NestedAluEvent(O.SRL, t2, t1, sh1))
                record.nested_alu_events.append(NestedAluEvent(O.SLL, u1, pa, sh1))
                record.nested_alu_events.append(NestedAluEvent(O.SRL, u2, u1, sh1))
                record.nested_alu_events.append(NestedAluEvent(O.SRL, u2b, u2, lsb))
                record.nested_alu_events.append(NestedAluEvent(O.SLL, u3, u2b, lsb))
            elif op in (O.MADD, O.MADDU, O.MSUB, O.MSUBU):
                signed = op in (O.MADD, O.MSUB)
                full = ((_s(bb) * _s(c)) & 0xFFFFFFFFFFFFFFFF) if signed else (bb * c)
                ml, mh = full & MASK32, (full >> 32) & MASK32
                record.nested_alu_events.append(
                    NestedAluEvent(O.MULT if signed else O.MULTU, ml, bb, c, hiw=mh)
                )


def _s(x):
    return x - (1 << 32) if x >> 31 else x
