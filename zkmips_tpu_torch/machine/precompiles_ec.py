"""EC / bigint precompile AIR chips over the byte-limb field-op gadget.

Analog of crates/core/machine/src/syscall/precompiles/{weierstrass,edwards,
fptower,uint256.rs} with the reference's chip-per-(curve, op) layout
(mips/mod.rs:77-206): one trace row per syscall event; point/field operands
are linked limb-by-limb to the memory access records; the curve/field
formulas are enforced by chained FopSpec congruences (every intermediate is
a range-checked byte-limb value, machine/field_op.py).

Soundness domain notes (shared with the reference chips):
  * ADD has no doubling branch — the executor rejects same-x operands, and
    the AIR forces dx invertible (witnessed inverse), so a satisfying
    witness with x1 == x2 cannot exist.
  * DOUBLE forces y invertible (2-torsion points are rejected).
  * Decompress binds parity(y) to the sign argument; operand canonicity
    (value < modulus) is not enforced, matching the reference's limb-only
    range checks.
"""

from __future__ import annotations

import numpy as np

from ..executor import curves as cv
from ..executor.opcodes import SyscallCode
from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .field_op import FopSpec, _sink_u8, int_to_limbs, poly_mul, set_limbs
from .gadgets import ByteSink, ColView, Schema, eval_memory_access, populate_access, send_u16_check, send_u8_pair
from .lookups import syscall_msg
from .words import WordExpr


def _conv(a, b):
    return list(np.convolve(np.array(a, dtype=object), np.array(b, dtype=object)))


def _extra_n(p: int, k: int, n: int) -> int:
    """extra_p multiple covering n subtracted byte-limb values."""
    return n * (1 << (8 * k)) // p + 2


def _id_limbs(code) -> tuple:
    return int(code) & 0xFFFF, int(code) >> 16


def _byte_names(prefix: str, k: int) -> list:
    return [f"{prefix}{i}" for i in range(k)]


def _word_of(limbs, wi):
    """u32 word wi of a byte-limb group as a WordExpr."""
    return WordExpr(limbs[4 * wi] + 256 * limbs[4 * wi + 1],
                    limbs[4 * wi + 2] + 256 * limbs[4 * wi + 3])


class _PrecompileRowAir(BaseAir):
    """Shared one-row-per-event machinery."""

    EVENT_KEY: str = "?"

    def included(self, record) -> bool:
        return bool(record.precompile_events.get(self.EVENT_KEY))

    def num_rows(self, record) -> int:
        return len(record.precompile_events.get(self.EVENT_KEY, []))

    # -- AIR helpers ---------------------------------------------------------

    def _common(self, b: AirBuilder, col: ColView, code, arg1, arg2):
        is_real = col("is_real")
        b.assert_bool(is_real)
        shard, clk = col("shard"), col("clk")
        lo, hi = _id_limbs(code)
        b.receive(LookupKind.Syscall, syscall_msg(shard, clk, lo, hi, arg1, arg2), is_real)
        return is_real, shard, clk

    def _ptr_checks(self, b, ptrs, is_real):
        for w in ptrs:
            send_u16_check(b, w.lo, is_real)
            send_u16_check(b, (w.hi + 256) * 2, is_real)

    def _u8_groups(self, b, col, groups, is_real):
        flat = [g for grp in groups for g in grp]
        for i in range(0, len(flat), 2):
            send_u8_pair(b, flat[i], flat[i + 1] if i + 1 < len(flat) else 0, is_real)

    def _link_words(self, b, col, limbs, access_fmt, word0, nw, is_real, use_prev=True):
        """Constrain byte-limb group == memory access (prev) u16 limbs."""
        tag = "prev_" if use_prev else ""
        for wi in range(nw):
            pre = access_fmt.format(word0 + wi)
            b.when(is_real).assert_eq(col(f"{pre}_{tag}lo"), limbs[4 * wi] + 256 * limbs[4 * wi + 1])
            b.when(is_real).assert_eq(col(f"{pre}_{tag}hi"), limbs[4 * wi + 2] + 256 * limbs[4 * wi + 3])

    # -- trace helpers -------------------------------------------------------

    def _fill_common(self, t, s, row, ev, sink, ptr_fields):
        t[row, s.idx("shard")] = ev["shard"]
        t[row, s.idx("clk")] = ev["clk"]
        t[row, s.idx("is_real")] = 1
        for name, value in ptr_fields:
            t[row, s.idx(f"{name}_lo")] = value & 0xFFFF
            t[row, s.idx(f"{name}_hi")] = value >> 16
            sink.u16(np.array([value & 0xFFFF], dtype=np.uint32))
            sink.u16(np.array([((value >> 16) + 256) * 2], dtype=np.uint32))

    def _fill_bytes(self, t, s, row, prefix, value, k, sink):
        limbs = int_to_limbs(value, k)
        for i, c in enumerate(limbs):
            t[row, s.idx(f"{prefix}{i}")] = c
        _sink_u8(sink, limbs)

    def _fill_accesses(self, t, s, row, fmt, records, sink, start=0):
        for i, rec in enumerate(records):
            populate_access(
                t, s, [row], fmt.format(start + i),
                [rec.prev_shard], [rec.prev_timestamp], [rec.prev_value],
                [rec.shard], [rec.timestamp], sink,
            )


# ---------------------------------------------------------------------------
# Weierstrass add / double / decompress
# ---------------------------------------------------------------------------


class WeierstrassAddAir(_PrecompileRowAir):
    """R = P + Q (distinct x); result overwrites P (syscalls.py _ec_add)."""

    def __init__(self, curve, code):
        self.curve = curve
        self.code = code
        self.EVENT_KEY = f"{curve.name}_add"
        self.name = f"{curve.name.capitalize()}Add"
        k = curve.nwords * 4
        self.k = k
        p = curve.p
        e1 = _extra_n(p, k, 1)
        e3 = _extra_n(p, k, 3)
        self.g_dx = FopSpec("dx", k, p, [k], [k], q_count=1, extra_p=e1)
        self.g_dy = FopSpec("dy", k, p, [k], [k], q_count=1, extra_p=e1)
        self.g_nz = FopSpec("nz", k, p, [2 * k - 1], [1], extra_p=0, with_result=False)
        self.g_lm = FopSpec("lm", k, p, [2 * k - 1], [k], extra_p=e1, with_result=False)
        self.g_x3 = FopSpec("x3", k, p, [2 * k - 1], [k, k], extra_p=e3)
        self.g_u = FopSpec("u", k, p, [2 * k - 1], [], extra_p=0)
        self.g_y3 = FopSpec("y3", k, p, [2 * k - 1], [k, k], extra_p=e3)
        names = ["shard", "clk", "is_real", "pp_lo", "pp_hi", "qp_lo", "qp_hi"]
        for g in ("x1b", "y1b", "x2b", "y2b", "lam", "dxi"):
            names += _byte_names(g, k)
        for spec in (self.g_dx, self.g_dy, self.g_nz, self.g_lm, self.g_x3, self.g_u, self.g_y3):
            names += spec.names()
        s = Schema(names)
        for i in range(2 * curve.nwords):
            s.names.extend(s.access_cols(f"q{i}"))
            s.names.extend(s.access_cols(f"p{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        pp, qp = col.word("pp"), col.word("qp")
        is_real, shard, clk = self._common(b, col, self.code, pp, qp)
        self._ptr_checks(b, (pp, qp), is_real)
        k, nw = self.k, self.curve.nwords
        x1b = [col(f"x1b{i}") for i in range(k)]
        y1b = [col(f"y1b{i}") for i in range(k)]
        x2b = [col(f"x2b{i}") for i in range(k)]
        y2b = [col(f"y2b{i}") for i in range(k)]
        lam = [col(f"lam{i}") for i in range(k)]
        dxi = [col(f"dxi{i}") for i in range(k)]
        self._u8_groups(b, col, (x1b, y1b, x2b, y2b, lam, dxi), is_real)
        self._link_words(b, col, x1b, "p{}", 0, nw, is_real)
        self._link_words(b, col, y1b, "p{}", nw, nw, is_real)
        self._link_words(b, col, x2b, "q{}", 0, nw, is_real)
        self._link_words(b, col, y2b, "q{}", nw, nw, is_real)

        dx = self.g_dx.eval(b, col, [x2b], [x1b], is_real)
        dy = self.g_dy.eval(b, col, [y2b], [y1b], is_real)
        self.g_nz.eval(b, col, [poly_mul(dx, dxi)], [[1]], is_real)
        self.g_lm.eval(b, col, [poly_mul(lam, dx)], [dy], is_real)
        x3 = self.g_x3.eval(b, col, [poly_mul(lam, lam)], [x1b, x2b], is_real)
        u = self.g_u.eval(b, col, [poly_mul(lam, x3)], [], is_real)
        y3 = self.g_y3.eval(b, col, [poly_mul(lam, x1b)], [u, y1b], is_real)

        out = x3 + y3
        for i in range(2 * nw):
            prev = WordExpr(col(f"q{i}_prev_lo"), col(f"q{i}_prev_hi"))
            eval_memory_access(b, col, f"q{i}", shard, clk, qp.value_expr() + 4 * i, prev, is_real)
            eval_memory_access(b, col, f"p{i}", shard, clk + 1, pp.value_expr() + 4 * i,
                               _word_of(out, i), is_real)

    def generate_trace(self, record, output):
        events = record.precompile_events.get(self.EVENT_KEY, [])
        s, k, nw, p = self.schema, self.k, self.curve.nwords, self.curve.p
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for row, ev in enumerate(events):
            self._fill_common(t, s, row, ev, sink,
                              [("pp", ev["p_ptr"]), ("qp", ev["q_ptr"])])
            x1 = cv.words_to_int(ev["p"][:nw])
            y1 = cv.words_to_int(ev["p"][nw:])
            x2 = cv.words_to_int(ev["q"][:nw])
            y2 = cv.words_to_int(ev["q"][nw:])
            dx = (x2 - x1) % p
            dy = (y2 - y1) % p
            dxi = pow(dx, -1, p)
            lam = dy * dxi % p
            x3 = (lam * lam - x1 - x2) % p
            u = lam * x3 % p
            y3 = (lam * (x1 - x3) - y1) % p
            for pre, v in (("x1b", x1), ("y1b", y1), ("x2b", x2), ("y2b", y2),
                           ("lam", lam), ("dxi", dxi)):
                self._fill_bytes(t, s, row, pre, v, k, sink)
            l_ = lambda v: int_to_limbs(v, k)
            self.g_dx.populate(t, s, row, [l_(x2)], [l_(x1)], sink, result=dx)
            self.g_dy.populate(t, s, row, [l_(y2)], [l_(y1)], sink, result=dy)
            self.g_nz.populate(t, s, row, [_conv(l_(dx), l_(dxi))], [[1]], sink)
            self.g_lm.populate(t, s, row, [_conv(l_(lam), l_(dx))], [l_(dy)], sink)
            self.g_x3.populate(t, s, row, [_conv(l_(lam), l_(lam))], [l_(x1), l_(x2)], sink, result=x3)
            self.g_u.populate(t, s, row, [_conv(l_(lam), l_(x3))], [], sink, result=u)
            self.g_y3.populate(t, s, row, [_conv(l_(lam), l_(x1))], [l_(u), l_(y1)], sink, result=y3)
            self._fill_accesses(t, s, row, "q{}", ev["q_records"], sink)
            self._fill_accesses(t, s, row, "p{}", ev["p_records"], sink)
        return t


class WeierstrassDoubleAir(_PrecompileRowAir):
    """R = 2P in place (syscalls.py _ec_double)."""

    def __init__(self, curve, code):
        self.curve = curve
        self.code = code
        self.EVENT_KEY = f"{curve.name}_double"
        self.name = f"{curve.name.capitalize()}Double"
        k = curve.nwords * 4
        self.k = k
        p = curve.p
        e3 = _extra_n(p, k, 3)
        e4 = _extra_n(p, k, 4)
        self.g_v = FopSpec("v", k, p, [2 * k - 1], [], extra_p=0)  # v = x*x
        self.g_nz = FopSpec("nz", k, p, [2 * k - 1], [1], extra_p=0, with_result=False)
        # lam * 2y - (3v + a mod p) == 0
        self.g_lm = FopSpec("lm", k, p, [2 * k - 1], [k, k, k, k], extra_p=e4, with_result=False)
        self.g_x3 = FopSpec("x3", k, p, [2 * k - 1], [k, k], extra_p=e3)
        self.g_u = FopSpec("u", k, p, [2 * k - 1], [], extra_p=0)
        self.g_y3 = FopSpec("y3", k, p, [2 * k - 1], [k, k], extra_p=e3)
        names = ["shard", "clk", "is_real", "pp_lo", "pp_hi", "a2_lo", "a2_hi"]
        for g in ("xb", "yb", "lam", "yi"):
            names += _byte_names(g, k)
        for spec in (self.g_v, self.g_nz, self.g_lm, self.g_x3, self.g_u, self.g_y3):
            names += spec.names()
        s = Schema(names)
        for i in range(2 * curve.nwords):
            s.names.extend(s.access_cols(f"p{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        pp, a2 = col.word("pp"), col.word("a2")
        is_real, shard, clk = self._common(b, col, self.code, pp, a2)
        self._ptr_checks(b, (pp,), is_real)
        k, nw, p = self.k, self.curve.nwords, self.curve.p
        xb = [col(f"xb{i}") for i in range(k)]
        yb = [col(f"yb{i}") for i in range(k)]
        lam = [col(f"lam{i}") for i in range(k)]
        yi = [col(f"yi{i}") for i in range(k)]
        self._u8_groups(b, col, (xb, yb, lam, yi), is_real)
        self._link_words(b, col, xb, "p{}", 0, nw, is_real)
        self._link_words(b, col, yb, "p{}", nw, nw, is_real)

        v = self.g_v.eval(b, col, [poly_mul(xb, xb)], [], is_real)
        self.g_nz.eval(b, col, [poly_mul(yb, yi)], [[1]], is_real)
        a_l = int_to_limbs(self.curve.a % p, k)
        two_y = [2 * c for c in yb]
        self.g_lm.eval(b, col, [poly_mul(lam, two_y)], [v, v, v, a_l], is_real)
        x3 = self.g_x3.eval(b, col, [poly_mul(lam, lam)], [xb, xb], is_real)
        u = self.g_u.eval(b, col, [poly_mul(lam, x3)], [], is_real)
        y3 = self.g_y3.eval(b, col, [poly_mul(lam, xb)], [u, yb], is_real)

        out = x3 + y3
        for i in range(2 * nw):
            eval_memory_access(b, col, f"p{i}", shard, clk, pp.value_expr() + 4 * i,
                               _word_of(out, i), is_real)

    def generate_trace(self, record, output):
        events = record.precompile_events.get(self.EVENT_KEY, [])
        s, k, nw, p = self.schema, self.k, self.curve.nwords, self.curve.p
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for row, ev in enumerate(events):
            self._fill_common(t, s, row, ev, sink, [("pp", ev["p_ptr"])])
            a2v = ev.get("arg2", 0)
            t[row, s.idx("a2_lo")] = a2v & 0xFFFF
            t[row, s.idx("a2_hi")] = a2v >> 16
            x1 = cv.words_to_int(ev["p"][:nw])
            y1 = cv.words_to_int(ev["p"][nw:])
            v = x1 * x1 % p
            yi = pow(y1 % p, -1, p)
            lam = (3 * v + self.curve.a) * pow(2 * y1, -1, p) % p
            x3 = (lam * lam - 2 * x1) % p
            u = lam * x3 % p
            y3 = (lam * (x1 - x3) - y1) % p
            for pre, val in (("xb", x1), ("yb", y1), ("lam", lam), ("yi", yi)):
                self._fill_bytes(t, s, row, pre, val, k, sink)
            l_ = lambda vv: int_to_limbs(vv, k)
            self.g_v.populate(t, s, row, [_conv(l_(x1), l_(x1))], [], sink, result=v)
            self.g_nz.populate(t, s, row, [_conv(l_(y1), l_(yi))], [[1]], sink)
            self.g_lm.populate(
                t, s, row, [_conv(l_(lam), [2 * c for c in l_(y1)])],
                [l_(v), l_(v), l_(v), l_(self.curve.a % p)], sink,
            )
            self.g_x3.populate(t, s, row, [_conv(l_(lam), l_(lam))], [l_(x1), l_(x1)], sink, result=x3)
            self.g_u.populate(t, s, row, [_conv(l_(lam), l_(x3))], [], sink, result=u)
            self.g_y3.populate(t, s, row, [_conv(l_(lam), l_(x1))], [l_(u), l_(y1)], sink, result=y3)
            self._fill_accesses(t, s, row, "p{}", ev["p_records"], sink)
        return t


class WeierstrassDecompressAir(_PrecompileRowAir):
    """y from x + sign: y^2 = x^3 + ax + b, parity(y) == sign."""

    def __init__(self, curve, code):
        self.curve = curve
        self.code = code
        self.EVENT_KEY = f"{curve.name}_decompress"
        self.name = f"{curve.name.capitalize()}Decompress"
        k = curve.nwords * 4
        self.k = k
        p = curve.p
        e3 = _extra_n(p, k, 3)
        self.g_v = FopSpec("v", k, p, [2 * k - 1], [], extra_p=0)  # v = x*x
        self.g_w = FopSpec("w", k, p, [2 * k - 1], [], extra_p=0)  # w = v*x
        self.g_ax = FopSpec("ax", k, p, [2 * k - 1], [], extra_p=0)  # ax = a*x
        # y*y - w - ax - b == 0
        self.g_yy = FopSpec("yy", k, p, [2 * k - 1], [k, k, k], extra_p=e3, with_result=False)
        names = ["shard", "clk", "is_real", "pp_lo", "pp_hi", "sign", "half"]
        for g in ("xb", "yb"):
            names += _byte_names(g, k)
        for spec in (self.g_v, self.g_w, self.g_ax, self.g_yy):
            names += spec.names()
        s = Schema(names)
        for i in range(curve.nwords):
            s.names.extend(s.access_cols(f"x{i}"))
            s.names.extend(s.access_cols(f"y{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        pp = col.word("pp")
        sign = col("sign")
        b.assert_bool(sign)
        is_real, shard, clk = self._common(b, col, self.code, pp, (sign, 0))
        self._ptr_checks(b, (pp,), is_real)
        k, nw, p = self.k, self.curve.nwords, self.curve.p
        xb = [col(f"xb{i}") for i in range(k)]
        yb = [col(f"yb{i}") for i in range(k)]
        self._u8_groups(b, col, (xb, yb), is_real)
        self._link_words(b, col, xb, "x{}", 0, nw, is_real)

        v = self.g_v.eval(b, col, [poly_mul(xb, xb)], [], is_real)
        w = self.g_w.eval(b, col, [poly_mul(v, xb)], [], is_real)
        a_l = int_to_limbs(self.curve.a % p, k)
        ax = self.g_ax.eval(b, col, [poly_mul(a_l, xb)], [], is_real)
        b_l = int_to_limbs(self.curve.b % p, k)
        self.g_yy.eval(b, col, [poly_mul(yb, yb)], [w, ax, b_l], is_real)

        # parity(y) == sign: yb[0] = 2*half + sign (both range-bounded)
        half = col("half")
        send_u8_pair(b, half, 0, is_real)
        b.when(is_real).assert_eq(yb[0], 2 * half + sign)

        for i in range(nw):
            prev = WordExpr(col(f"x{i}_prev_lo"), col(f"x{i}_prev_hi"))
            eval_memory_access(b, col, f"x{i}", shard, clk,
                               pp.value_expr() + 4 * (nw + i), prev, is_real)
            eval_memory_access(b, col, f"y{i}", shard, clk,
                               pp.value_expr() + 4 * i, _word_of(yb, i), is_real)

    def generate_trace(self, record, output):
        events = record.precompile_events.get(self.EVENT_KEY, [])
        s, k, nw, p = self.schema, self.k, self.curve.nwords, self.curve.p
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for row, ev in enumerate(events):
            self._fill_common(t, s, row, ev, sink, [("pp", ev["ptr"])])
            t[row, s.idx("sign")] = ev["sign"]
            x = cv.words_to_int(ev["x"])
            y = cv.words_to_int([r.value for r in ev["y_records"]])
            v = x * x % p
            w = v * x % p
            ax = self.curve.a % p * x % p
            t[row, s.idx("half")] = (y & 0xFF) >> 1
            sink.u8pair(np.array([(y & 0xFF) >> 1], dtype=np.uint32),
                        np.zeros(1, dtype=np.uint32))
            for pre, val in (("xb", x), ("yb", y)):
                self._fill_bytes(t, s, row, pre, val, k, sink)
            l_ = lambda vv: int_to_limbs(vv, k)
            self.g_v.populate(t, s, row, [_conv(l_(x), l_(x))], [], sink, result=v)
            self.g_w.populate(t, s, row, [_conv(l_(v), l_(x))], [], sink, result=w)
            self.g_ax.populate(t, s, row, [_conv(l_(self.curve.a % p), l_(x))], [], sink, result=ax)
            self.g_yy.populate(t, s, row, [_conv(l_(y), l_(y))],
                               [l_(w), l_(ax), l_(self.curve.b % p)], sink)
            self._fill_accesses(t, s, row, "x{}", ev["x_records"], sink)
            self._fill_accesses(t, s, row, "y{}", ev["y_records"], sink)
        return t


# ---------------------------------------------------------------------------
# fptower: Fp add/sub/mul and Fp2 add/sub/mul (bn254, bls12381)
# ---------------------------------------------------------------------------


class FpOpAir(_PrecompileRowAir):
    """x <- x (op) y mod p, op in {add, sub, mul} (one chip per field,
    3 selector flags; reference fptower FpOpChip)."""

    def __init__(self, field: str):
        self.field = field
        p, nw = cv.FP_MOD[field]
        self.p, self.nw = p, nw
        k = nw * 4
        self.k = k
        self.name = f"{field.capitalize()}FpOp"
        self.codes = {
            "add": getattr(SyscallCode, f"{field.upper()}_FP_ADD"),
            "sub": getattr(SyscallCode, f"{field.upper()}_FP_SUB"),
            "mul": getattr(SyscallCode, f"{field.upper()}_FP_MUL"),
        }
        e1 = _extra_n(p, k, 1)
        self.g_add = FopSpec("ga", k, p, [k, k], [], q_count=1, extra_p=0)
        self.g_sub = FopSpec("gs", k, p, [k], [k], q_count=1, extra_p=e1)
        self.g_mul = FopSpec("gm", k, p, [2 * k - 1], [], extra_p=0)
        names = ["shard", "clk", "is_real", "is_add", "is_sub", "is_mul",
                 "xp_lo", "xp_hi", "yp_lo", "yp_hi"]
        for g in ("xb", "yb"):
            names += _byte_names(g, k)
        for spec in (self.g_add, self.g_sub, self.g_mul):
            names += spec.names()
        s = Schema(names)
        for i in range(nw):
            s.names.extend(s.access_cols(f"x{i}"))
            s.names.extend(s.access_cols(f"y{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def included(self, record) -> bool:
        return any(record.precompile_events.get(f"{self.field}_fp_{op}") for op in ("add", "sub", "mul"))

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        b.assert_bool(is_real)
        flags = {op: col(f"is_{op}") for op in ("add", "sub", "mul")}
        total = 0
        for f_ in flags.values():
            b.assert_bool(f_)
            total = total + f_
        b.assert_eq(total, is_real)
        shard, clk = col("shard"), col("clk")
        xp, yp = col.word("xp"), col.word("yp")
        for op, f_ in flags.items():
            lo, hi = _id_limbs(self.codes[op])
            b.receive(LookupKind.Syscall, syscall_msg(shard, clk, lo, hi, xp, yp), f_)
        self._ptr_checks(b, (xp, yp), is_real)
        k, nw = self.k, self.nw
        xb = [col(f"xb{i}") for i in range(k)]
        yb = [col(f"yb{i}") for i in range(k)]
        self._u8_groups(b, col, (xb, yb), is_real)
        self._link_words(b, col, xb, "x{}", 0, nw, is_real)
        self._link_words(b, col, yb, "y{}", 0, nw, is_real)

        ra = self.g_add.eval(b, col, [xb, yb], [], flags["add"])
        rs = self.g_sub.eval(b, col, [xb], [yb], flags["sub"])
        rm = self.g_mul.eval(b, col, [poly_mul(xb, yb)], [], flags["mul"])
        out = [flags["add"] * ra[i] + flags["sub"] * rs[i] + flags["mul"] * rm[i]
               for i in range(k)]
        for i in range(nw):
            prev = WordExpr(col(f"y{i}_prev_lo"), col(f"y{i}_prev_hi"))
            eval_memory_access(b, col, f"y{i}", shard, clk, yp.value_expr() + 4 * i, prev, is_real)
            eval_memory_access(b, col, f"x{i}", shard, clk + 1, xp.value_expr() + 4 * i,
                               _word_of(out, i), is_real)

    def generate_trace(self, record, output):
        rows = []
        for op in ("add", "sub", "mul"):
            for ev in record.precompile_events.get(f"{self.field}_fp_{op}", []):
                rows.append((op, ev))
        rows.sort(key=lambda oe: (oe[1]["shard"], oe[1]["clk"]))
        s, k, nw, p = self.schema, self.k, self.nw, self.p
        t = np.zeros((max(len(rows), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for row, (op, ev) in enumerate(rows):
            self._fill_common(t, s, row, ev, sink,
                              [("xp", ev["x_ptr"]), ("yp", ev["y_ptr"])])
            t[row, s.idx(f"is_{op}")] = 1
            a = cv.words_to_int(ev["x"])
            bb = cv.words_to_int(ev["y"])
            for pre, val in (("xb", a), ("yb", bb)):
                self._fill_bytes(t, s, row, pre, val, k, sink)
            l_ = lambda vv: int_to_limbs(vv, k)
            if op == "add":
                r = (a + bb) % p
                self.g_add.populate(t, s, row, [l_(a), l_(bb)], [], sink, result=r)
            elif op == "sub":
                r = (a - bb) % p
                self.g_sub.populate(t, s, row, [l_(a)], [l_(bb)], sink, result=r)
            else:
                r = a % p * (bb % p) % p
                self.g_mul.populate(t, s, row, [_conv(l_(a), l_(bb))], [], sink, result=r)
            self._fill_accesses(t, s, row, "y{}", ev["y_records"], sink)
            self._fill_accesses(t, s, row, "x{}", ev["x_records"], sink)
        return t


class Fp2AddSubAir(_PrecompileRowAir):
    """(x0, x1) <- (x0, x1) +/- (y0, y1) componentwise mod p."""

    def __init__(self, field: str):
        self.field = field
        p, nw = cv.FP_MOD[field]
        self.p, self.nw = p, nw
        k = nw * 4
        self.k = k
        self.name = f"{field.capitalize()}Fp2AddSub"
        self.codes = {
            "add": getattr(SyscallCode, f"{field.upper()}_FP2_ADD"),
            "sub": getattr(SyscallCode, f"{field.upper()}_FP2_SUB"),
        }
        e1 = _extra_n(p, k, 1)
        self.g = {}
        for c in (0, 1):
            self.g[("add", c)] = FopSpec(f"ga{c}", k, p, [k, k], [], q_count=1, extra_p=0)
            self.g[("sub", c)] = FopSpec(f"gs{c}", k, p, [k], [k], q_count=1, extra_p=e1)
        names = ["shard", "clk", "is_real", "is_add", "is_sub",
                 "xp_lo", "xp_hi", "yp_lo", "yp_hi"]
        for g in ("x0b", "x1b", "y0b", "y1b"):
            names += _byte_names(g, k)
        for spec in self.g.values():
            names += spec.names()
        s = Schema(names)
        for i in range(2 * nw):
            s.names.extend(s.access_cols(f"x{i}"))
            s.names.extend(s.access_cols(f"y{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def included(self, record) -> bool:
        return any(record.precompile_events.get(f"{self.field}_fp2_{op}") for op in ("add", "sub"))

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        b.assert_bool(is_real)
        fa, fs = col("is_add"), col("is_sub")
        b.assert_bool(fa)
        b.assert_bool(fs)
        b.assert_eq(fa + fs, is_real)
        shard, clk = col("shard"), col("clk")
        xp, yp = col.word("xp"), col.word("yp")
        for op, f_ in (("add", fa), ("sub", fs)):
            lo, hi = _id_limbs(self.codes[op])
            b.receive(LookupKind.Syscall, syscall_msg(shard, clk, lo, hi, xp, yp), f_)
        self._ptr_checks(b, (xp, yp), is_real)
        k, nw = self.k, self.nw
        groups = {g: [col(f"{g}{i}") for i in range(k)] for g in ("x0b", "x1b", "y0b", "y1b")}
        self._u8_groups(b, col, tuple(groups.values()), is_real)
        self._link_words(b, col, groups["x0b"], "x{}", 0, nw, is_real)
        self._link_words(b, col, groups["x1b"], "x{}", nw, nw, is_real)
        self._link_words(b, col, groups["y0b"], "y{}", 0, nw, is_real)
        self._link_words(b, col, groups["y1b"], "y{}", nw, nw, is_real)
        outs = []
        for c in (0, 1):
            ra = self.g[("add", c)].eval(b, col, [groups[f"x{c}b"], groups[f"y{c}b"]], [], fa)
            rs = self.g[("sub", c)].eval(b, col, [groups[f"x{c}b"]], [groups[f"y{c}b"]], fs)
            outs.append([fa * ra[i] + fs * rs[i] for i in range(k)])
        out = outs[0] + outs[1]
        for i in range(2 * nw):
            prev = WordExpr(col(f"y{i}_prev_lo"), col(f"y{i}_prev_hi"))
            eval_memory_access(b, col, f"y{i}", shard, clk, yp.value_expr() + 4 * i, prev, is_real)
            eval_memory_access(b, col, f"x{i}", shard, clk + 1, xp.value_expr() + 4 * i,
                               _word_of(out, i), is_real)

    def generate_trace(self, record, output):
        rows = []
        for op in ("add", "sub"):
            for ev in record.precompile_events.get(f"{self.field}_fp2_{op}", []):
                rows.append((op, ev))
        rows.sort(key=lambda oe: (oe[1]["shard"], oe[1]["clk"]))
        s, k, nw, p = self.schema, self.k, self.nw, self.p
        t = np.zeros((max(len(rows), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for row, (op, ev) in enumerate(rows):
            self._fill_common(t, s, row, ev, sink,
                              [("xp", ev["x_ptr"]), ("yp", ev["y_ptr"])])
            t[row, s.idx(f"is_{op}")] = 1
            a0 = cv.words_to_int(ev["x"][:self.nw])
            a1 = cv.words_to_int(ev["x"][self.nw:])
            b0 = cv.words_to_int(ev["y"][:self.nw])
            b1 = cv.words_to_int(ev["y"][self.nw:])
            for pre, val in (("x0b", a0), ("x1b", a1), ("y0b", b0), ("y1b", b1)):
                self._fill_bytes(t, s, row, pre, val, k, sink)
            l_ = lambda vv: int_to_limbs(vv, k)
            for c, (av, bv) in ((0, (a0, b0)), (1, (a1, b1))):
                if op == "add":
                    self.g[("add", c)].populate(t, s, row, [l_(av), l_(bv)], [], sink,
                                                result=(av + bv) % p)
                else:
                    self.g[("sub", c)].populate(t, s, row, [l_(av)], [l_(bv)], sink,
                                                result=(av - bv) % p)
            self._fill_accesses(t, s, row, "y{}", ev["y_records"], sink)
            self._fill_accesses(t, s, row, "x{}", ev["x_records"], sink)
        return t


class Fp2MulAir(_PrecompileRowAir):
    """(x0 + x1 u)(y0 + y1 u) with u^2 = -1 (reference fptower Fp2Mul)."""

    def __init__(self, field: str):
        self.field = field
        p, nw = cv.FP_MOD[field]
        self.p, self.nw = p, nw
        k = nw * 4
        self.k = k
        self.name = f"{field.capitalize()}Fp2Mul"
        self.code = getattr(SyscallCode, f"{field.upper()}_FP2_MUL")
        self.EVENT_KEY = f"{field}_fp2_mul"
        e2 = _extra_n(p, k, 2)
        self.g_m1 = FopSpec("m1", k, p, [2 * k - 1], [], extra_p=0)  # x0*y0
        self.g_m2 = FopSpec("m2", k, p, [2 * k - 1], [], extra_p=0)  # x1*y1
        self.g_m3 = FopSpec("m3", k, p, [2 * k - 1], [], extra_p=0)  # x0*y1
        self.g_m4 = FopSpec("m4", k, p, [2 * k - 1], [], extra_p=0)  # x1*y0
        self.g_r0 = FopSpec("r0", k, p, [k], [k], q_count=1, extra_p=e2)  # m1 - m2
        self.g_r1 = FopSpec("r1", k, p, [k, k], [], q_count=1, extra_p=0)  # m3 + m4
        names = ["shard", "clk", "is_real", "xp_lo", "xp_hi", "yp_lo", "yp_hi"]
        for g in ("x0b", "x1b", "y0b", "y1b"):
            names += _byte_names(g, k)
        for spec in (self.g_m1, self.g_m2, self.g_m3, self.g_m4, self.g_r0, self.g_r1):
            names += spec.names()
        s = Schema(names)
        for i in range(2 * nw):
            s.names.extend(s.access_cols(f"x{i}"))
            s.names.extend(s.access_cols(f"y{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        xp, yp = col.word("xp"), col.word("yp")
        is_real, shard, clk = self._common(b, col, self.code, xp, yp)
        self._ptr_checks(b, (xp, yp), is_real)
        k, nw = self.k, self.nw
        groups = {g: [col(f"{g}{i}") for i in range(k)] for g in ("x0b", "x1b", "y0b", "y1b")}
        self._u8_groups(b, col, tuple(groups.values()), is_real)
        self._link_words(b, col, groups["x0b"], "x{}", 0, nw, is_real)
        self._link_words(b, col, groups["x1b"], "x{}", nw, nw, is_real)
        self._link_words(b, col, groups["y0b"], "y{}", 0, nw, is_real)
        self._link_words(b, col, groups["y1b"], "y{}", nw, nw, is_real)
        m1 = self.g_m1.eval(b, col, [poly_mul(groups["x0b"], groups["y0b"])], [], is_real)
        m2 = self.g_m2.eval(b, col, [poly_mul(groups["x1b"], groups["y1b"])], [], is_real)
        m3 = self.g_m3.eval(b, col, [poly_mul(groups["x0b"], groups["y1b"])], [], is_real)
        m4 = self.g_m4.eval(b, col, [poly_mul(groups["x1b"], groups["y0b"])], [], is_real)
        r0 = self.g_r0.eval(b, col, [m1], [m2], is_real)
        r1 = self.g_r1.eval(b, col, [m3, m4], [], is_real)
        out = r0 + r1
        for i in range(2 * nw):
            prev = WordExpr(col(f"y{i}_prev_lo"), col(f"y{i}_prev_hi"))
            eval_memory_access(b, col, f"y{i}", shard, clk, yp.value_expr() + 4 * i, prev, is_real)
            eval_memory_access(b, col, f"x{i}", shard, clk + 1, xp.value_expr() + 4 * i,
                               _word_of(out, i), is_real)

    def generate_trace(self, record, output):
        events = record.precompile_events.get(self.EVENT_KEY, [])
        s, k, nw, p = self.schema, self.k, self.nw, self.p
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for row, ev in enumerate(events):
            self._fill_common(t, s, row, ev, sink,
                              [("xp", ev["x_ptr"]), ("yp", ev["y_ptr"])])
            a0 = cv.words_to_int(ev["x"][:nw]) % p
            a1 = cv.words_to_int(ev["x"][nw:]) % p
            b0 = cv.words_to_int(ev["y"][:nw]) % p
            b1 = cv.words_to_int(ev["y"][nw:]) % p
            # raw (pre-reduction) operand bytes must match memory
            ra0 = cv.words_to_int(ev["x"][:nw])
            ra1 = cv.words_to_int(ev["x"][nw:])
            rb0 = cv.words_to_int(ev["y"][:nw])
            rb1 = cv.words_to_int(ev["y"][nw:])
            for pre, val in (("x0b", ra0), ("x1b", ra1), ("y0b", rb0), ("y1b", rb1)):
                self._fill_bytes(t, s, row, pre, val, k, sink)
            m1, m2 = ra0 * rb0 % p, ra1 * rb1 % p
            m3, m4 = ra0 * rb1 % p, ra1 * rb0 % p
            l_ = lambda vv: int_to_limbs(vv, k)
            self.g_m1.populate(t, s, row, [_conv(l_(ra0), l_(rb0))], [], sink, result=m1)
            self.g_m2.populate(t, s, row, [_conv(l_(ra1), l_(rb1))], [], sink, result=m2)
            self.g_m3.populate(t, s, row, [_conv(l_(ra0), l_(rb1))], [], sink, result=m3)
            self.g_m4.populate(t, s, row, [_conv(l_(ra1), l_(rb0))], [], sink, result=m4)
            self.g_r0.populate(t, s, row, [l_(m1)], [l_(m2)], sink, result=(m1 - m2) % p)
            self.g_r1.populate(t, s, row, [l_(m3), l_(m4)], [], sink, result=(m3 + m4) % p)
            self._fill_accesses(t, s, row, "y{}", ev["y_records"], sink)
            self._fill_accesses(t, s, row, "x{}", ev["x_records"], sink)
        return t


# ---------------------------------------------------------------------------
# uint256 mul (variable modulus)
# ---------------------------------------------------------------------------


class VarModFopSpec:
    """FopSpec variant with a *variable* modulus limb-polynomial M (byte
    limbs plus one virtual top limb for modulus==0 -> 2^256):
    E = POS - R - Q*M = (x - 256) * W."""

    def __init__(self, prefix, k, m_len, pos_shapes, q_count):
        self.prefix, self.k, self.m_len, self.q_count = prefix, k, m_len, q_count
        self.deg_e = max(list(pos_shapes) + [k, q_count + m_len - 1]) - 1

    def names(self):
        p = self.prefix
        return ([f"{p}_r{i}" for i in range(self.k)]
                + [f"{p}_q{i}" for i in range(self.q_count)]
                + [f"{p}_wl{i}" for i in range(self.deg_e)]
                + [f"{p}_wh{i}" for i in range(self.deg_e)])

    def eval(self, builder, col, pos_terms, m_limbs, mult):
        from .field_op import BETA, W_OFFSET, poly_addl

        pf = self.prefix
        r = [col(f"{pf}_r{i}") for i in range(self.k)]
        q = [col(f"{pf}_q{i}") for i in range(self.q_count)]
        qm = poly_mul(q, m_limbs)
        pos_poly = poly_addl(*pos_terms)
        neg_poly = poly_addl(r, qm)
        n = self.deg_e + 1
        e = [0] * n
        for i, c in enumerate(pos_poly):
            e[i] = c
        for i, c in enumerate(neg_poly):
            if not (isinstance(c, int) and c == 0):
                e[i] = e[i] - c
        w = []
        for t in range(self.deg_e):
            wl, wh = col(f"{pf}_wl{t}"), col(f"{pf}_wh{t}")
            builder.assert_bool(wh)
            w.append(wl + wh * 65536 - W_OFFSET)
            send_u16_check(builder, wl, mult)
        for t in range(n):
            rhs = 0
            if t - 1 >= 0:
                rhs = w[t - 1]
            if t < self.deg_e:
                rhs = rhs - BETA * w[t]
            builder.when(mult).assert_eq(e[t], rhs)
        for i in range(0, self.k, 2):
            send_u8_pair(builder, r[i], r[i + 1] if i + 1 < self.k else 0, mult)
        for i in range(0, self.q_count, 2):
            send_u8_pair(builder, q[i], q[i + 1] if i + 1 < self.q_count else 0, mult)
        return r

    def populate(self, trace, s, row, pos_ints, m_int, m_limb_ints, sink, result):
        from .field_op import BETA, W_OFFSET, limbs_to_int

        pf = self.prefix
        r_l = int_to_limbs(result, self.k)
        for i, c in enumerate(r_l):
            trace[row, s.idx(f"{pf}_r{i}")] = c
        _sink_u8(sink, r_l)
        pos_val = sum(sum(int(c) << (8 * i) for i, c in enumerate(t)) for t in pos_ints)
        total = pos_val - result
        assert total % m_int == 0 and total >= 0
        qv = total // m_int
        q_l = int_to_limbs(qv, self.q_count)
        assert limbs_to_int(q_l) == qv, "quotient exceeds limb budget"
        for i, c in enumerate(q_l):
            trace[row, s.idx(f"{pf}_q{i}")] = c
        _sink_u8(sink, q_l)
        coeffs = [0] * (self.deg_e + 1)
        for t in pos_ints:
            for i, c in enumerate(t):
                coeffs[i] += int(c)
        for i, c in enumerate(r_l):
            coeffs[i] -= c
        for i, c in enumerate(_conv(q_l, m_limb_ints)):
            coeffs[i] -= int(c)
        w = [0] * self.deg_e
        carry = 0
        for t in range(self.deg_e, 0, -1):
            carry = coeffs[t] + BETA * carry
            w[t - 1] = carry
        assert coeffs[0] == (-BETA * w[0] if self.deg_e else 0)
        wl_list = []
        for t, wt in enumerate(w):
            enc = wt + W_OFFSET
            assert 0 <= enc < (1 << 17), f"carry limb out of range: {wt}"
            trace[row, s.idx(f"{pf}_wl{t}")] = enc & 0xFFFF
            trace[row, s.idx(f"{pf}_wh{t}")] = enc >> 16
            wl_list.append(enc & 0xFFFF)
        if wl_list:
            sink.u16(np.asarray(wl_list, dtype=np.uint32))


class Uint256MulAir(_PrecompileRowAir):
    """x <- x*y mod m, m read at y_ptr+32, m==0 meaning 2^256
    (reference syscall/precompiles/uint256.rs)."""

    name = "Uint256Mul"
    EVENT_KEY = "uint256_mul"

    def __init__(self):
        self.k = 32
        self.code = SyscallCode.UINT256_MUL
        self.g = VarModFopSpec("gm", 32, 33, [63], q_count=64)
        names = ["shard", "clk", "is_real", "xp_lo", "xp_hi", "yp_lo", "yp_hi",
                 "m_zero", "m_sinv"]
        for g in ("xb", "yb", "mb"):
            names += _byte_names(g, 32)
        names += self.g.names()
        s = Schema(names)
        for i in range(8):
            s.names.extend(s.access_cols(f"x{i}"))
            s.names.extend(s.access_cols(f"y{i}"))
            s.names.extend(s.access_cols(f"m{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        xp, yp = col.word("xp"), col.word("yp")
        is_real, shard, clk = self._common(b, col, self.code, xp, yp)
        self._ptr_checks(b, (xp, yp), is_real)
        xb = [col(f"xb{i}") for i in range(32)]
        yb = [col(f"yb{i}") for i in range(32)]
        mb = [col(f"mb{i}") for i in range(32)]
        self._u8_groups(b, col, (xb, yb, mb), is_real)
        self._link_words(b, col, xb, "x{}", 0, 8, is_real)
        self._link_words(b, col, yb, "y{}", 0, 8, is_real)
        self._link_words(b, col, mb, "m{}", 0, 8, is_real)
        m_zero, s_inv = col("m_zero"), col("m_sinv")
        b.assert_bool(m_zero)
        msum = mb[0]
        for c in mb[1:]:
            msum = msum + c
        b.when(is_real).assert_zero(m_zero * msum)
        b.when(is_real).assert_eq(msum * s_inv, 1 - m_zero)
        m_limbs = list(mb) + [m_zero]
        r = self.g.eval(b, col, [poly_mul(xb, yb)], m_limbs, is_real)
        for i in range(8):
            py = WordExpr(col(f"y{i}_prev_lo"), col(f"y{i}_prev_hi"))
            eval_memory_access(b, col, f"y{i}", shard, clk, yp.value_expr() + 4 * i, py, is_real)
            pm = WordExpr(col(f"m{i}_prev_lo"), col(f"m{i}_prev_hi"))
            eval_memory_access(b, col, f"m{i}", shard, clk, yp.value_expr() + 32 + 4 * i, pm, is_real)
            eval_memory_access(b, col, f"x{i}", shard, clk + 1, xp.value_expr() + 4 * i,
                               _word_of(r, i), is_real)

    def generate_trace(self, record, output):
        events = record.precompile_events.get(self.EVENT_KEY, [])
        s = self.schema
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        from ..ops import field as ff

        for row, ev in enumerate(events):
            self._fill_common(t, s, row, ev, sink,
                              [("xp", ev["x_ptr"]), ("yp", ev["y_ptr"])])
            x = cv.words_to_int(ev["x"])
            y = cv.words_to_int(ev["y"])
            mw = cv.words_to_int(ev["modulus"])
            m = mw or (1 << 256)
            r = x * y % m
            for pre, val in (("xb", x), ("yb", y), ("mb", mw)):
                self._fill_bytes(t, s, row, pre, val, 32, sink)
            msum = sum(int_to_limbs(mw, 32))
            if msum == 0:
                t[row, s.idx("m_zero")] = 1
            else:
                t[row, s.idx("m_sinv")] = ff.inv_int(msum)
            l_ = lambda vv: int_to_limbs(vv, 32)
            m_limb_ints = l_(mw) + [1 if msum == 0 else 0]
            self.g.populate(t, s, row, [_conv(l_(x), l_(y))], m, m_limb_ints, sink, result=r)
            self._fill_accesses(t, s, row, "y{}", ev["y_records"], sink)
            self._fill_accesses(t, s, row, "m{}", ev["modulus_records"], sink)
            self._fill_accesses(t, s, row, "x{}", ev["x_records"], sink)
        return t


class U256x2048MulAir(_PrecompileRowAir):
    """(hi, lo) = a (256-bit) * b (2048-bit); lo/hi pointers come from the
    a2/a3 registers (reference syscall/precompiles/u256x2048_mul.rs).

    The full-width product identity a*b == hi*2^2048 + lo is one FopSpec
    congruence with modulus 2^2048: lo is the gadget's range-checked result
    and hi its 32-limb quotient."""

    name = "U256x2048Mul"
    EVENT_KEY = "u256x2048_mul"

    def __init__(self):
        self.code = SyscallCode.U256XU2048_MUL
        self.g = FopSpec("m", 256, 1 << 2048, [32 + 256 - 1], [], q_count=32, extra_p=0)
        names = ["shard", "clk", "is_real", "ap_lo", "ap_hi", "bp_lo", "bp_hi"]
        names += _byte_names("ab", 32) + _byte_names("bb", 256)
        names += self.g.names()
        s = Schema(names)
        s.names.extend(s.access_cols("lp"))
        s.names.extend(s.access_cols("hp"))
        for i in range(8):
            s.names.extend(s.access_cols(f"a{i}"))
        for i in range(64):
            s.names.extend(s.access_cols(f"b{i}"))
        for i in range(64):
            s.names.extend(s.access_cols(f"l{i}"))
        for i in range(8):
            s.names.extend(s.access_cols(f"h{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        from ..executor.opcodes import Register

        col = ColView(b, self.schema)
        ap, bp = col.word("ap"), col.word("bp")
        is_real, shard, clk = self._common(b, col, self.code, ap, bp)
        lp = WordExpr(col("lp_prev_lo"), col("lp_prev_hi"))
        hp = WordExpr(col("hp_prev_lo"), col("hp_prev_hi"))
        self._ptr_checks(b, (ap, bp, lp, hp), is_real)
        ab = [col(f"ab{i}") for i in range(32)]
        bb = [col(f"bb{i}") for i in range(256)]
        self._u8_groups(b, col, (ab, bb), is_real)
        self._link_words(b, col, ab, "a{}", 0, 8, is_real)
        self._link_words(b, col, bb, "b{}", 0, 64, is_real)

        # register reads for the output pointers (value == prev)
        eval_memory_access(b, col, "lp", shard, clk, int(Register.A2), lp, is_real)
        eval_memory_access(b, col, "hp", shard, clk, int(Register.A3), hp, is_real)

        lo = self.g.eval(b, col, [poly_mul(ab, bb)], [], is_real)
        hi = [col(f"m_q{i}") for i in range(32)]  # the gadget's quotient IS hi
        for i in range(8):
            prev = WordExpr(col(f"a{i}_prev_lo"), col(f"a{i}_prev_hi"))
            eval_memory_access(b, col, f"a{i}", shard, clk, ap.value_expr() + 4 * i, prev, is_real)
        for i in range(64):
            prev = WordExpr(col(f"b{i}_prev_lo"), col(f"b{i}_prev_hi"))
            eval_memory_access(b, col, f"b{i}", shard, clk, bp.value_expr() + 4 * i, prev, is_real)
        for i in range(64):
            eval_memory_access(b, col, f"l{i}", shard, clk + 1, lp.value_expr() + 4 * i,
                               _word_of(lo, i), is_real)
        for i in range(8):
            eval_memory_access(b, col, f"h{i}", shard, clk + 1, hp.value_expr() + 4 * i,
                               _word_of(hi, i), is_real)

    def generate_trace(self, record, output):
        events = record.precompile_events.get(self.EVENT_KEY, [])
        s = self.schema
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for row, ev in enumerate(events):
            self._fill_common(t, s, row, ev, sink,
                              [("ap", ev["a_ptr"]), ("bp", ev["b_ptr"])])
            for name, rec, ptr in (("lp", ev["lo_ptr_record"], ev["lo_ptr"]),
                                   ("hp", ev["hi_ptr_record"], ev["hi_ptr"])):
                populate_access(t, s, [row], name, [rec.prev_shard], [rec.prev_timestamp],
                                [rec.prev_value], [rec.shard], [rec.timestamp], sink)
                sink.u16(np.array([ptr & 0xFFFF], dtype=np.uint32))
                sink.u16(np.array([((ptr >> 16) + 256) * 2], dtype=np.uint32))
            a = cv.words_to_int(ev["a"])
            bb_ = cv.words_to_int(ev["b"])
            self._fill_bytes(t, s, row, "ab", a, 32, sink)
            self._fill_bytes(t, s, row, "bb", bb_, 256, sink)
            lo = a * bb_ % (1 << 2048)
            self.g.populate(t, s, row, [_conv(int_to_limbs(a, 32), int_to_limbs(bb_, 256))],
                            [], sink, result=lo)
            self._fill_accesses(t, s, row, "a{}", ev["a_records"], sink)
            self._fill_accesses(t, s, row, "b{}", ev["b_records"], sink)
            self._fill_accesses(t, s, row, "l{}", ev["lo_records"], sink)
            self._fill_accesses(t, s, row, "h{}", ev["hi_records"], sink)
        return t


# ---------------------------------------------------------------------------
# ed25519: twisted Edwards add + decompress
# ---------------------------------------------------------------------------


class EdAddAir(_PrecompileRowAir):
    """(x3, y3) = P + Q on -x^2 + y^2 = 1 + d x^2 y^2 (complete formulas;
    reference syscall/precompiles/edwards)."""

    name = "EdAdd"
    EVENT_KEY = "ed_add"

    def __init__(self):
        k = 32
        self.k = k
        p = cv.ED_P
        self.code = SyscallCode.ED_ADD
        e2 = _extra_n(p, k, 2)
        e3 = _extra_n(p, k, 3)
        self.g_f = FopSpec("f", k, p, [2 * k - 1], [], extra_p=0)   # x1*y2
        self.g_g = FopSpec("g", k, p, [2 * k - 1], [], extra_p=0)   # x2*y1
        self.g_h = FopSpec("h", k, p, [2 * k - 1], [], extra_p=0)   # x1*x2
        self.g_i = FopSpec("i", k, p, [2 * k - 1], [], extra_p=0)   # y1*y2
        self.g_j = FopSpec("j", k, p, [2 * k - 1], [], extra_p=0)   # h*i
        self.g_dj = FopSpec("dj", k, p, [2 * k - 1], [], extra_p=0)  # d*j
        self.g_x3 = FopSpec("gx", k, p, [k, 2 * k - 1], [k, k], extra_p=e2, with_result=False)
        self.g_m = FopSpec("m", k, p, [2 * k - 1], [], extra_p=0)   # y3*dj
        self.g_y3 = FopSpec("gy", k, p, [k], [k, k, k], extra_p=e3, with_result=False)
        names = ["shard", "clk", "is_real", "pp_lo", "pp_hi", "qp_lo", "qp_hi"]
        for g in ("x1b", "y1b", "x2b", "y2b", "x3b", "y3b"):
            names += _byte_names(g, k)
        for spec in (self.g_f, self.g_g, self.g_h, self.g_i, self.g_j,
                     self.g_dj, self.g_x3, self.g_m, self.g_y3):
            names += spec.names()
        s = Schema(names)
        for i in range(16):
            s.names.extend(s.access_cols(f"q{i}"))
            s.names.extend(s.access_cols(f"p{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        pp, qp = col.word("pp"), col.word("qp")
        is_real, shard, clk = self._common(b, col, self.code, pp, qp)
        self._ptr_checks(b, (pp, qp), is_real)
        k = self.k
        grp = {g: [col(f"{g}{i}") for i in range(k)]
               for g in ("x1b", "y1b", "x2b", "y2b", "x3b", "y3b")}
        self._u8_groups(b, col, tuple(grp.values()), is_real)
        self._link_words(b, col, grp["x1b"], "p{}", 0, 8, is_real)
        self._link_words(b, col, grp["y1b"], "p{}", 8, 8, is_real)
        self._link_words(b, col, grp["x2b"], "q{}", 0, 8, is_real)
        self._link_words(b, col, grp["y2b"], "q{}", 8, 8, is_real)

        f = self.g_f.eval(b, col, [poly_mul(grp["x1b"], grp["y2b"])], [], is_real)
        g = self.g_g.eval(b, col, [poly_mul(grp["x2b"], grp["y1b"])], [], is_real)
        h = self.g_h.eval(b, col, [poly_mul(grp["x1b"], grp["x2b"])], [], is_real)
        i_ = self.g_i.eval(b, col, [poly_mul(grp["y1b"], grp["y2b"])], [], is_real)
        j = self.g_j.eval(b, col, [poly_mul(h, i_)], [], is_real)
        d_l = int_to_limbs(cv.ED_D, self.k)
        dj = self.g_dj.eval(b, col, [poly_mul(d_l, j)], [], is_real)
        # x3 * (1 + dj) == f + g
        self.g_x3.eval(b, col, [grp["x3b"], poly_mul(grp["x3b"], dj)], [f, g], is_real)
        # y3 * (1 - dj) == h + i  <=>  y3 - m - h - i == 0, m = y3*dj
        m = self.g_m.eval(b, col, [poly_mul(grp["y3b"], dj)], [], is_real)
        self.g_y3.eval(b, col, [grp["y3b"]], [m, h, i_], is_real)

        out = grp["x3b"] + grp["y3b"]
        for i in range(16):
            prev = WordExpr(col(f"q{i}_prev_lo"), col(f"q{i}_prev_hi"))
            eval_memory_access(b, col, f"q{i}", shard, clk, qp.value_expr() + 4 * i, prev, is_real)
            eval_memory_access(b, col, f"p{i}", shard, clk + 1, pp.value_expr() + 4 * i,
                               _word_of(out, i), is_real)

    def generate_trace(self, record, output):
        events = record.precompile_events.get(self.EVENT_KEY, [])
        s, k, p = self.schema, self.k, cv.ED_P
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for row, ev in enumerate(events):
            self._fill_common(t, s, row, ev, sink,
                              [("pp", ev["p_ptr"]), ("qp", ev["q_ptr"])])
            x1 = cv.words_to_int(ev["p"][:8])
            y1 = cv.words_to_int(ev["p"][8:])
            x2 = cv.words_to_int(ev["q"][:8])
            y2 = cv.words_to_int(ev["q"][8:])
            f = x1 * y2 % p
            g = x2 * y1 % p
            h = x1 * x2 % p
            i_ = y1 * y2 % p
            j = h * i_ % p
            dj = cv.ED_D * j % p
            x3 = (f + g) * pow(1 + dj, -1, p) % p
            m = 0  # y3*dj, filled after y3
            y3 = (h + i_) * pow(1 - dj, -1, p) % p
            m = y3 * dj % p
            for pre, val in (("x1b", x1), ("y1b", y1), ("x2b", x2), ("y2b", y2),
                             ("x3b", x3), ("y3b", y3)):
                self._fill_bytes(t, s, row, pre, val, k, sink)
            l_ = lambda vv: int_to_limbs(vv, k)
            self.g_f.populate(t, s, row, [_conv(l_(x1), l_(y2))], [], sink, result=f)
            self.g_g.populate(t, s, row, [_conv(l_(x2), l_(y1))], [], sink, result=g)
            self.g_h.populate(t, s, row, [_conv(l_(x1), l_(x2))], [], sink, result=h)
            self.g_i.populate(t, s, row, [_conv(l_(y1), l_(y2))], [], sink, result=i_)
            self.g_j.populate(t, s, row, [_conv(l_(h), l_(i_))], [], sink, result=j)
            self.g_dj.populate(t, s, row, [_conv(l_(cv.ED_D), l_(j))], [], sink, result=dj)
            self.g_x3.populate(t, s, row, [l_(x3), _conv(l_(x3), l_(dj))], [l_(f), l_(g)], sink)
            self.g_m.populate(t, s, row, [_conv(l_(y3), l_(dj))], [], sink, result=m)
            self.g_y3.populate(t, s, row, [l_(y3)], [l_(m), l_(h), l_(i_)], sink)
            self._fill_accesses(t, s, row, "q{}", ev["q_records"], sink)
            self._fill_accesses(t, s, row, "p{}", ev["p_records"], sink)
        return t


class EdDecompressAir(_PrecompileRowAir):
    """x from (y, sign): -x^2 + y^2 = 1 + d x^2 y^2, parity(x) == sign."""

    name = "EdDecompress"
    EVENT_KEY = "ed_decompress"

    def __init__(self):
        k = 32
        self.k = k
        p = cv.ED_P
        self.code = SyscallCode.ED_DECOMPRESS
        e3 = _extra_n(p, k, 3)
        self.g_v = FopSpec("v", k, p, [2 * k - 1], [], extra_p=0)    # y*y
        self.g_dv = FopSpec("dv", k, p, [2 * k - 1], [], extra_p=0)  # d*v
        self.g_w = FopSpec("w", k, p, [2 * k - 1], [], extra_p=0)    # x*x
        self.g_t = FopSpec("tt", k, p, [2 * k - 1], [], extra_p=0)   # w*dv
        self.g_eq = FopSpec("eq", k, p, [k], [k, 1, k], extra_p=e3, with_result=False)
        names = ["shard", "clk", "is_real", "pp_lo", "pp_hi", "sign", "half"]
        for g in ("xb", "yb"):
            names += _byte_names(g, k)
        for spec in (self.g_v, self.g_dv, self.g_w, self.g_t, self.g_eq):
            names += spec.names()
        s = Schema(names)
        for i in range(8):
            s.names.extend(s.access_cols(f"y{i}"))
            s.names.extend(s.access_cols(f"x{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        pp = col.word("pp")
        sign = col("sign")
        b.assert_bool(sign)
        is_real, shard, clk = self._common(b, col, self.code, pp, (sign, 0))
        self._ptr_checks(b, (pp,), is_real)
        k = self.k
        xb = [col(f"xb{i}") for i in range(k)]
        yb = [col(f"yb{i}") for i in range(k)]
        self._u8_groups(b, col, (xb, yb), is_real)
        self._link_words(b, col, yb, "y{}", 0, 8, is_real)

        v = self.g_v.eval(b, col, [poly_mul(yb, yb)], [], is_real)
        d_l = int_to_limbs(cv.ED_D, k)
        dv = self.g_dv.eval(b, col, [poly_mul(d_l, v)], [], is_real)
        w = self.g_w.eval(b, col, [poly_mul(xb, xb)], [], is_real)
        tt = self.g_t.eval(b, col, [poly_mul(w, dv)], [], is_real)
        # y^2 - x^2 - 1 - d x^2 y^2 == 0
        self.g_eq.eval(b, col, [v], [w, [1], tt], is_real)

        half = col("half")
        send_u8_pair(b, half, 0, is_real)
        b.when(is_real).assert_eq(xb[0], 2 * half + sign)

        for i in range(8):
            prev = WordExpr(col(f"y{i}_prev_lo"), col(f"y{i}_prev_hi"))
            eval_memory_access(b, col, f"y{i}", shard, clk, pp.value_expr() + 32 + 4 * i, prev, is_real)
            eval_memory_access(b, col, f"x{i}", shard, clk, pp.value_expr() + 4 * i,
                               _word_of(xb, i), is_real)

    def generate_trace(self, record, output):
        events = record.precompile_events.get(self.EVENT_KEY, [])
        s, k, p = self.schema, self.k, cv.ED_P
        t = np.zeros((max(len(events), 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for row, ev in enumerate(events):
            self._fill_common(t, s, row, ev, sink, [("pp", ev["ptr"])])
            t[row, s.idx("sign")] = ev["sign"]
            y = cv.words_to_int(ev["y"])
            x = cv.words_to_int([r.value for r in ev["x_records"]])
            v = y * y % p
            dv = cv.ED_D * v % p
            w = x * x % p
            tt = w * dv % p
            t[row, s.idx("half")] = (x & 0xFF) >> 1
            sink.u8pair(np.array([(x & 0xFF) >> 1], dtype=np.uint32),
                        np.zeros(1, dtype=np.uint32))
            for pre, val in (("xb", x), ("yb", y)):
                self._fill_bytes(t, s, row, pre, val, k, sink)
            l_ = lambda vv: int_to_limbs(vv, k)
            self.g_v.populate(t, s, row, [_conv(l_(y), l_(y))], [], sink, result=v)
            self.g_dv.populate(t, s, row, [_conv(l_(cv.ED_D), l_(v))], [], sink, result=dv)
            self.g_w.populate(t, s, row, [_conv(l_(x), l_(x))], [], sink, result=w)
            self.g_t.populate(t, s, row, [_conv(l_(w), l_(dv))], [], sink, result=tt)
            self.g_eq.populate(t, s, row, [l_(v)], [l_(w), [1], l_(tt)], sink)
            self._fill_accesses(t, s, row, "y{}", ev["y_records"], sink)
            self._fill_accesses(t, s, row, "x{}", ev["x_records"], sink)
        return t


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def ec_precompile_airs() -> list:
    """Every EC/bigint precompile chip instance (mips/mod.rs:206-440 analog)."""
    C = SyscallCode
    airs = [
        WeierstrassAddAir(cv.SECP256K1, C.SECP256K1_ADD),
        WeierstrassDoubleAir(cv.SECP256K1, C.SECP256K1_DOUBLE),
        WeierstrassDecompressAir(cv.SECP256K1, C.SECP256K1_DECOMPRESS),
        WeierstrassAddAir(cv.SECP256R1, C.SECP256R1_ADD),
        WeierstrassDoubleAir(cv.SECP256R1, C.SECP256R1_DOUBLE),
        WeierstrassDecompressAir(cv.SECP256R1, C.SECP256R1_DECOMPRESS),
        WeierstrassAddAir(cv.BN254, C.BN254_ADD),
        WeierstrassDoubleAir(cv.BN254, C.BN254_DOUBLE),
        WeierstrassAddAir(cv.BLS12381, C.BLS12381_ADD),
        WeierstrassDoubleAir(cv.BLS12381, C.BLS12381_DOUBLE),
        WeierstrassDecompressAir(cv.BLS12381, C.BLS12381_DECOMPRESS),
        EdAddAir(),
        EdDecompressAir(),
        FpOpAir("bn254"),
        FpOpAir("bls12381"),
        Fp2AddSubAir("bn254"),
        Fp2AddSubAir("bls12381"),
        Fp2MulAir("bn254"),
        Fp2MulAir("bls12381"),
        Uint256MulAir(),
        U256x2048MulAir(),
    ]
    return airs
