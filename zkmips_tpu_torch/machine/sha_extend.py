"""ShaExtend chip: SHA-256 message schedule, 48 rows per syscall event.

Analog of crates/core/machine/src/syscall/precompiles/sha256/extend: row i
(iter = 16..63) reads w[i-15], w[i-2], w[i-16], w[i-7] and writes w[i] at
timestamp clk + (i - 16); sigma rotations/xors are computed over full bit
decompositions of w[i-15] and w[i-2] (rotations are free bit permutations;
3-way xor is the degree-3 polynomial x+y+z-2(xy+yz+zx)+4xyz), so no byte
lookups are needed for the compression function itself.
"""

from __future__ import annotations

import numpy as np

from ..utils.pool import zeros_mt

from ..executor.opcodes import SyscallCode
from ..ops import field as ff
from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .gadgets import ByteSink, ColView, Schema, eval_memory_access, populate_access, send_u16_check
from .lookups import syscall_msg

CODE = SyscallCode.SHA_EXTEND
ID_LO = int(CODE) & 0xFFFF
ID_HI = int(CODE) >> 16

_ACCESSES = ["r15", "r2", "r16", "r7", "wout"]
_OFFSETS = {"r15": -15, "r2": -2, "r16": -16, "r7": -7, "wout": 0}


def _xor_bits(*bits):
    """xor of 1..3 bit exprs as a low-degree polynomial."""
    bits = [b for b in bits if not (isinstance(b, int) and b == 0)]
    if not bits:
        return 0
    if len(bits) == 1:
        return bits[0]
    if len(bits) == 2:
        x, y = bits
        return x + y - 2 * x * y
    x, y, z = bits
    return x + y + z - 2 * (x * y + y * z + x * z) + 4 * x * y * z


def _ror_bit(bits, j, r):
    """bit j of (w ror r) = bit (j + r) mod 32 of w."""
    return bits[(j + r) % 32]


def _shr_bit(bits, j, r):
    return bits[j + r] if j + r < 32 else 0


class ShaExtendAir(BaseAir):
    name = "ShaExtend"

    def __init__(self):
        names = [
            "shard", "clk", "wp_lo", "wp_hi", "iter",
            "is_start", "is_lastiter", "li_inv", "is_real",
            "w_lo", "w_hi", "c0", "c1",
        ]
        names += [f"b15_{j}" for j in range(32)]
        names += [f"b2_{j}" for j in range(32)]
        s = Schema(names)
        for p in _ACCESSES:
            s.names.extend(s.access_cols(p))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        is_start = col("is_start")
        b.assert_bool(is_real)
        b.assert_bool(is_start)
        b.assert_zero(is_start * (1 - is_real))
        shard, clk = col("shard"), col("clk")
        wp = col.word("wp")
        it = col("iter")

        # event structure
        b.when(is_start).assert_eq(it, 16)
        b.when_first_row().when(is_real).assert_one(is_start)
        li, li_inv = col("is_lastiter"), col("li_inv")
        b.assert_bool(li)
        b.assert_zero(li * (it - 63))
        b.when(is_real).assert_zero(li + (it - 63) * li_inv - 1)
        nreal, nstart = col("is_real", 1), col("is_start", 1)
        cont = nreal * (1 - nstart)  # next row continues this event
        t = b.when_transition()
        t.when(cont).assert_one(is_real)
        t.when(cont).assert_eq(col("iter", 1), it + 1)
        t.when(cont).assert_eq(col("clk", 1), clk)
        t.when(cont).assert_eq(col("shard", 1), shard)
        t.when(cont).assert_eq(col("wp_lo", 1), wp.lo)
        t.when(cont).assert_eq(col("wp_hi", 1), wp.hi)
        # an unfinished event cannot stop
        t.when(is_real * (1 - li)).assert_one(nreal)
        t.when(is_real * (1 - li)).assert_zero(nstart)

        # the syscall binding (one receive per event)
        b.receive(
            LookupKind.Syscall,
            syscall_msg(shard, clk, ID_LO, ID_HI, wp, (0, 0)),
            is_start,
        )

        # w_ptr range: wp < 2^31 - 2^24 (so addr arithmetic cannot wrap mod p)
        send_u16_check(b, wp.lo, is_real)
        send_u16_check(b, (wp.hi + 256) * 2, is_real)

        # bit decompositions of w[i-15] and w[i-2] (values = read prevs)
        b15 = [col(f"b15_{j}") for j in range(32)]
        b2 = [col(f"b2_{j}") for j in range(32)]
        for bit in b15 + b2:
            b.assert_bool(bit)
        v15_lo = sum(b15[j] * (1 << j) for j in range(16))
        v15_hi = sum(b15[j] * (1 << (j - 16)) for j in range(16, 32))
        v2_lo = sum(b2[j] * (1 << j) for j in range(16))
        v2_hi = sum(b2[j] * (1 << (j - 16)) for j in range(16, 32))
        b.when(is_real).assert_eq(v15_lo, col("r15_prev_lo"))
        b.when(is_real).assert_eq(v15_hi, col("r15_prev_hi"))
        b.when(is_real).assert_eq(v2_lo, col("r2_prev_lo"))
        b.when(is_real).assert_eq(v2_hi, col("r2_prev_hi"))

        # sigma0(w15) and sigma1(w2), bitwise
        s0_bits = [
            _xor_bits(_ror_bit(b15, j, 7), _ror_bit(b15, j, 18), _shr_bit(b15, j, 3))
            for j in range(32)
        ]
        s1_bits = [
            _xor_bits(_ror_bit(b2, j, 17), _ror_bit(b2, j, 19), _shr_bit(b2, j, 10))
            for j in range(32)
        ]
        s0_lo = sum(s0_bits[j] * (1 << j) for j in range(16))
        s0_hi = sum(s0_bits[j] * (1 << (j - 16)) for j in range(16, 32))
        s1_lo = sum(s1_bits[j] * (1 << j) for j in range(16))
        s1_hi = sum(s1_bits[j] * (1 << (j - 16)) for j in range(16, 32))

        # w_i = s1 + w16 + s0 + w7 (mod 2^32)
        w = col.word("w")
        c0, c1 = col("c0"), col("c1")
        for c in (c0, c1):
            b.assert_zero(c * (c - 1) * (c - 2) * (c - 3))
        w16_lo, w16_hi = col("r16_prev_lo"), col("r16_prev_hi")
        w7_lo, w7_hi = col("r7_prev_lo"), col("r7_prev_hi")
        b.when(is_real).assert_eq(s1_lo + w16_lo + s0_lo + w7_lo, w.lo + c0 * 65536)
        b.when(is_real).assert_eq(s1_hi + w16_hi + s0_hi + w7_hi + c0, w.hi + c1 * 65536)
        send_u16_check(b, w.lo, is_real)
        send_u16_check(b, w.hi, is_real)

        # memory accesses at ts = clk + (iter - 16)
        ts = clk + it - 16
        addr_base = wp.value_expr()
        from .words import WordExpr

        for p in _ACCESSES:
            addr = addr_base + (it + _OFFSETS[p]) * 4
            if p == "wout":
                value = w
            else:
                value = WordExpr(col(f"{p}_prev_lo"), col(f"{p}_prev_hi"))
            eval_memory_access(b, col, p, shard, ts, addr, value, is_real)

    # ------------------------------------------------------------ trace side

    def included(self, record) -> bool:
        return bool(record.precompile_events.get("sha_extend"))

    def generate_trace(self, record, output):
        """Vectorized across events: each of the 48 iterations is written for
        every event at once ((E,) u64 array math per iteration)."""
        events = record.precompile_events.get("sha_extend", [])
        s = self.schema
        E = len(events)
        t = zeros_mt((48 * E, s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        if E == 0:
            return t
        M32 = np.uint64(0xFFFFFFFF)
        j32 = np.arange(32, dtype=np.uint64)

        def rorv(x, r):
            return ((x >> np.uint64(r)) | (x << np.uint64(32 - r))) & M32

        shard = np.array([ev.shard for ev in events], dtype=np.uint32)
        clk = np.array([ev.clk for ev in events], dtype=np.uint32)
        wp = np.array([ev.w_ptr for ev in events], dtype=np.uint64)

        def recs(getter):
            ps = np.array([[getter(ev, k).prev_shard for k in range(48)] for ev in events], dtype=np.uint32)
            pt = np.array([[getter(ev, k).prev_timestamp for k in range(48)] for ev in events], dtype=np.uint32)
            pv = np.array([[getter(ev, k).prev_value for k in range(48)] for ev in events], dtype=np.uint32)
            vv = np.array([[getter(ev, k).value for k in range(48)] for ev in events], dtype=np.uint64)
            return ps, pt, pv, vv

        r15 = recs(lambda ev, k: ev.reads_15[k])
        r2 = recs(lambda ev, k: ev.reads_2[k])
        r16 = recs(lambda ev, k: ev.reads_16[k])
        r7 = recs(lambda ev, k: ev.reads_7[k])
        wr = recs(lambda ev, k: ev.writes[k])

        base = 48 * np.arange(E, dtype=np.int64)
        all_rows = (base[:, None] + np.arange(48)).reshape(-1)
        rep = lambda a: np.repeat(a, 48)
        t[all_rows, s.idx("shard")] = rep(shard)
        t[all_rows, s.idx("clk")] = rep(clk)
        t[all_rows, s.idx("wp_lo")] = rep((wp & 0xFFFF).astype(np.uint32))
        t[all_rows, s.idx("wp_hi")] = rep((wp >> 16).astype(np.uint32))
        t[all_rows, s.idx("is_real")] = 1
        sink.u16(rep((wp & 0xFFFF).astype(np.uint32)))
        sink.u16(rep((((wp >> 16) + 256) * 2).astype(np.uint32)))

        b15_0, b2_0 = s.idx("b15_0"), s.idx("b2_0")
        for k in range(48):
            it = 16 + k
            rows = base + k
            t[rows, s.idx("iter")] = it
            if k == 0:
                t[rows, s.idx("is_start")] = 1
            if it == 63:
                t[rows, s.idx("is_lastiter")] = 1
            else:
                t[rows, s.idx("li_inv")] = ff.inv_int((it - 63) % ff.P)
            w15 = r15[3][:, k]
            w2 = r2[3][:, k]
            t[rows, b15_0 : b15_0 + 32] = ((w15[:, None] >> j32) & np.uint64(1)).astype(np.uint32)
            t[rows, b2_0 : b2_0 + 32] = ((w2[:, None] >> j32) & np.uint64(1)).astype(np.uint32)
            wv = wr[3][:, k]
            wv_lo = (wv & np.uint64(0xFFFF)).astype(np.uint32)
            wv_hi = (wv >> 16).astype(np.uint32)
            t[rows, s.idx("w_lo")] = wv_lo
            t[rows, s.idx("w_hi")] = wv_hi
            sink.u16(wv_lo)
            sink.u16(wv_hi)
            s0 = rorv(w15, 7) ^ rorv(w15, 18) ^ (w15 >> np.uint64(3))
            s1 = rorv(w2, 17) ^ rorv(w2, 19) ^ (w2 >> np.uint64(10))
            w16v = r16[3][:, k]
            w7v = r7[3][:, k]
            lo16 = np.uint64(0xFFFF)
            c0 = ((s1 & lo16) + (w16v & lo16) + (s0 & lo16) + (w7v & lo16) - (wv & lo16)) >> np.uint64(16)
            c1 = ((s1 >> 16) + (w16v >> 16) + (s0 >> 16) + (w7v >> 16) + c0 - (wv >> 16)) >> np.uint64(16)
            t[rows, s.idx("c0")] = c0.astype(np.uint32)
            t[rows, s.idx("c1")] = c1.astype(np.uint32)
            ts = clk + k
            for p, (ps, pt, pv, vv) in (
                ("r15", r15), ("r2", r2), ("r16", r16), ("r7", r7), ("wout", wr),
            ):
                populate_access(t, s, rows, p, ps[:, k], pt[:, k], pv[:, k], shard, ts, sink)
        return t


def _ror_i(x, r):
    return ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF
