"""ShaCompress chip: SHA-256 compression function, 80 rows per syscall event.

Analog of crates/core/machine/src/syscall/precompiles/sha256/compress: rows
are organized as 10 octets of 8 (octet o, octet_num n; row = 8n + o):
n = 0 reads h[0..8] at clk, n in 1..8 runs compression round i = 8(n-1)+o
(one w[i] read per row at clk), n = 9 writes h[o] + v[o] back at clk + 1.
Working variables a..h: a, b, c, e, f, g ride full bit decompositions (the
sigma rotations are free bit permutations; Ch/Maj are degree<=3 bit
polynomials); d and h ride 16-bit limb pairs.  The round constant K is bound
through the (octet_num x octet) selector product.
"""

from __future__ import annotations

import numpy as np

from ..utils.pool import zeros_mt

from ..executor.opcodes import SyscallCode
from ..ops import field as ff
from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .gadgets import ByteSink, ColView, Schema, eval_memory_access, populate_access, send_u16_check, send_u8_pair
from .lookups import syscall_msg
from .words import WordExpr

CODE = SyscallCode.SHA_COMPRESS
ID_LO = int(CODE) & 0xFFFF
ID_HI = int(CODE) >> 16

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

BITS = ["a", "b", "c", "e", "f", "g"]  # bit-decomposed working vars
LIMBS = ["d", "h"]


def _xor3(x, y, z):
    return x + y + z - 2 * (x * y + y * z + x * z) + 4 * x * y * z


class ShaCompressAir(BaseAir):
    name = "ShaCompress"

    def included(self, record) -> bool:
        return bool(record.precompile_events.get("sha_compress"))

    def __init__(self):
        names = [
            "shard", "clk", "wp_lo", "wp_hi", "hp_lo", "hp_hi", "is_real", "is_start",
            "is_lastcmp", "kw_lo", "kw_hi",
            "car_e", "car_a", "car_e2", "car_a2",
            "s1w_lo", "s1w_hi", "chw_lo", "chw_hi", "s0w_lo", "s0w_hi", "majw_lo", "majw_hi",
        ]
        names += [f"oct{i}" for i in range(8)]
        names += [f"on{i}" for i in range(10)]
        names += [f"hi{i}_{l}" for i in range(8) for l in ("lo", "hi")]  # h_init
        for v in BITS:
            names += [f"{v}{j}" for j in range(32)]
        for v in LIMBS:
            names += [f"{v}_lo", f"{v}_hi"]
        s = Schema(names)
        s.names.extend(s.access_cols("m"))
        s.names.extend(["m_lo", "m_hi"])  # access value (write value for n=9)
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        b.assert_bool(is_real)
        shard, clk = col("shard"), col("clk")
        wp, hp = col.word("wp"), col.word("hp")

        oct_ = [col(f"oct{i}") for i in range(8)]
        on = [col(f"on{i}") for i in range(10)]
        for fl in oct_ + on:
            b.assert_bool(fl)
        b.when(is_real).assert_eq(sum(oct_), 1)
        b.when(is_real).assert_eq(sum(on), 1)
        is_start = col("is_start")
        b.assert_eq(is_start, is_real * on[0] * oct_[0])
        is_init = on[0]
        is_compress = sum(on[1:9])
        is_final = on[9]
        is_last = on[9] * oct_[7]

        # row chaining: octet rotates, octet_num advances on wrap
        nreal = col("is_real", 1)
        noct = [col(f"oct{i}", 1) for i in range(8)]
        non = [col(f"on{i}", 1) for i in range(10)]
        nstart = col("is_start", 1)
        cont = nreal * (1 - nstart)
        t = b.when_transition()
        t.when(cont).assert_one(is_real)
        for i in range(8):
            t.when(cont).assert_eq(noct[(i + 1) % 8], oct_[i])
        for i in range(10):
            # octet_num advances when octet wraps (oct7 -> oct0)
            t.when(cont).when(oct_[7]).assert_eq(non[(i + 1) % 10], on[i])
            t.when(cont).when(1 - oct_[7]).assert_eq(non[i], on[i])
        # an unfinished event cannot stop or restart
        t.when(is_real * (1 - is_last)).assert_one(nreal)
        t.when(is_real * (1 - is_last)).assert_zero(nstart)
        b.when_first_row().when(is_real).assert_one(is_init * oct_[0])
        # event-constant columns
        for name in ("shard", "clk", "wp_lo", "wp_hi", "hp_lo", "hp_hi"):
            t.when(cont).assert_eq(col(name, 1), col(name))
        for i in range(8):
            for l in ("lo", "hi"):
                t.when(cont).assert_eq(col(f"hi{i}_{l}", 1), col(f"hi{i}_{l}"))

        # syscall binding
        b.receive(
            LookupKind.Syscall,
            syscall_msg(shard, clk, ID_LO, ID_HI, wp, hp),
            is_start,
        )
        for w_ in (wp, hp):
            send_u16_check(b, w_.lo, is_real)
            send_u16_check(b, (w_.hi + 256) * 2, is_real)

        # selected-octet helpers
        def sel8(vals):
            return sum(oct_[i] * vals[i] for i in range(8))

        # phase 0: read h[o] at clk; bind to h_init[o]
        hinit_lo = [col(f"hi{i}_lo") for i in range(8)]
        hinit_hi = [col(f"hi{i}_hi") for i in range(8)]
        mprev = col.word("m_prev")
        w_init = b.when(is_real).when(is_init)
        w_init.assert_eq(sel8(hinit_lo), mprev.lo)
        w_init.assert_eq(sel8(hinit_hi), mprev.hi)

        # working-variable views
        bits = {v: [col(f"{v}{j}") for j in range(32)] for v in BITS}
        for v in BITS:
            for bit in bits[v]:
                b.assert_bool(bit)

        def val_lo(v):
            return sum(bits[v][j] * (1 << j) for j in range(16))

        def val_hi(v):
            return sum(bits[v][j] * (1 << (j - 16)) for j in range(16, 32))

        d = col.word("d")
        h_ = col.word("h")

        # first compress row: state = h_init
        first_cmp = is_real * on[1] * oct_[0]
        fc = b.when(first_cmp)
        for v, idx in (("a", 0), ("b", 1), ("c", 2), ("e", 4), ("f", 5), ("g", 6)):
            fc.assert_eq(val_lo(v), hinit_lo[idx])
            fc.assert_eq(val_hi(v), hinit_hi[idx])
        fc.assert_eq(d.lo, hinit_lo[3])
        fc.assert_eq(d.hi, hinit_hi[3])
        fc.assert_eq(h_.lo, hinit_lo[7])
        fc.assert_eq(h_.hi, hinit_hi[7])

        # round constant via (octet_num, octet) selectors, witnessed to keep
        # the step constraints low degree
        k_lo_e = sum(on[1 + n] * oct_[o] * (K[8 * n + o] & 0xFFFF) for n in range(8) for o in range(8))
        k_hi_e = sum(on[1 + n] * oct_[o] * (K[8 * n + o] >> 16) for n in range(8) for o in range(8))
        k_lo, k_hi = col("kw_lo"), col("kw_hi")
        b.when(is_real).assert_eq(k_lo, k_lo_e)
        b.when(is_real).assert_eq(k_hi, k_hi_e)

        # compression round (w_i = memory read value = m_prev)
        e_b, f_b, g_b, a_b, b_b, c_b = (bits[v] for v in ("e", "f", "g", "a", "b", "c"))
        s1_bits = [_xor3(e_b[(j + 6) % 32], e_b[(j + 11) % 32], e_b[(j + 25) % 32]) for j in range(32)]
        ch_bits = [e_b[j] * f_b[j] + (1 - e_b[j]) * g_b[j] for j in range(32)]
        s0_bits = [_xor3(a_b[(j + 2) % 32], a_b[(j + 13) % 32], a_b[(j + 22) % 32]) for j in range(32)]
        maj_bits = [
            a_b[j] * b_b[j] + a_b[j] * c_b[j] + b_b[j] * c_b[j] - 2 * a_b[j] * b_b[j] * c_b[j]
            for j in range(32)
        ]

        def acc_lo(bs):
            return sum(bs[j] * (1 << j) for j in range(16))

        def acc_hi(bs):
            return sum(bs[j] * (1 << (j - 16)) for j in range(16, 32))

        # witness the sigma/ch/maj sums (keeps the round-step constraints at
        # low degree and the quotient graphs small)
        wcmp = b.when(is_real * is_compress)
        for nm, bs in (("s1w", s1_bits), ("chw", ch_bits), ("s0w", s0_bits), ("majw", maj_bits)):
            wcmp.assert_eq(col(f"{nm}_lo"), acc_lo(bs))
            wcmp.assert_eq(col(f"{nm}_hi"), acc_hi(bs))

        # temp1 = h + s1 + ch + K + w ; temp2 = s0 + maj
        t1_lo = h_.lo + col("s1w_lo") + col("chw_lo") + k_lo + mprev.lo
        t1_hi = h_.hi + col("s1w_hi") + col("chw_hi") + k_hi + mprev.hi
        t2_lo = col("s0w_lo") + col("majw_lo")
        t2_hi = col("s0w_hi") + col("majw_hi")

        # next-state (only constrained when the NEXT row is still compress)
        nbits = {v: [col(f"{v}{j}", 1) for j in range(32)] for v in BITS}

        def nval_lo(v):
            return sum(nbits[v][j] * (1 << j) for j in range(16))

        def nval_hi(v):
            return sum(nbits[v][j] * (1 << (j - 16)) for j in range(16, 32))

        ncmp = sum(non[1:9])
        nfin_ = non[9]
        is_lastcmp = col("is_lastcmp")
        b.assert_eq(is_lastcmp, on[8] * oct_[7])
        # the round-update rule applies whenever the next row is the next
        # round OR the finalize phase begins (the 64th round's update)
        step_guard = is_real * (is_compress * ncmp + is_lastcmp * nfin_)
        step = b.when_transition().when(step_guard)
        # shifts
        for src, dst in (("a", "b"), ("b", "c"), ("e", "f"), ("f", "g")):
            for j in range(32):
                step.assert_eq(nbits[dst][j], bits[src][j])
        step.assert_eq(col("d_lo", 1), val_lo("c"))
        step.assert_eq(col("d_hi", 1), val_hi("c"))
        step.assert_eq(col("h_lo", 1), val_lo("g"))
        step.assert_eq(col("h_hi", 1), val_hi("g"))
        # e' = d + temp1 ; a' = temp1 + temp2  (carries witnessed, u8-checked)
        car_e, car_a = col("car_e"), col("car_a")
        send_u8_pair(b, car_e, car_a, is_real)
        step.assert_eq(d.lo + t1_lo, nval_lo("e") + car_e * 65536)
        step.assert_eq(
            d.hi + t1_hi + car_e - nval_hi("e"),
            col("car_e2") * 65536,
        )
        step.assert_eq(t1_lo + t2_lo, nval_lo("a") + car_a * 65536)
        step.assert_eq(
            t1_hi + t2_hi + car_a - nval_hi("a"),
            col("car_a2") * 65536,
        )
        send_u8_pair(b, col("car_e2"), col("car_a2"), is_real)

        # phase 9: write h_init[o] + v[o]; v = state after the last round.
        # The state is carried into the finalize rows by the same shift-free
        # rule: when the next row is finalize, state stays put.
        nfin = nfin_
        hold_cond = is_real * (is_compress - is_lastcmp + is_final) * nfin
        hold = b.when_transition().when(hold_cond)
        for v in BITS:
            for j in range(32):
                hold.assert_eq(nbits[v][j], bits[v][j])
        hold.assert_eq(col("d_lo", 1), d.lo)
        hold.assert_eq(col("d_hi", 1), d.hi)
        hold.assert_eq(col("h_lo", 1), h_.lo)
        hold.assert_eq(col("h_hi", 1), h_.hi)
        # finalize write value: m = h_init[o] + v[o] (mod 2^32)
        vcur_lo = [val_lo("a"), val_lo("b"), val_lo("c"), d.lo, val_lo("e"), val_lo("f"), val_lo("g"), h_.lo]
        vcur_hi = [val_hi("a"), val_hi("b"), val_hi("c"), d.hi, val_hi("e"), val_hi("f"), val_hi("g"), h_.hi]
        m_w = col.word("m")
        wf = b.when(is_real * is_final)
        cf, cf2 = col("car_e"), col("car_e2")  # reuse carry cols on finalize rows
        wf.assert_eq(sel8(hinit_lo) + sel8(vcur_lo), m_w.lo + cf * 65536)
        wf.assert_eq(sel8(hinit_hi) + sel8(vcur_hi) + cf - m_w.hi, cf2 * 65536)
        send_u16_check(b, m_w.lo, is_final * is_real)
        send_u16_check(b, m_w.hi, is_final * is_real)
        # reads leave memory unchanged
        nw = is_real * (1 - is_final)
        b.when(nw).assert_eq(m_w.lo, mprev.lo)
        b.when(nw).assert_eq(m_w.hi, mprev.hi)

        # the memory access: addr + timestamp per phase
        o_idx = sum(oct_[i] * i for i in range(8))
        i_idx = sum(on[1 + n] * n for n in range(8)) * 8 + o_idx
        addr = (
            is_init * (hp.value_expr() + o_idx * 4)
            + is_compress * (wp.value_expr() + i_idx * 4)
            + is_final * (hp.value_expr() + o_idx * 4)
        )
        ts = clk + is_final
        eval_memory_access(b, col, "m", shard, ts, addr, m_w, is_real)

    # ------------------------------------------------------------ trace side

    def generate_trace(self, record, output):
        """Vectorized across events: the 64-round state replay runs as (E,)
        u64 array recurrences, and each of the 80 (octet, phase) row
        positions is written for every event at once."""
        events = record.precompile_events.get("sha_compress", [])
        s = self.schema
        E = len(events)
        t = zeros_mt((80 * E, s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        if E == 0:
            return t
        M32 = np.uint64(0xFFFFFFFF)
        j32 = np.arange(32, dtype=np.uint64)

        def rorv(x, r):
            return ((x >> np.uint64(r)) | (x << np.uint64(32 - r))) & M32

        hx = np.array([[r.value for r in ev.h_reads] for ev in events], dtype=np.uint64)
        wv = np.array([[r.value for r in ev.w_reads] for ev in events], dtype=np.uint64)
        shard = np.array([ev.shard for ev in events], dtype=np.uint32)
        clk = np.array([ev.clk for ev in events], dtype=np.uint32)
        wp = np.array([ev.w_ptr for ev in events], dtype=np.uint64)
        hp = np.array([ev.h_ptr for ev in events], dtype=np.uint64)

        # replay the 64 rounds over all events; states[i] = 8 x (E,) before round i
        states = []
        a, bb, c, d, e, f_, g, h = (hx[:, i].copy() for i in range(8))
        for i in range(64):
            states.append((a, bb, c, d, e, f_, g, h))
            w_i = wv[:, i]
            s1 = rorv(e, 6) ^ rorv(e, 11) ^ rorv(e, 25)
            ch = ((e & f_) ^ (~e & g)) & M32
            temp1 = (h + s1 + ch + np.uint64(K[i]) + w_i) & M32
            s0 = rorv(a, 2) ^ rorv(a, 13) ^ rorv(a, 22)
            maj = ((a & bb) ^ (a & c) ^ (bb & c)) & M32
            temp2 = (s0 + maj) & M32
            a, bb, c, d, e, f_, g, h = (
                (temp1 + temp2) & M32, a, bb, c, (d + temp1) & M32, e, f_, g,
            )
        final_state = (a, bb, c, d, e, f_, g, h)
        states.append(final_state)

        base = 80 * np.arange(E, dtype=np.int64)
        all_rows = (base[:, None] + np.arange(80)).reshape(-1)
        rep = lambda arr: np.repeat(arr, 80)
        t[all_rows, s.idx("shard")] = rep(shard)
        t[all_rows, s.idx("clk")] = rep(clk)
        t[all_rows, s.idx("wp_lo")] = rep((wp & 0xFFFF).astype(np.uint32))
        t[all_rows, s.idx("wp_hi")] = rep((wp >> 16).astype(np.uint32))
        t[all_rows, s.idx("hp_lo")] = rep((hp & 0xFFFF).astype(np.uint32))
        t[all_rows, s.idx("hp_hi")] = rep((hp >> 16).astype(np.uint32))
        t[all_rows, s.idx("is_real")] = 1
        for i in range(8):
            t[all_rows, s.idx(f"hi{i}_lo")] = rep((hx[:, i] & M32 & np.uint64(0xFFFF)).astype(np.uint32))
            t[all_rows, s.idx(f"hi{i}_hi")] = rep((hx[:, i] >> 16).astype(np.uint32))
        sink.u16(rep((wp & 0xFFFF).astype(np.uint32)))
        sink.u16(rep((((wp >> 16) + 256) * 2).astype(np.uint32)))
        sink.u16(rep((hp & 0xFFFF).astype(np.uint32)))
        sink.u16(rep((((hp >> 16) + 256) * 2).astype(np.uint32)))

        # record-field extraction for the one memory access per row
        def rec_fields(get):
            ps = np.array([[get(ev, o).prev_shard for o in range(8)] for ev in events], dtype=np.uint32)
            pt = np.array([[get(ev, o).prev_timestamp for o in range(8)] for ev in events], dtype=np.uint32)
            pv = np.array([[get(ev, o).prev_value for o in range(8)] for ev in events], dtype=np.uint32)
            vv = np.array([[get(ev, o).value for o in range(8)] for ev in events], dtype=np.uint32)
            return ps, pt, pv, vv

        h_ps, h_pt, h_pv, h_vv = rec_fields(lambda ev, o: ev.h_reads[o])
        hw_ps, hw_pt, hw_pv, hw_vv = rec_fields(lambda ev, o: ev.h_writes[o])
        w_ps = np.array([[r.prev_shard for r in ev.w_reads] for ev in events], dtype=np.uint32)
        w_pt = np.array([[r.prev_timestamp for r in ev.w_reads] for ev in events], dtype=np.uint32)
        w_pv = np.array([[r.prev_value for r in ev.w_reads] for ev in events], dtype=np.uint32)
        w_vv = np.array([[r.value for r in ev.w_reads] for ev in events], dtype=np.uint32)

        bit_bases = {v: s.idx(f"{v}0") for v in ("a", "b", "c", "e", "f", "g")}

        for n in range(10):
            for o in range(8):
                rows = base + 8 * n + o
                t[rows, s.idx(f"oct{o}")] = 1
                t[rows, s.idx(f"on{n}")] = 1
                if n == 0 and o == 0:
                    t[rows, s.idx("is_start")] = 1
                if n == 8 and o == 7:
                    t[rows, s.idx("is_lastcmp")] = 1
                if 1 <= n <= 8:
                    kv = K[8 * (n - 1) + o]
                    t[rows, s.idx("kw_lo")] = kv & 0xFFFF
                    t[rows, s.idx("kw_hi")] = kv >> 16
                if n == 0:
                    st = tuple(hx[:, i] for i in range(8))
                elif n <= 8:
                    st = states[8 * (n - 1) + o]
                else:
                    st = final_state
                av, bv, cv, dv, ev_, fv, gv, hv = st
                for vname, val in (("a", av), ("b", bv), ("c", cv), ("e", ev_), ("f", fv), ("g", gv)):
                    b0 = bit_bases[vname]
                    t[rows, b0 : b0 + 32] = ((val[:, None] >> j32) & np.uint64(1)).astype(np.uint32)
                t[rows, s.idx("d_lo")] = (dv & np.uint64(0xFFFF)).astype(np.uint32)
                t[rows, s.idx("d_hi")] = (dv >> 16).astype(np.uint32)
                t[rows, s.idx("h_lo")] = (hv & np.uint64(0xFFFF)).astype(np.uint32)
                t[rows, s.idx("h_hi")] = (hv >> 16).astype(np.uint32)
                if n == 0:
                    ps, pt, pv, vv = h_ps[:, o], h_pt[:, o], h_pv[:, o], h_vv[:, o]
                    ts_v = clk
                elif n <= 8:
                    i = 8 * (n - 1) + o
                    ps, pt, pv, vv = w_ps[:, i], w_pt[:, i], w_pv[:, i], w_vv[:, i]
                    ts_v = clk
                else:
                    ps, pt, pv, vv = hw_ps[:, o], hw_pt[:, o], hw_pv[:, o], hw_vv[:, o]
                    ts_v = clk + 1
                t[rows, s.idx("m_lo")] = vv & 0xFFFF
                t[rows, s.idx("m_hi")] = vv >> 16
                populate_access(t, s, rows, "m", ps, pt, pv, shard, ts_v, sink)
                if 1 <= n <= 8:
                    i = 8 * (n - 1) + o
                    nxt = states[i + 1]
                    w_i = wv[:, i]
                    a0, b0_, c0, d0, e0, f0, g0, h0 = states[i]
                    s1 = rorv(e0, 6) ^ rorv(e0, 11) ^ rorv(e0, 25)
                    ch = ((e0 & f0) ^ (~e0 & g0)) & M32
                    s0v = rorv(a0, 2) ^ rorv(a0, 13) ^ rorv(a0, 22)
                    maj = ((a0 & b0_) ^ (a0 & c0) ^ (b0_ & c0)) & M32
                    ne, na = nxt[4], nxt[0]
                    for name, valv in (("s1w", s1), ("chw", ch), ("s0w", s0v), ("majw", maj)):
                        t[rows, s.idx(f"{name}_lo")] = (valv & np.uint64(0xFFFF)).astype(np.uint32)
                        t[rows, s.idx(f"{name}_hi")] = (valv >> 16).astype(np.uint32)
                    kv = np.uint64(K[i])
                    t1_lo = (h0 & np.uint64(0xFFFF)) + (s1 & np.uint64(0xFFFF)) + (ch & np.uint64(0xFFFF)) + (kv & np.uint64(0xFFFF)) + (w_i & np.uint64(0xFFFF))
                    t1_hi = (h0 >> 16) + (s1 >> 16) + (ch >> 16) + (kv >> 16) + (w_i >> 16)
                    t2_lo = (s0v & np.uint64(0xFFFF)) + (maj & np.uint64(0xFFFF))
                    t2_hi = (s0v >> 16) + (maj >> 16)
                    car_e = ((d0 & np.uint64(0xFFFF)) + t1_lo - (ne & np.uint64(0xFFFF))) >> np.uint64(16)
                    car_e2 = ((d0 >> 16) + t1_hi + car_e - (ne >> 16)) >> np.uint64(16)
                    car_a = (t1_lo + t2_lo - (na & np.uint64(0xFFFF))) >> np.uint64(16)
                    car_a2 = (t1_hi + t2_hi + car_a - (na >> 16)) >> np.uint64(16)
                    car_e = car_e.astype(np.uint32); car_a = car_a.astype(np.uint32)
                    car_e2 = car_e2.astype(np.uint32); car_a2 = car_a2.astype(np.uint32)
                    t[rows, s.idx("car_e")] = car_e
                    t[rows, s.idx("car_a")] = car_a
                    t[rows, s.idx("car_e2")] = car_e2
                    t[rows, s.idx("car_a2")] = car_a2
                    sink.u8pair(car_e, car_a)
                    sink.u8pair(car_e2, car_a2)
                elif n == 9:
                    vcur = final_state[o]
                    hsum_lo = (hx[:, o] & np.uint64(0xFFFF)) + (vcur & np.uint64(0xFFFF))
                    vv64 = vv.astype(np.uint64)
                    cf = (hsum_lo - (vv64 & np.uint64(0xFFFF))) >> np.uint64(16)
                    cf2 = ((hx[:, o] >> 16) + (vcur >> 16) + cf - (vv64 >> 16)) >> np.uint64(16)
                    cf = cf.astype(np.uint32); cf2 = cf2.astype(np.uint32)
                    t[rows, s.idx("car_e")] = cf
                    t[rows, s.idx("car_e2")] = cf2
                    zero = np.zeros(E, dtype=np.uint32)
                    sink.u8pair(cf, zero)
                    sink.u8pair(cf2, zero)
                    sink.u16(vv & 0xFFFF)
                    sink.u16(vv >> 16)
                else:
                    zero = np.zeros(E, dtype=np.uint32)
                    sink.u8pair(zero, zero)
                    sink.u8pair(zero, zero)
        return t


def _ror(x, r):
    return ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF


