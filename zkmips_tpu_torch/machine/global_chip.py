"""Global chip: septic-curve accumulation of cross-shard lookups.

Analog of the reference's GlobalChip (crates/core/machine/src/global/mod.rs
+ operations/global_lookup.rs + global_accumulation.rs): every global
interaction message is hashed onto the curve y^2 = x^3 + 3z*x - 3 over
F_{p^7} via lift_x (x = message with the kind in bits 16.. of coeff 0 and a
found offset in coeff 6), its y sign encodes send/receive, and an
incomplete-addition running sum accumulates the points; the final digest is
exposed in the last row's trailing 14 columns (bound to the proof's claimed
global cumulative sum by the generic permutation layer).
"""

from __future__ import annotations

import numpy as np

from ..utils.pool import zeros_mt

from ..ops import field as ff, septic
from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .gadgets import ByteSink, ColView, Schema, send_u16_check, send_u8_pair
from .lookups import global_msg

HALF = (ff.P - 1) // 2
# rcw = inv(top7 - 7): top7 (the count of y-range high bits) is in [0, 7]
_RCW_LUT = np.array(
    [ff.inv_int((t7 - 7) % ff.P) if t7 != 7 else 0 for t7 in range(8)],
    dtype=np.uint32,
)


def _septic_names(prefix):
    return [f"{prefix}{i}" for i in range(7)]


_COLS = (
    [f"m{i}" for i in range(7)]
    + ["kind", "is_send", "is_receive", "is_real"]
    + [f"off{i}" for i in range(8)]
    + _septic_names("x")
    + _septic_names("y")
    + [f"yb{i}" for i in range(30)]
    + ["rcw"]
    + _septic_names("cx")
    + _septic_names("cy")  # cumulative sum must be the trailing 14 columns
)


# --- septic arithmetic over expressions -------------------------------------


def _sep_mul(a, b):
    c = [0] * 13
    for i in range(7):
        for j in range(7):
            t = a[i] * b[j]
            c[i + j] = t if isinstance(c[i + j], int) and c[i + j] == 0 else c[i + j] + t
    for k in range(12, 6, -1):
        c[k - 7] = c[k - 7] + c[k] * 8
        c[k - 6] = c[k - 6] - c[k] * 2
    return c[:7]


def _sep_sub(a, b):
    return [x - y for x, y in zip(a, b)]


def _sep_add(a, b):
    return [x + y for x, y in zip(a, b)]


def _sum_checker_x(x1, y1, x2, y2, x3):
    dx = _sep_sub(x2, x1)
    dy = _sep_sub(y2, y1)
    return _sep_sub(_sep_mul(_sep_add(_sep_add(x1, x2), x3), _sep_mul(dx, dx)), _sep_mul(dy, dy))


def _sum_checker_y(x1, y1, x2, y2, x3, y3):
    dx = _sep_sub(x2, x1)
    dy = _sep_sub(y2, y1)
    return _sep_sub(_sep_mul(_sep_add(y1, y3), dx), _sep_mul(dy, _sep_sub(x1, x3)))


START = septic.ZERO_DIGEST_INT  # curve cumulative sum start point (sqrt(2))


class GlobalAir(BaseAir):
    name = "Global"

    def __init__(self):
        from ..stark.air import Scope

        self.schema = Schema(_COLS)
        self.main_width = self.schema.width
        self.commit_scope = Scope.Global

    @property
    def _scope(self):
        from ..stark.air import Scope

        return Scope.Global

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        is_send, is_recv = col("is_send"), col("is_receive")
        b.assert_bool(is_send)
        b.assert_bool(is_recv)
        b.assert_eq(is_send + is_recv, is_real)
        m = [col(f"m{i}") for i in range(7)]
        kind = col("kind")
        b.receive(
            LookupKind.Global,
            global_msg(m, is_send, is_recv, kind),
            is_real,
        )
        send_u16_check(b, m[0], is_real)
        send_u8_pair(b, kind, 0, is_real)

        # offset bits
        offs = [col(f"off{i}") for i in range(8)]
        offset = 0
        for i, o in enumerate(offs):
            b.assert_bool(o)
            offset = offset + o * (1 << i)

        # x derivation from the message
        x = [col(f"x{i}") for i in range(7)]
        y = [col(f"y{i}") for i in range(7)]
        w = b.when(is_real)
        w.assert_eq(x[0], m[0] + kind * 65536)
        for i in range(1, 6):
            w.assert_eq(x[i], m[i])
        w.assert_eq(x[6], m[6] * 256 + offset)

        # on-curve: y^2 == x^3 + 3z x - 3
        y2 = _sep_mul(y, y)
        x3 = _sep_mul(_sep_mul(x, x), x)
        az = _sep_mul([0, 3, 0, 0, 0, 0, 0], x)
        rhs = _sep_add(x3, az)
        rhs = [rhs[0] - 3] + rhs[1:]
        for i in range(7):
            w.assert_zero(y2[i] - rhs[i])

        # y sign range via 30-bit decomposition of y6 - 1 - is_send*(p-1)/2
        ybits = [col(f"yb{i}") for i in range(30)]
        v = 0
        for i, yb in enumerate(ybits):
            b.assert_bool(yb)
            v = v + yb * (1 << i)
        w.assert_eq(v, y[6] - 1 - is_send * HALF)
        top7 = 0
        for i in range(23, 30):
            top7 = top7 + ybits[i]
        b.assert_eq((top7 - 7) * col("rcw"), is_real)

        # accumulation: cum = prev_cum + P (negate P for sends)
        # y is stored sign-adjusted: receive-range y6 for receives, send-range
        # (negated) for sends — so the stored point IS the summand (and the
        # on-curve check is sign-agnostic).
        cx = [col(f"cx{i}") for i in range(7)]
        cy = [col(f"cy{i}") for i in range(7)]
        py = y
        sx = [int(c) for c in START[0]]
        sy = [int(c) for c in START[1]]
        first = b.when_first_row()
        fr = first.when(is_real)
        for e in _sum_checker_x(sx, sy, x, py, cx):
            fr.assert_zero(e)
        for e in _sum_checker_y(sx, sy, x, py, cx, cy):
            fr.assert_zero(e)
        fn_ = first.when_not(is_real)
        for i in range(7):
            fn_.assert_eq(cx[i], sx[i])
            fn_.assert_eq(cy[i], sy[i])

        nreal = col("is_real", 1)
        b.when_transition().when(nreal).assert_one(is_real)  # real-prefix
        ncx = [col(f"cx{i}", 1) for i in range(7)]
        ncy = [col(f"cy{i}", 1) for i in range(7)]
        nx = [col(f"x{i}", 1) for i in range(7)]
        npy = [col(f"y{i}", 1) for i in range(7)]
        tr = b.when_transition().when(nreal)
        for e in _sum_checker_x(cx, cy, nx, npy, ncx):
            tr.assert_zero(e)
        for e in _sum_checker_y(cx, cy, nx, npy, ncx, ncy):
            tr.assert_zero(e)
        tn = b.when_transition().when_not(nreal)
        for i in range(7):
            tn.assert_eq(ncx[i], cx[i])
            tn.assert_eq(ncy[i], cy[i])

    # ------------------------------------------------------------ trace gen

    def generate_trace(self, record, output):
        events = record.global_lookup_events
        s = self.schema
        n = len(events)
        t = zeros_mt((max(n, 1), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        if n == 0:
            for j in range(7):
                t[0, s.idx(f"cx{j}")] = int(START[0][j])
                t[0, s.idx(f"cy{j}")] = int(START[1][j])
            return t
        # batch-lift every event message (the scalar path cost ~4.5 ms/event)
        msgs = np.array([[int(v) for v in ev.message] for ev in events], dtype=np.uint64)
        kinds = np.array([ev.kind for ev in events], dtype=np.uint32)
        recv = np.array([bool(ev.is_receive) for ev in events], dtype=bool)
        x_in = msgs.copy()
        x_in[:, 0] = (x_in[:, 0] + (kinds.astype(np.uint64) << np.uint64(16))) % np.uint64(ff.P)
        xs, ys, offs = septic.lift_x_batch(x_in)
        ys_signed = np.where(recv[:, None], ys, (np.uint64(ff.P) - ys) % np.uint64(ff.P))
        t[:, s.idx("kind")] = kinds
        t[:, s.idx("is_receive")] = recv
        t[:, s.idx("is_send")] = ~recv
        t[:, s.idx("is_real")] = 1
        for j in range(7):
            t[:, s.idx(f"m{j}")] = msgs[:, j].astype(np.uint32)
            t[:, s.idx(f"x{j}")] = xs[:, j].astype(np.uint32)
            t[:, s.idx(f"y{j}")] = ys_signed[:, j].astype(np.uint32)
        for j in range(8):
            t[:, s.idx(f"off{j}")] = (offs >> j) & 1
        v = (ys_signed[:, 6] + np.uint64(ff.P) - np.uint64(1)
             - np.where(recv, np.uint64(0), np.uint64(HALF))) % np.uint64(ff.P)
        assert (v < (1 << 30)).all()
        v = v.astype(np.uint32)
        top7 = np.zeros(n, dtype=np.int64)
        for j in range(30):
            bit = (v >> j) & 1
            t[:, s.idx(f"yb{j}")] = bit
            if j >= 23:
                top7 += bit
        t[:, s.idx("rcw")] = _RCW_LUT[top7]
        # septic cumulative sum: in blocks (ops/septic.curve_prefix_sums),
        # or, where an addition meets equal x coordinates, the serial chain
        sums = septic.curve_prefix_sums(START, xs, ys_signed)
        if sums is not None:
            cx, cy = (a.astype(np.uint32) for a in sums)
        else:
            cum = ([int(c) for c in START[0]], [int(c) for c in START[1]])
            cx = np.empty((n, 7), dtype=np.uint32)
            cy = np.empty((n, 7), dtype=np.uint32)
            for i in range(n):
                cum = septic.curve_add_int(
                    cum, ([int(c) for c in xs[i]], [int(c) for c in ys_signed[i]])
                )
                cx[i] = cum[0]
                cy[i] = cum[1]
        for j in range(7):
            t[:, s.idx(f"cx{j}")] = cx[:, j]
            t[:, s.idx(f"cy{j}")] = cy[:, j]
        sink.u16(msgs[:, 0].astype(np.uint32))
        sink.u8pair(kinds, np.zeros(n, dtype=np.uint32))
        return t

    def pad_rows(self, t, target):
        """Padding must carry the cumulative sum forward (machine hook)."""
        n = t.shape[0]
        if target <= n:
            return t
        pad = np.zeros((target - n, t.shape[1]), dtype=np.uint32)
        s = self.schema
        for j in range(7):
            pad[:, s.idx(f"cx{j}")] = t[n - 1, s.idx(f"cx{j}")]
            pad[:, s.idx(f"cy{j}")] = t[n - 1, s.idx(f"cy{j}")]
        return np.concatenate([t, pad], axis=0)
