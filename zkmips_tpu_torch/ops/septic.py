"""Septic extension F_{p^7} = F_p[z]/(z^7 + 2z - 8) and the lookup curve.

The cross-shard ("global") lookup argument hashes multisets onto the elliptic
curve y^2 = x^3 + 3z*x - 3 over F_{p^7} (reference:
crates/stark/src/septic_curve.rs:1-20, septic_extension.rs, septic_digest.rs).
Protocol constants (dummy/start points) are transcribed from
crates/stark/src/septic_curve.rs:18-24 and septic_digest.rs:9-22.

Representation: numpy uint32 arrays with a trailing axis of length 7
(coefficients of 1, z, ..., z^6), Montgomery form.  Everything here runs on
the host: the Global chip's trace fill lifts lookup messages onto the curve
and the verifier sums the shards' digests.
"""

from __future__ import annotations

import numpy as np

from . import field as f

D = 7

# z^7 = -2z + 8
_RED_C0 = 8  # coefficient folded into position k-7
_RED_C1 = -2  # coefficient folded into position k-6


def _poly_mulmod_int(a: list[int], b: list[int]) -> list[int]:
    """Host-side septic mul over python ints (for precomputing constants)."""
    c = [0] * 13
    for i in range(7):
        for j in range(7):
            c[i + j] = (c[i + j] + a[i] * b[j]) % f.P
    for k in range(12, 6, -1):
        c[k - 7] = (c[k - 7] + 8 * c[k]) % f.P
        c[k - 6] = (c[k - 6] - 2 * c[k]) % f.P
    return [x % f.P for x in c[:7]]


def _pow_int(a: list[int], e: int) -> list[int]:
    r = [1, 0, 0, 0, 0, 0, 0]
    base = list(a)
    while e:
        if e & 1:
            r = _poly_mulmod_int(r, base)
        e >>= 1
        base = _poly_mulmod_int(base, base)
    return r


def _frob_matrix(k: int) -> np.ndarray:
    """7x7 matrix M with rows M[i] = coefficients of (z^i)^(p^k)."""
    zp = _pow_int([0, 1, 0, 0, 0, 0, 0], pow(f.P, k))
    rows = [[1, 0, 0, 0, 0, 0, 0]]
    for _ in range(6):
        rows.append(_poly_mulmod_int(rows[-1], zp))
    return np.array(
        [[f.to_monty_int(c) for c in row] for row in rows], dtype=np.uint32
    )


# frobenius matrices for k = 1..6 (host precompute, cached at import)
_FROB_M = {k: _frob_matrix(k) for k in range(1, 7)}


def scalar(coeffs) -> np.ndarray:
    return np.array([f.to_monty_int(int(c) % f.P) for c in coeffs], dtype=np.uint32)


ZERO = scalar([0] * 7)
ONE = scalar([1, 0, 0, 0, 0, 0, 0])
# curve: y^2 = x^3 + B_X1 * z * x - 3  => a = 3z, b = -3
CURVE_A = scalar([0, 3, 0, 0, 0, 0, 0])
CURVE_B = scalar([f.P - 3, 0, 0, 0, 0, 0, 0])

# septic_curve.rs:18-24 — witness dummy point (padding lookups)
DUMMY_X = scalar([1706420302, 1319108093, 148224806, 26874985, 1766171812, 1645633948, 2028659224])
DUMMY_Y = scalar([942390502, 1239997438, 458866455, 1843332012, 1309764648, 572807436, 74267719])
# septic_digest.rs:9-14 — cumulative-sum start point (derived from sqrt(2))
START_X = scalar([637514027, 1595065213, 1998064738, 72333738, 1211544370, 822986770, 1518535784])
START_Y = scalar([1604177449, 90440090, 259343427, 140470264, 1162099742, 941559812, 1064053343])
# septic_digest.rs:17-22 — digest accumulation start (derived from sqrt(3))
DIGEST_START_X = scalar([1656788302, 897965284, 874620737, 1581672598, 655804282, 1962911564, 80580607])
DIGEST_START_Y = scalar([1024875409, 218609128, 1856341123, 583920580, 1274441611, 118766316, 81843042])


def add(a, b):
    return f.add(a, b)


def sub(a, b):
    return f.sub(a, b)


def neg(a):
    return f.neg(a)


def from_base(x):
    z = x * np.uint32(0)
    return np.stack([x] + [z] * 6, axis=-1)


def mul(a, b):
    """Schoolbook septic mul (49 base muls) with z^7 = 8 - 2z folding."""
    c = [None] * 13
    for i in range(7):
        for j in range(7):
            t = f.mul(a[..., i], b[..., j])
            k = i + j
            c[k] = t if c[k] is None else f.add(c[k], t)
    for k in range(12, 6, -1):
        t8 = f.mul(c[k], f.monty_const(8))
        t2 = f.mul(c[k], f.monty_const(2))
        c[k - 7] = f.add(c[k - 7], t8)
        c[k - 6] = f.sub(c[k - 6], t2)
    return np.stack(c[:7], axis=-1)


def mul_base(a, b):
    return f.mul(a, b[..., None])


def square(a):
    return mul(a, a)


def frobenius(a, k: int):
    """a^(p^k) via the precomputed linear map (49 base muls)."""
    m = _FROB_M[k]
    out = []
    for j in range(7):
        acc = f.mul(a[..., 0], m[0, j])
        for i in range(1, 7):
            acc = f.add(acc, f.mul(a[..., i], m[i, j]))
        out.append(acc)
    return np.stack(out, axis=-1)


def inv(a):
    """a^{-1} = (prod_{k=1..6} a^{p^k}) / N(a) with N(a) in F_p."""
    b = frobenius(a, 1)
    for k in range(2, 7):
        b = mul(b, frobenius(a, k))
    prod = mul(a, b)  # lies in F_p: coefficients 1..6 are zero
    return mul_base(b, f.inv(prod[..., 0]))


def curve_formula(x):
    """x^3 + 3z*x - 3."""
    return add(add(mul(square(x), x), mul(CURVE_A, x)), CURVE_B)


def is_on_curve(x, y):
    lhs = square(y)
    rhs = curve_formula(x)
    return lhs, rhs


def curve_add(x1, y1, x2, y2):
    """Incomplete Weierstrass addition (septic_curve.rs:54-60).

    Assumes x1 != x2 (the protocol's start/dummy points make exceptions
    cryptographically unreachable).
    """
    slope = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(square(slope), x1), x2)
    y3 = sub(mul(slope, sub(x1, x3)), y1)
    return x3, y3


def curve_double(x1, y1):
    """Point doubling: slope = (3x^2 + a) / (2y)."""
    three = f.monty_const(3)
    sl_num = add(mul_base(square(x1), three), CURVE_A)
    slope = mul(sl_num, inv(add(y1, y1)))
    x3 = sub(sub(square(slope), x1), x1)
    y3 = sub(mul(slope, sub(x1, x3)), y1)
    return x3, y3


def curve_sum_host(xs: np.ndarray, ys: np.ndarray, start_x=None, start_y=None):
    """Host-side sequential sum of curve points starting from START (numpy).

    xs, ys: (n, 7).  Returns the final (x, y) with the start point *included*
    (reference SepticDigest accumulation semantics: digest = start + sum(points),
    septic_digest.rs:30-50).
    """
    ax = START_X.copy() if start_x is None else np.asarray(start_x)
    ay = START_Y.copy() if start_y is None else np.asarray(start_y)
    for i in range(xs.shape[0]):
        ax, ay = curve_add(ax, ay, xs[i], ys[i])
    return ax, ay


# ---------------------------------------------------------------------------
# Host-side (python int) sqrt and x-coordinate lifting, for the Global chip
# trace generator (reference: septic_extension.rs:600-694, septic_curve.rs:130)
# ---------------------------------------------------------------------------

_FROB_INT = {}


def _frob_int_matrix(k: int):
    if k not in _FROB_INT:
        zp = _pow_int([0, 1, 0, 0, 0, 0, 0], pow(f.P, k))
        rows = [[1, 0, 0, 0, 0, 0, 0]]
        for _ in range(6):
            rows.append(_poly_mulmod_int(rows[-1], zp))
        _FROB_INT[k] = rows
    return _FROB_INT[k]


def _frob_apply_int(a, k: int):
    m = _frob_int_matrix(k)
    out = [0] * 7
    for i in range(7):
        ai = a[i]
        if ai:
            row = m[i]
            for j in range(7):
                out[j] = (out[j] + ai * row[j]) % f.P
    return out


def sqrt_int(n):
    """Square root in F_{p^7} (reference septic_extension.rs:626-675) or None."""
    if all(c == 0 for c in n):
        return list(n)
    if n[0] == 1 and all(c == 0 for c in n[1:]):
        return list(n)
    # norm = n^{(p^7-1)/(p-1)} lies in F_p
    base_ = _poly_mulmod_int(_frob_apply_int(n, 1), _frob_apply_int(n, 2))
    base_p2 = _frob_apply_int(base_, 2)
    base_p4 = _frob_apply_int(base_p2, 2)
    pow_r_1 = _poly_mulmod_int(_poly_mulmod_int(base_, base_p2), base_p4)
    pow_r = _poly_mulmod_int(pow_r_1, n)
    numerator = pow_r[0]
    if pow(numerator, (f.P - 1) // 2, f.P) != 1:
        return None
    # n_power = n^{(p+1)/2}
    n_power = _pow_int(n, (f.P + 1) // 2)
    nf = _frob_apply_int(n_power, 1)
    denominator = nf
    nf = _frob_apply_int(nf, 2)
    denominator = _poly_mulmod_int(denominator, nf)
    nf = _frob_apply_int(nf, 2)
    denominator = _poly_mulmod_int(denominator, nf)
    denominator = _poly_mulmod_int(denominator, n)
    # Cipolla square root of 1/numerator in F_p
    base_fp = pow(numerator, f.P - 2, f.P)
    g = f.GENERATOR
    a = 1
    nonres = (1 - base_fp) % f.P
    while pow(nonres, (f.P - 1) // 2, f.P) == 1:
        a = a * g % f.P
        nonres = (a * a - base_fp) % f.P
    # x = (a + i)^{(p+1)/2} in F_p[i]/(i^2 - nonres)
    e = (f.P + 1) // 2
    xr, xi = a, 1
    rr, ri = 1, 0
    while e:
        if e & 1:
            rr, ri = (rr * xr + ri * xi % f.P * nonres) % f.P, (rr * xi + ri * xr) % f.P
        xr, xi = (xr * xr + xi * xi % f.P * nonres) % f.P, (2 * xr * xi) % f.P
        e >>= 1
    return [c * rr % f.P for c in denominator]


def lift_x_int(m):
    """Lift 7 canonical ints to a curve point (reference septic_curve.rs:130).

    Returns (x, y, offset) with y in the 'receive' range (y[6] <= (p-1)/2).
    """
    half = (f.P - 1) // 2
    for offset in range(256):
        x = [m[0], m[1], m[2], m[3], m[4], m[5], (m[6] * 256 + offset) % f.P]
        y_sq = _curve_formula_int(x)
        y = sqrt_int(y_sq)
        if y is None:
            continue
        y6 = y[6]
        if y6 == 0:
            continue
        if y6 > half:  # is_send range: take the conjugate
            y = [(f.P - c) % f.P for c in y]
        return x, y, offset
    raise ValueError("no curve point found in 256 offsets")


def _curve_formula_int(x):
    x2 = _poly_mulmod_int(x, x)
    x3 = _poly_mulmod_int(x2, x)
    out = list(x3)
    # + 3z*x
    zx = [0] + [3 * c % f.P for c in x[:6]]
    extra = _poly_mulmod_int([0, 3, 0, 0, 0, 0, 0], x)
    for j in range(7):
        out[j] = (out[j] + extra[j]) % f.P
    out[0] = (out[0] - 3) % f.P
    return out


def curve_add_int(p1, p2):
    """Incomplete addition on int 7-tuples ((x, y) pairs)."""
    x1, y1 = p1
    x2, y2 = p2
    dx = [(a - b) % f.P for a, b in zip(x2, x1)]
    dy = [(a - b) % f.P for a, b in zip(y2, y1)]
    slope = _poly_mulmod_int(dy, _inv_int7(dx))
    s2 = _poly_mulmod_int(slope, slope)
    x3 = [(s2[j] - x1[j] - x2[j]) % f.P for j in range(7)]
    y3 = _poly_mulmod_int(slope, [(x1[j] - x3[j]) % f.P for j in range(7)])
    y3 = [(y3[j] - y1[j]) % f.P for j in range(7)]
    return x3, y3


def _inv_int7(a):
    b = _frob_apply_int(a, 1)
    for k in range(2, 7):
        b = _poly_mulmod_int(b, _frob_apply_int(a, k))
    norm = _poly_mulmod_int(a, b)[0]
    ninv = pow(norm, f.P - 2, f.P)
    return [c * ninv % f.P for c in b]


ZERO_DIGEST_INT = (
    [637514027, 1595065213, 1998064738, 72333738, 1211544370, 822986770, 1518535784],
    [1604177449, 90440090, 259343427, 140470264, 1162099742, 941559812, 1064053343],
)


# ---------------------------------------------------------------------------
# Batched (numpy u64) curve lifting — vectorizes lift_x_int over events.
# The per-event python-int path costs ~4.5 ms/event (sqrt + exp chains); the
# Global chip lifts every global lookup event, which dominated small-guest
# proving.  Arithmetic is canonical u64: every product is reduced mod p
# before accumulation (7 * p^2 would overflow), matching the int path
# bit-for-bit (differential test: tests/test_torch_mips_chips.py).
# ---------------------------------------------------------------------------


def _poly_mulmod_np(a, b):
    """(n, 7) x (n, 7) canonical u64 -> (n, 7), z^7 = 8 - 2z reduction.
    The 49 products are reduced in one pass; a coefficient sums at most
    seven of them (below 2^34) before its reduction."""
    n = a.shape[0]
    P = np.uint64(f.P)
    prod = a[:, :, None] * b[:, None, :] % P
    c = np.zeros((n, 13), dtype=np.uint64)
    for i in range(7):
        c[:, i : i + 7] += prod[:, i, :]
    c %= P
    for k in range(12, 6, -1):
        c[:, k - 7] = (c[:, k - 7] + np.uint64(8) * c[:, k]) % P
        c[:, k - 6] = (c[:, k - 6] + (P - c[:, k]) % P * np.uint64(2)) % P
    return np.ascontiguousarray(c[:, :7])


def _frob_apply_np(a, k: int):
    m = np.array(_frob_int_matrix(k), dtype=np.uint64)  # m[i][j]
    P = np.uint64(f.P)
    return (a[:, :, None] * m[None, :, :] % P).sum(axis=1) % P


def _pow_np(a, e: int):
    r = np.zeros_like(a)
    r[:, 0] = 1
    base = a.copy()
    while e:
        if e & 1:
            r = _poly_mulmod_np(r, base)
        e >>= 1
        if e:
            base = _poly_mulmod_np(base, base)
    return r


def _modpow_np(a, e: int):
    """(n,) u64 scalar modpow with fixed exponent."""
    P = np.uint64(f.P)
    r = np.ones_like(a)
    base = a.copy()
    while e:
        if e & 1:
            r = r * base % P
        e >>= 1
        if e:
            base = base * base % P
    return r


def sqrt_batch(x):
    """Vectorized septic sqrt: (n, 7) u64 -> (y (n, 7), ok (n,) bool).

    Mirrors sqrt_int; rows that are not squares get ok=False (y undefined).
    """
    P = np.uint64(f.P)
    n_rows = x.shape[0]
    base_ = _poly_mulmod_np(_frob_apply_np(x, 1), _frob_apply_np(x, 2))
    base_p2 = _frob_apply_np(base_, 2)
    base_p4 = _frob_apply_np(base_p2, 2)
    pow_r = _poly_mulmod_np(_poly_mulmod_np(_poly_mulmod_np(base_, base_p2), base_p4), x)
    numerator = pow_r[:, 0]
    ok = _modpow_np(np.maximum(numerator, np.uint64(1)), (f.P - 1) // 2) == 1
    n_power = _pow_np(x, (f.P + 1) // 2)
    nf = _frob_apply_np(n_power, 1)
    denominator = nf
    nf = _frob_apply_np(nf, 2)
    denominator = _poly_mulmod_np(denominator, nf)
    nf = _frob_apply_np(nf, 2)
    denominator = _poly_mulmod_np(denominator, nf)
    denominator = _poly_mulmod_np(denominator, x)
    # Cipolla sqrt of 1/numerator in F_p (batched; per-row nonresidue search)
    base_fp = _modpow_np(np.maximum(numerator, np.uint64(1)), f.P - 2)
    a = np.ones(n_rows, dtype=np.uint64)
    nonres = (np.uint64(1) + P - base_fp) % P
    g = np.uint64(f.GENERATOR)
    for _ in range(64):
        is_res = _modpow_np(np.maximum(nonres, np.uint64(1)), (f.P - 1) // 2) == 1
        is_res &= nonres != 0
        if not is_res.any():
            break
        a = np.where(is_res, a * g % P, a)
        nonres = np.where(is_res, (a * a % P + P - base_fp) % P, nonres)
    else:
        raise ValueError("nonresidue search did not converge")
    e = (f.P + 1) // 2
    xr, xi = a.copy(), np.ones(n_rows, dtype=np.uint64)
    rr, ri = np.ones(n_rows, dtype=np.uint64), np.zeros(n_rows, dtype=np.uint64)
    while e:
        if e & 1:
            rr, ri = (rr * xr % P + ri * xi % P * nonres) % P, (rr * xi + ri * xr) % P
        e >>= 1
        if e:
            xr, xi = (xr * xr % P + xi * xi % P * nonres) % P, np.uint64(2) * xr % P * xi % P
    y = denominator * rr[:, None] % P
    # special cases: sqrt(0) = 0, sqrt(1) = 1
    is_zero = (x == 0).all(axis=1)
    is_one = (x[:, 0] == 1) & (x[:, 1:] == 0).all(axis=1)
    y[is_zero] = 0
    y[is_one] = 0
    y[is_one, 0] = 1
    ok |= is_zero | is_one
    return y, ok


def lift_x_batch(m):
    """Vectorized lift_x_int: (n, 7) canonical -> (x, y, offset) arrays.

    y is in the 'receive' range (y[6] <= (p-1)/2), offsets u8."""
    m = np.asarray(m, dtype=np.uint64)
    n_rows = m.shape[0]
    P = np.uint64(f.P)
    half = np.uint64((f.P - 1) // 2)
    x_out = np.zeros((n_rows, 7), dtype=np.uint64)
    y_out = np.zeros((n_rows, 7), dtype=np.uint64)
    off_out = np.zeros(n_rows, dtype=np.uint32)
    active = np.ones(n_rows, dtype=bool)
    for offset in range(256):
        if not active.any():
            break
        idx = np.nonzero(active)[0]
        x = m[idx].copy()
        x[:, 6] = (x[:, 6] * np.uint64(256) + np.uint64(offset)) % P
        x2 = _poly_mulmod_np(x, x)
        y_sq = _poly_mulmod_np(x2, x)
        # + 3z*x - 3  (curve y^2 = x^3 + 3z*x - 3; see _curve_formula_int)
        three = np.uint64(3)
        shifted = np.zeros_like(x)
        shifted[:, 1:] = x[:, :6]
        z7 = x[:, 6] * three % P  # z * x6 z^6 -> z^7 = 8 - 2z
        y_sq = (y_sq + shifted * three) % P
        y_sq[:, 0] = (y_sq[:, 0] + np.uint64(8) * z7) % P
        y_sq[:, 1] = (y_sq[:, 1] + (P - z7) % P * np.uint64(2)) % P
        y_sq[:, 0] = (y_sq[:, 0] + P - three) % P
        y, ok = sqrt_batch(y_sq)
        ok &= y[:, 6] != 0
        took = idx[ok]
        if took.size:
            yk = y[ok]
            flip = yk[:, 6] > half
            yk[flip] = (P - yk[flip]) % P
            x_out[took] = x[ok]
            y_out[took] = yk
            off_out[took] = offset
            active[took] = False
    if active.any():
        raise ValueError("no curve point found in 256 offsets")
    return x_out, y_out, off_out


# ---------------------------------------------------------------------------
# Batched running sum of curve points (canonical u64), for the Global chip's
# cumulative digest column.  The serial Python-int chain costs about 0.5 ms
# a point (one F_{p^7} inversion each); here the points are cut into blocks
# of about sqrt(n), the sums within the blocks advance all blocks at once,
# the block totals are chained serially, and each block's offset is added to
# its sums in one batch.  Group addition is associative and affine
# coordinates are unique, so the sums equal the serial chain's, as long as
# no addition on either route meets equal x coordinates (a doubling or the
# point at infinity): then None is returned and the caller runs the chain.
# ---------------------------------------------------------------------------


def _inv7_np(a):
    """(n, 7) canonical u64 -> inverses (zero rows give zero), as _inv_int7."""
    P = np.uint64(f.P)
    b = _frob_apply_np(a, 1)
    for k in range(2, 7):
        b = _poly_mulmod_np(b, _frob_apply_np(a, k))
    ninv = _modpow_np(_poly_mulmod_np(a, b)[:, 0], f.P - 2)
    return b * ninv[:, None] % P


def curve_add_batch(x1, y1, x2, y2):
    """Incomplete addition of (n, 7) canonical u64 points, as curve_add_int;
    also returns which rows had distinct x coordinates (the formula holds)."""
    P = np.uint64(f.P)
    dx = (x2 + P - x1) % P
    dy = (y2 + P - y1) % P
    slope = _poly_mulmod_np(dy, _inv7_np(dx))
    x3 = (_poly_mulmod_np(slope, slope) + (P - x1) + (P - x2)) % P
    y3 = (_poly_mulmod_np(slope, (x1 + P - x3) % P) + P - y1) % P
    return x3, y3, dx.any(axis=1)


def curve_prefix_sums(start, xs, ys):
    """Running sums start + P_0 + ... + P_i of the (n, 7) canonical points
    (xs, ys), as (n, 7) u64 arrays (x, y); None if some addition of the
    serial chain or of this route meets equal x coordinates."""
    xs = np.asarray(xs, dtype=np.uint64)
    ys = np.asarray(ys, dtype=np.uint64)
    n = xs.shape[0]
    block = max(1, int(np.sqrt(n)))
    starts = np.arange(0, n, block)
    ends = np.minimum(starts + block, n)
    # sums within each block
    sx, sy = xs.copy(), ys.copy()
    ax, ay = xs[starts].copy(), ys[starts].copy()
    for j in range(1, block):
        live = starts + j < ends
        if not live.any():
            break
        idx = starts[live] + j
        ax[live], ay[live], ok = curve_add_batch(ax[live], ay[live], xs[idx], ys[idx])
        if not ok.all():
            return None
        sx[idx], sy[idx] = ax[live], ay[live]
    # block offsets: start, then start plus each block's total, chained
    off = ([int(c) for c in start[0]], [int(c) for c in start[1]])
    offs_x = np.empty((len(starts), 7), dtype=np.uint64)
    offs_y = np.empty((len(starts), 7), dtype=np.uint64)
    for b, e in enumerate(ends):
        offs_x[b], offs_y[b] = off[0], off[1]
        total = ([int(c) for c in sx[e - 1]], [int(c) for c in sy[e - 1]])
        if off[0] == total[0]:
            return None
        off = curve_add_int(off, total)
    rep = np.repeat(np.arange(len(starts)), ends - starts)
    cx, cy, ok = curve_add_batch(offs_x[rep], offs_y[rep], sx, sy)
    if not ok.all():
        return None
    # the serial chain adds P_i to the sum before it: its x must differ
    prev_x = np.concatenate([np.asarray([start[0]], dtype=np.uint64), cx[:-1]])
    if not (prev_x != xs).any(axis=1).all():
        return None
    return cx, cy
