"""BN254 (alt_bn128) curve arithmetic and optimal ate pairing.

Host-side Python-int implementation backing the Groth16/PLONK wrap stage —
the analog of the reference's gnark-crypto dependency
(crates/recursion/gnark-ffi/go: consensys/gnark proves the wrap circuit over
this curve).  The SNARK layer proves/verifies once per wrapped program, so
clarity beats speed; hot paths (MSM) are windowed but still bigint-based.

Curve: y^2 = x^3 + 3 over Fp; G2 over Fp2 = Fp[u]/(u^2+1) with twist
y^2 = x^3 + 3/(9+u); BN parameter t = 4965661367192848881.
Tower: Fp2 -> Fp6 = Fp2[v]/(v^3 - (9+u)) -> Fp12 = Fp6[w]/(w^2 - v).
"""

from __future__ import annotations

# Base field and scalar field moduli.
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

BN_T = 4965661367192848881  # BN parameter x
ATE_LOOP_COUNT = 6 * BN_T + 2


# ---------------------------------------------------------------------------
# Fp2 / Fp6 / Fp12 tower (tuples of ints; immutable, hashable)
# ---------------------------------------------------------------------------


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, P - 2, P)
    return (a[0] * d % P, (-a[1]) * d % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # 9 + u, the sextic twist constant


def f2_mul_xi(a):
    """a * (9 + u)."""
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


# Fp6 elements: (c0, c1, c2) with each ci in Fp2; v^3 = XI.


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_v(a):
    """a * v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    t0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    d = f2_add(f2_mul(a0, t0), f2_mul_xi(f2_add(f2_mul(a2, t1), f2_mul(a1, t2))))
    di = f2_inv(d)
    return (f2_mul(t0, di), f2_mul(t1, di), f2_mul(t2, di))


# Fp12 elements: (c0, c1) with each ci in Fp6; w^2 = v.


F12_ONE = (F6_ONE, F6_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_inv(a):
    a0, a1 = a
    d = f6_sub(f6_sqr(a0), f6_mul_v(f6_sqr(a1)))
    di = f6_inv(d)
    return (f6_mul(a0, di), f6_neg(f6_mul(a1, di)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_pow(a, e: int):
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sqr(base)
        e >>= 1
    return out


# Frobenius coefficients: gamma1[i] = XI^((P-1) * i / 6) for i in 0..5.
_G1 = [pow_xi := None]  # placeholder replaced below


def _f2_pow(a, e: int):
    out = F2_ONE
    base = a
    while e:
        if e & 1:
            out = f2_mul(out, base)
        base = f2_sqr(base)
        e >>= 1
    return out


_FROB_GAMMA1 = [_f2_pow(XI, (P - 1) * i // 6) for i in range(6)]
_FROB_GAMMA2 = [f2_mul(g, f2_conj(g)) for g in _FROB_GAMMA1]  # norms: XI^((p^2-1)i/6)
_FROB_GAMMA3 = [f2_mul(g, h) for g, h in zip(_FROB_GAMMA1, _FROB_GAMMA2)]


def _f6_frob(a, power: int):
    """Frobenius (x -> x^(p^power)) on Fp6, power in {1, 2, 3}."""
    g = {1: _FROB_GAMMA1, 2: _FROB_GAMMA2, 3: _FROB_GAMMA3}[power]
    conj = power % 2 == 1
    c0, c1, c2 = a
    if conj:
        c0, c1, c2 = f2_conj(c0), f2_conj(c1), f2_conj(c2)
    return (c0, f2_mul(c1, g[2]), f2_mul(c2, g[4]))


def f12_frob(a, power: int = 1):
    g = {1: _FROB_GAMMA1, 2: _FROB_GAMMA2, 3: _FROB_GAMMA3}[power]
    c0 = _f6_frob(a[0], power)
    c1 = _f6_frob(a[1], power)
    c1 = tuple(f2_mul(x, g[1]) for x in c1)
    return (c0, c1)


# ---------------------------------------------------------------------------
# G1 (affine/Jacobian over Fp) and G2 (over Fp2)
# ---------------------------------------------------------------------------

G1_GEN = (1, 2)
# Standard BN254 G2 generator (EIP-197 ordering: x = x0 + x1*u).
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_neg(p1):
    return None if p1 is None else (p1[0], (-p1[1]) % P)


def g1_mul(p1, k: int):
    k %= R
    out = None
    base = p1
    while k:
        if k & 1:
            out = g1_add(out, base)
        base = g1_add(base, base)
        k >>= 1
    return out


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sqr(lam), f2_add(x1, x2))
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_neg(p1):
    return None if p1 is None else (p1[0], f2_neg(p1[1]))


def g2_mul(p1, k: int):
    k %= R
    out = None
    base = p1
    while k:
        if k & 1:
            out = g2_add(out, base)
        base = g2_add(base, base)
        k >>= 1
    return out


def g1_is_on_curve(p1) -> bool:
    if p1 is None:
        return True
    x, y = p1
    return (y * y - x * x * x - 3) % P == 0


def g2_is_on_curve(p2) -> bool:
    if p2 is None:
        return True
    x, y = p2
    b = f2_mul((3, 0), f2_inv(XI))
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), b)) == F2_ZERO


# ---------------------------------------------------------------------------
# Optimal ate pairing
# ---------------------------------------------------------------------------


def _line(q1, q2, p1):
    """Line through q1, q2 (G2, twisted coords) evaluated at p1 (G1) as Fp12.

    Uses the D-twist embedding: G2 points (x, y) map to (x w^2, y w^3) in
    Fp12; the line l = y_p - lam * x_p * w ... assembled sparse below.
    """
    x1, y1 = q1
    x2, y2 = q2
    xp, yp = p1
    if x1 == x2 and f2_add(y1, y2) == F2_ZERO:
        # vertical line: x_Q - x_P  ->  x1 * w^2 coords
        c0 = (f2_scalar((xp, 0), 1), F2_ZERO, f2_neg(x1))
        return (c0, F6_ZERO)
    if x1 == x2:
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    # l(P) = yp - y1 w^3 - lam (xp - x1 w^2) w   (w-degrees: 0, 1, 3)
    # Fp12 = c0 + c1 w with c_i in Fp6 over v = w^2:
    #   deg 0 -> c0[0]; deg 1 -> c1[0]; deg 2 -> c0[1]; deg 3 -> c1[1] ...
    c0 = ((yp % P, 0), F2_ZERO, F2_ZERO)
    c1 = (f2_neg(f2_scalar(lam, xp)), f2_sub(f2_mul(lam, x1), y1), F2_ZERO)
    return (c0, c1)


def miller_loop(q2, p1):
    """f_{6t+2, Q}(P) with the two frobenius line corrections (optimal ate)."""
    if q2 is None or p1 is None:
        return F12_ONE
    f = F12_ONE
    t = q2
    naf = bin(ATE_LOOP_COUNT)[3:]
    for bit in naf:
        f = f12_mul(f12_sqr(f), _line(t, t, p1))
        t = g2_add(t, t)
        if bit == "1":
            f = f12_mul(f, _line(t, q2, p1))
            t = g2_add(t, q2)
    # frobenius corrections: Q1 = pi(Q), Q2 = -pi^2(Q)
    q1f = (f2_mul(f2_conj(q2[0]), _FROB_GAMMA1[2]), f2_mul(f2_conj(q2[1]), _FROB_GAMMA1[3]))
    q2f = (f2_mul(q2[0], _FROB_GAMMA2[2]), f2_neg(f2_mul(q2[1], _FROB_GAMMA2[3])))
    f = f12_mul(f, _line(t, q1f, p1))
    t = g2_add(t, q1f)
    f = f12_mul(f, _line(t, q2f, p1))
    return f


def final_exponentiation(f):
    """f^((p^12 - 1) / r)."""
    # easy part: f^(p^6 - 1) * then ^(p^2 + 1)
    f1 = f12_mul(f12_conj(f), f12_inv(f))
    f2 = f12_mul(f12_frob(f1, 2), f1)
    # hard part (exponent (p^4 - p^2 + 1)/r), done by plain pow for clarity;
    # cost is irrelevant at wrap frequency
    e = (P**4 - P**2 + 1) // R
    return f12_pow(f2, e)


def pairing(p1, q2):
    """e(P, Q) in Fp12 (P in G1, Q in G2)."""
    return final_exponentiation(miller_loop(q2, p1))


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, sharing one final exponentiation."""
    acc = F12_ONE
    for p1, q2 in pairs:
        acc = f12_mul(acc, miller_loop(q2, p1))
    return final_exponentiation(acc) == F12_ONE


# ---------------------------------------------------------------------------
# Multi-scalar multiplication (windowed, per-point; n is small for the vk,
# large for the prover key — Pippenger bucketing)
# ---------------------------------------------------------------------------


def g1_msm(points, scalars):
    return _msm(points, scalars, g1_add, None)


def g2_msm(points, scalars):
    return _msm(points, scalars, g2_add, None)


def _msm(points, scalars, add, zero, window: int = 8):
    pairs = [(pt, s % R) for pt, s in zip(points, scalars) if pt is not None and s % R]
    if not pairs:
        return zero
    nbits = max(s.bit_length() for _, s in pairs)
    acc = zero
    for top in range(((nbits + window - 1) // window) * window - window, -1, -window):
        if acc is not zero:
            for _ in range(window):
                acc = add(acc, acc)
        buckets = {}
        for pt, s in pairs:
            b = (s >> top) & ((1 << window) - 1)
            if b:
                buckets[b] = add(buckets.get(b), pt) if b in buckets else pt
        run, total = zero, zero
        for b in range(max(buckets, default=0), 0, -1):
            if b in buckets:
                run = add(run, buckets[b])
            total = add(total, run)
        acc = add(acc, total)
    return acc
