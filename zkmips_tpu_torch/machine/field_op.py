"""Byte-limb modular arithmetic gadget for precompile chips.

The analog of the reference's FieldOpCols machinery (crates/core/machine/src/
operations/field/, generic over crates/curves params.rs:29-81): big integers
are split into 8-bit limbs (16-bit limbs would overflow the 31-bit KoalaBear
field in limb-product sums), and the congruence

    sum(pos_terms) - sum(neg_terms)  ==  0   (mod modulus)

is enforced as the polynomial identity

    E(x) = POS(x) + extra_p * P(x) - NEG(x) - Q(x) * P(x) = (x - 256) * W(x)

checked coefficient-wise with a witnessed quotient Q (byte limbs) and an
offset-encoded carry polynomial W.

Soundness of the coefficient equations over KoalaBear: every limb is
range-checked, so |E_t| <= (#product terms) * max_len * 255^2 < 2^23 as an
integer; the carry bound |W_t| <= max|E| / (beta - 1) < 2^16 follows from
W_t = -(sum_{j<=t} E_j beta^j) / beta^{t+1}, so W limbs are encoded as
w + 2^16 in 17 bits (u16 + one boolean high bit) and both sides of
E_t = W_{t-1} - beta*W_t stay below p = 2^31 - 2^24 + 1 in magnitude, making
the field equations integer equations.

Terms are coefficient-expr lists; products of two byte-limb polynomials are
formed with :func:`poly_mul`.  Chained ops keep every intermediate value in
(range-checked) byte-limb form, exactly like the reference chips.
"""

from __future__ import annotations

import numpy as np

from .gadgets import send_u16_check, send_u8_pair

BETA = 256
W_OFFSET = 1 << 16  # carry limbs live in (-2^16, 2^16); encoded +offset in 17 bits


# --------------------------------------------------------------------- polys


def int_to_limbs(v: int, k: int) -> list:
    return [(v >> (8 * i)) & 0xFF for i in range(k)]


def limbs_to_int(limbs) -> int:
    return sum(int(l) << (8 * i) for i, l in enumerate(limbs))


def poly_mul(a: list, b: list) -> list:
    """Coefficient lists (exprs or ints) -> product coefficient list."""
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if isinstance(ai, int) and ai == 0:
            continue
        for j, bj in enumerate(b):
            if isinstance(bj, int) and bj == 0:
                continue
            t = ai * bj
            out[i + j] = t if isinstance(out[i + j], int) and out[i + j] == 0 else out[i + j] + t
    return out


def poly_addl(*polys) -> list:
    out = [0] * max(len(p) for p in polys)
    for p in polys:
        for i, c in enumerate(p):
            if isinstance(c, int) and c == 0:
                continue
            out[i] = c if isinstance(out[i], int) and out[i] == 0 else out[i] + c
    return out


def modulus_limbs(modulus: int) -> list:
    return int_to_limbs(modulus, (modulus.bit_length() + 7) // 8)


# ------------------------------------------------------------------- spec


class FopSpec:
    """One gadget instance: fixes limb counts so the schema, the AIR and the
    trace filler agree structurally (zero top limbs included)."""

    def __init__(self, prefix: str, k: int, modulus: int, pos_shapes, neg_shapes,
                 q_count: int | None = None, extra_p: int = 0, with_result: bool = True):
        self.prefix = prefix
        self.k = k
        self.modulus = modulus
        self.q_count = (k + 1) if q_count is None else q_count
        self.extra_p = extra_p
        self.with_result = with_result
        p_len = len(modulus_limbs(modulus))
        lens = list(pos_shapes) + list(neg_shapes) + [self.q_count + p_len - 1]
        if with_result:
            lens.append(k)
        if extra_p:
            lens.append(p_len)
        self.deg_e = max(lens) - 1

    def names(self) -> list:
        n = []
        if self.with_result:
            n += [f"{self.prefix}_r{i}" for i in range(self.k)]
        n += [f"{self.prefix}_q{i}" for i in range(self.q_count)]
        n += [f"{self.prefix}_wl{i}" for i in range(self.deg_e)]
        n += [f"{self.prefix}_wh{i}" for i in range(self.deg_e)]
        return n

    # ----------------------------------------------------------- AIR side

    def eval(self, builder, col, pos_terms, neg_terms, mult):
        """Emit constraints; returns result limb exprs (None if no result)."""
        pf = self.prefix
        r = None
        neg_terms = list(neg_terms)
        if self.with_result:
            r = [col(f"{pf}_r{i}") for i in range(self.k)]
            neg_terms.append(r)
        q = [col(f"{pf}_q{i}") for i in range(self.q_count)]
        p_l = modulus_limbs(self.modulus)
        qp = poly_mul(q, p_l)
        pos_all = list(pos_terms)
        if self.extra_p:
            pos_all.append([self.extra_p * c for c in p_l])
        pos_poly = poly_addl(*pos_all)
        neg_poly = poly_addl(*(neg_terms + [qp]))
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
        # E_t == W_{t-1} - beta * W_t   (W_{-1} = W_{deg_e} = 0)
        for t in range(n):
            rhs = 0
            if t - 1 >= 0:
                rhs = w[t - 1]
            if t < self.deg_e:
                rhs = rhs - BETA * w[t]
            builder.when(mult).assert_eq(e[t], rhs)
        _u8_pairs(builder, col, pf, "q", self.q_count, mult)
        if self.with_result:
            _u8_pairs(builder, col, pf, "r", self.k, mult)
        return r

    # --------------------------------------------------------- trace side

    def populate(self, trace, s, row, pos_ints, neg_ints, sink, result: int | None = None):
        """Fill from integer coefficient lists mirroring the eval() terms
        (excluding the gadget's own result, supplied via ``result``)."""
        pf, modulus = self.prefix, self.modulus

        def val(terms):
            return sum(sum(int(c) << (8 * i) for i, c in enumerate(t)) for t in terms)

        neg_ints = list(neg_ints)
        if self.with_result:
            assert result is not None
            r_l = int_to_limbs(result, self.k)
            assert limbs_to_int(r_l) == result, "result exceeds limb budget"
            neg_ints.append(r_l)
            for i, c in enumerate(r_l):
                trace[row, s.idx(f"{pf}_r{i}")] = c
            _sink_u8(sink, r_l)
        total = val(pos_ints) + self.extra_p * modulus - val(neg_ints)
        assert total % modulus == 0, "field op congruence does not hold"
        q = total // modulus
        assert q >= 0, "negative quotient: raise extra_p"
        q_l = int_to_limbs(q, self.q_count)
        assert limbs_to_int(q_l) == q, "quotient exceeds its limb budget"
        for i, c in enumerate(q_l):
            trace[row, s.idx(f"{pf}_q{i}")] = c
        _sink_u8(sink, q_l)

        p_l = modulus_limbs(modulus)
        coeffs = [0] * (self.deg_e + 1)

        def acc(terms, sign):
            for t in terms:
                for i, c in enumerate(t):
                    coeffs[i] += sign * int(c)

        acc(pos_ints, 1)
        if self.extra_p:
            acc([[self.extra_p * c for c in p_l]], 1)
        acc(neg_ints, -1)
        acc([list(np.convolve(np.array(q_l, dtype=object), np.array(p_l, dtype=object)))], -1)
        # synthetic division from the top: W_{t-1} = E_t + beta * W_t
        w = [0] * self.deg_e
        carry = 0
        for t in range(self.deg_e, 0, -1):
            carry = coeffs[t] + BETA * carry
            w[t - 1] = carry
        assert coeffs[0] == (-BETA * w[0] if self.deg_e else 0), "division remainder"
        wl_list = []
        for t, wt in enumerate(w):
            enc = wt + W_OFFSET
            assert 0 <= enc < (1 << 17), f"carry limb out of range: {wt}"
            trace[row, s.idx(f"{pf}_wl{t}")] = enc & 0xFFFF
            trace[row, s.idx(f"{pf}_wh{t}")] = enc >> 16
            wl_list.append(enc & 0xFFFF)
        if wl_list:
            sink.u16(np.asarray(wl_list, dtype=np.uint32))
        return result


def _u8_pairs(builder, col, prefix, tag, count, mult):
    for i in range(0, count, 2):
        send_u8_pair(builder, col(f"{prefix}_{tag}{i}"),
                     col(f"{prefix}_{tag}{i + 1}") if i + 1 < count else 0, mult)


def _sink_u8(sink, limbs):
    arr = np.asarray([int(x) for x in limbs], dtype=np.uint32)
    if len(arr) % 2:
        arr = np.concatenate([arr, np.zeros(1, dtype=np.uint32)])
    sink.u8pair(arr[0::2], arr[1::2])


def set_limbs(trace, s, row, prefix, value: int, k: int):
    for i, c in enumerate(int_to_limbs(value, k)):
        trace[row, s.idx(f"{prefix}{i}")] = c
