"""PLONK zkSNARK over BN254 (KZG commitments) for R1CS instances.

The analog of gnark's ``plonk.{Setup,Prove,Verify}`` used by the reference's
PLONK wrap mode (crates/recursion/gnark-ffi/go/main.go:42-120,
src/plonk_bn254.rs).  Like gnark, the R1CS circuit is first converted into a
plonkish ("sparse R1CS") gate system

    qL*a + qR*b + qO*c + qM*a*b + qC = 0

by chaining each rank-1 row's linear combinations through addition gates and
closing with one multiplication gate; copy constraints arise from wires that
reference the same witness value.  The protocol is vanilla PLONK [GWC19,
final protocol]: three wire polynomials, one permutation accumulator,
quotient split in three, linearization, two KZG opening proofs.

The SRS is generated from fresh randomness per circuit (dev-mode setup, like
the reference's ZKM_DEV local circuit builds; a deployment would use a
ceremony transcript).  The transcript is SHA-256 based and is this
implementation's own: proofs are not byte-compatible with gnark's.

Every draw goes through ``rng``, a callable ``randbelow(n)`` that defaults to
``secrets.randbelow`` (setup: tau; prove: eleven blinding scalars), in the
reference's order, so equal draws give the reference's keys and proofs.

Two pipelines share the gate system, the transcript and the verifier: the
packed one (``setup``; polynomials as (n, 4) u64 Montgomery arrays through
``csrc/bn254.c``'s vectorized Fr ops), which the port proves with, and the
int-list one (``setup_python``), its plain version.  ``prove`` dispatches on
the proving key's representation.  Both commit through the native MSM.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

import numpy as np

from . import bn254_curve as ec, native as nv
from .groth16 import G1Vec, _domain_root, _fft, _g1_mul_batch
from .r1cs import ConstraintSystem, R

K1 = 5  # coset factors: 5 generates Fr^*, so 5^n != 1 for any domain size n
K2 = 25


# ---------------------------------------------------------------------------
# Plonkish gate system (gnark's SparseR1CS analog)
# ---------------------------------------------------------------------------


@dataclass
class GateSystem:
    ql: list
    qr: list
    qo: list
    qm: list
    qc: list
    wa: list  # per gate: witness index feeding wire a
    wb: list
    wc: list
    values: list  # witness values (index 0 is the constant 1)
    num_public: int  # public gates occupy rows 0..num_public-1

    @property
    def num_gates(self) -> int:
        return len(self.ql)

    def is_satisfied(self) -> bool:
        v = self.values
        for i in range(self.num_gates):
            a, b, c = v[self.wa[i]], v[self.wb[i]], v[self.wc[i]]
            pi = -v[self.wa[i]] if i < self.num_public else 0
            if (self.ql[i] * a + self.qr[i] * b + self.qo[i] * c
                    + self.qm[i] * a * b + self.qc[i] + pi) % R != 0:
                return False
        return True


def gates_from_r1cs(cs: ConstraintSystem) -> GateSystem:
    """Convert A.w * B.w = C.w rows into plonkish gates (gnark ToSparseR1CS)."""
    g = GateSystem([], [], [], [], [], [], [], [], list(cs.values), cs.num_public)

    def new_aux(value: int) -> int:
        g.values.append(value % R)
        return len(g.values) - 1

    def gate(ql, qr, qo, qm, qc, wa, wb, wc):
        g.ql.append(ql % R)
        g.qr.append(qr % R)
        g.qo.append(qo % R)
        g.qm.append(qm % R)
        g.qc.append(qc % R)
        g.wa.append(wa)
        g.wb.append(wb)
        g.wc.append(wc)

    # public-input rows first: qL*a + PI = 0 with PI_i = -public_i
    for i in range(cs.num_public):
        gate(1, 0, 0, 0, 0, 1 + i, 0, 0)

    def lc_to_wire(lc: dict) -> tuple[int | None, int]:
        """Reduce a linear combination to (wire index or None, constant)."""
        const = lc.get(0, 0) % R
        terms = [(i, c % R) for i, c in lc.items() if i != 0 and c % R != 0]
        if not terms:
            return None, const
        if len(terms) == 1 and terms[0][1] == 1:
            return terms[0][0], const
        acc_idx, acc_coeff = terms[0]
        acc_val = g.values[acc_idx] * acc_coeff % R
        if len(terms) == 1:
            out = new_aux(acc_val)
            gate(acc_coeff, 0, -1, 0, 0, acc_idx, 0, out)
            return out, const
        first = True
        for idx, coeff in terms[1:]:
            val = (acc_val + g.values[idx] * coeff) % R
            out = new_aux(val)
            if first:
                gate(acc_coeff, coeff, -1, 0, 0, acc_idx, idx, out)
                first = False
            else:
                gate(1, coeff, -1, 0, 0, acc_idx, idx, out)
            acc_idx, acc_val = out, val
        return acc_idx, const

    for A, B, C in cs.constraints:
        u, cu = lc_to_wire(A)
        v, cv = lc_to_wire(B)
        t, ct = lc_to_wire(C)
        if u is None and v is None:
            # constant * constant = C
            if t is None:
                assert cu * cv % R == ct % R, "unsatisfiable constant constraint"
                continue
            gate(0, 0, -1, 0, cu * cv - ct, 0, 0, t)
        elif u is None:
            # cu * (v + cv) = t + ct
            tw = t if t is not None else 0
            gate(0, cu, -1 if t is not None else 0, 0, cu * cv - ct, 0, v, tw)
        elif v is None:
            tw = t if t is not None else 0
            gate(cv, 0, -1 if t is not None else 0, 0, cu * cv - ct, u, 0, tw)
        else:
            tw = t if t is not None else 0
            gate(cv, cu, -1 if t is not None else 0, 1, cu * cv - ct, u, v, tw)
    return g


# ---------------------------------------------------------------------------
# Polynomial helpers (coefficient lists over Fr)
# ---------------------------------------------------------------------------


def _poly_eval(coeffs: list, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def _poly_add(a: list, b: list) -> list:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % R for i in range(n)]


def _poly_scale(a: list, k: int) -> list:
    return [c * k % R for c in a]


def _mul_zh(a: list, n: int) -> list:
    """a(X) * (X^n - 1)."""
    out = [0] * (len(a) + n)
    for i, c in enumerate(a):
        out[i + n] = c
        out[i] = (out[i] - c) % R
    return out


def _div_linear(a: list, zeta: int) -> list:
    """a(X) / (X - zeta); remainder must be 0."""
    out = [0] * (len(a) - 1)
    acc = 0
    for i in range(len(a) - 1, 0, -1):
        acc = (acc + a[i]) % R
        out[i - 1] = acc
        acc = acc * zeta % R
    assert (acc + a[0]) % R == 0, "division by (X - zeta) leaves a remainder"
    return out


def _interp(evals: list, log_n: int) -> list:
    return _fft(list(evals), _domain_root(log_n), inverse=True)


def _coset_evals(coeffs: list, log_big: int, shift: int) -> list:
    """Evaluate coeffs on shift * <w_{2^log_big}> (natural order)."""
    big = 1 << log_big
    assert len(coeffs) <= big
    sp = 1
    scaled = []
    for c in coeffs:
        scaled.append(c * sp % R)
        sp = sp * shift % R
    scaled += [0] * (big - len(scaled))
    return _fft(scaled, _domain_root(log_big))


def _coset_interp(evals: list, log_big: int, shift: int) -> list:
    coeffs = _fft(list(evals), _domain_root(log_big), inverse=True)
    inv_s = pow(shift, R - 2, R)
    sp = 1
    out = []
    for c in coeffs:
        out.append(c * sp % R)
        sp = sp * inv_s % R
    return out


# ---------------------------------------------------------------------------
# Transcript
# ---------------------------------------------------------------------------


class _Transcript:
    def __init__(self):
        self._h = hashlib.sha256(b"zkmips-plonk-bn254")

    def absorb_point(self, p):
        if p is None:
            self._h.update(b"\x00" * 64)
        else:
            self._h.update(int(p[0]).to_bytes(32, "big") + int(p[1]).to_bytes(32, "big"))

    def absorb_scalar(self, x: int):
        self._h.update(int(x % R).to_bytes(32, "big"))

    def challenge(self, label: bytes) -> int:
        self._h.update(label)
        out = int.from_bytes(self._h.digest(), "big") % R
        self._h.update(self._h.digest())
        return out


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


@dataclass
class PlonkVerifyingKey:
    n: int
    num_public: int
    qm_c: tuple
    ql_c: tuple
    qr_c: tuple
    qo_c: tuple
    qc_c: tuple
    s1_c: tuple
    s2_c: tuple
    s3_c: tuple
    x2: tuple  # [tau]_2


@dataclass
class PlonkProvingKey:
    vk: PlonkVerifyingKey
    srs: G1Vec  # [tau^i]_1, len n + 6
    ql: list
    qr: list
    qo: list
    qm: list
    qc: list
    s1: list
    s2: list
    s3: list
    sigma_slots: list  # permuted slot ids per column, length 3n (for z build)
    perm_gates: GateSystem


def _build_permutation(g: GateSystem, n: int):
    """sigma over the 3n wire slots: rotate each witness value's slot cycle.

    Returns (sigma value vectors per column over H, raw slot-id vectors).
    Slot id of (col, row) = k_col * w^row with k = (1, K1, K2).
    """
    log_n = n.bit_length() - 1
    w = _domain_root(log_n)
    ids = [[0] * n for _ in range(3)]
    x = 1
    for row in range(n):
        ids[0][row] = x
        ids[1][row] = K1 * x % R
        ids[2][row] = K2 * x % R
        x = x * w % R

    wires = [g.wa, g.wb, g.wc]
    cycles: dict[int, list] = {}
    for col in range(3):
        for row in range(n):
            widx = wires[col][row] if row < g.num_gates else 0
            cycles.setdefault(widx, []).append((col, row))
    sigma = [[0] * n for _ in range(3)]
    for slots in cycles.values():
        m = len(slots)
        for i, (col, row) in enumerate(slots):
            ncol, nrow = slots[(i + 1) % m]
            sigma[col][row] = ids[ncol][nrow]
    return sigma, ids


def _domain_size(g: GateSystem) -> int:
    """The gate domain: a power of two holding every gate, and at least 8.
    The quotient t(X) has degree up to 3n + 5 and is interpolated from the
    4n points of its coset, so n must be at least 6; the reference's floor
    of 4 fails its own linearization check on circuits of four gates."""
    return 1 << max(3, (g.num_gates - 1).bit_length())


def setup_python(g: GateSystem, rng=None):
    """The int-list setup (the plain version of :func:`setup`)."""
    n = _domain_size(g)
    log_n = n.bit_length() - 1

    def padded(q):
        return list(q) + [0] * (n - len(q))

    ql_e, qr_e, qo_e, qm_e, qc_e = (padded(q) for q in (g.ql, g.qr, g.qo, g.qm, g.qc))
    ql, qr, qo, qm, qc = (_interp(e, log_n) for e in (ql_e, qr_e, qo_e, qm_e, qc_e))
    sigma, _ids = _build_permutation(g, n)
    s1, s2, s3 = (_interp(sig, log_n) for sig in sigma)

    tau = (rng or secrets.randbelow)(R - 2) + 2
    powers = []
    acc = 1
    for _ in range(n + 6):
        powers.append(acc)
        acc = acc * tau % R
    srs = _g1_mul_batch(powers)

    def commit(coeffs):
        return _kzg_commit(srs, coeffs)

    vk = PlonkVerifyingKey(
        n=n,
        num_public=g.num_public,
        qm_c=commit(qm), ql_c=commit(ql), qr_c=commit(qr), qo_c=commit(qo), qc_c=commit(qc),
        s1_c=commit(s1), s2_c=commit(s2), s3_c=commit(s3),
        x2=ec.g2_mul(ec.G2_GEN, tau),
    )
    return PlonkProvingKey(vk, srs, ql, qr, qo, qm, qc, s1, s2, s3, sigma, g), vk


def _kzg_commit(srs: G1Vec, coeffs: list):
    coeffs = [c % R for c in coeffs]
    while coeffs and coeffs[-1] == 0:
        coeffs.pop()
    if not coeffs:
        return None  # point at infinity
    return srs.slice(0, len(coeffs)).msm(nv.pack_scalars(coeffs))


# ---------------------------------------------------------------------------
# Prove
# ---------------------------------------------------------------------------


@dataclass
class PlonkProof:
    a_c: tuple
    b_c: tuple
    c_c: tuple
    z_c: tuple
    tlo_c: tuple
    tmid_c: tuple
    thi_c: tuple
    wz_c: tuple
    wzw_c: tuple
    a_bar: int
    b_bar: int
    c_bar: int
    s1_bar: int
    s2_bar: int
    zw_bar: int


def prove(pk: PlonkProvingKey, g: GateSystem, rng=None) -> PlonkProof:
    """A PLONK proof of ``g``'s witness; ``rng`` draws the blinding."""
    if isinstance(pk.ql, np.ndarray):
        # packed-array keys come from setup; satisfaction is checked
        # upstream (the R1CS witness): the per-gate Python loop would cost
        # minutes at outer-circuit scale
        return _prove_native(pk, g, rng)
    assert g.is_satisfied(), "witness does not satisfy the gate system"
    n = pk.vk.n
    log_n = n.bit_length() - 1
    log_big = log_n + 2
    big = 1 << log_big
    w = _domain_root(log_n)
    shift = 7  # quotient coset shift; 7^n != 1 (7 is outside the 2-adic subgroup)

    v = g.values
    a_e = [v[g.wa[i]] if i < g.num_gates else v[0] for i in range(n)]
    b_e = [v[g.wb[i]] if i < g.num_gates else v[0] for i in range(n)]
    c_e = [v[g.wc[i]] if i < g.num_gates else v[0] for i in range(n)]
    pi_e = [(-v[g.wa[i]]) % R if i < g.num_public else 0 for i in range(n)]

    draw = rng or secrets.randbelow
    rnd = [draw(R) for _ in range(11)]
    a_p = _poly_add(_interp(a_e, log_n), _mul_zh([rnd[1], rnd[0]], n))
    b_p = _poly_add(_interp(b_e, log_n), _mul_zh([rnd[3], rnd[2]], n))
    c_p = _poly_add(_interp(c_e, log_n), _mul_zh([rnd[5], rnd[4]], n))
    pi_p = _interp(pi_e, log_n)

    ts = _Transcript()
    for q in (pk.vk.qm_c, pk.vk.ql_c, pk.vk.qr_c, pk.vk.qo_c, pk.vk.qc_c,
              pk.vk.s1_c, pk.vk.s2_c, pk.vk.s3_c):
        ts.absorb_point(q)
    for i in range(g.num_public):
        ts.absorb_scalar(v[1 + i])
    a_c, b_c, c_c = (_kzg_commit(pk.srs, p) for p in (a_p, b_p, c_p))
    ts.absorb_point(a_c)
    ts.absorb_point(b_c)
    ts.absorb_point(c_c)
    beta = ts.challenge(b"beta")
    gamma = ts.challenge(b"gamma")

    # permutation accumulator over H
    sigma = pk.sigma_slots
    z_e = [1]
    x = 1
    acc = 1
    for i in range(n - 1):
        num = (a_e[i] + beta * x + gamma) % R
        num = num * ((b_e[i] + beta * K1 * x + gamma) % R) % R
        num = num * ((c_e[i] + beta * K2 * x + gamma) % R) % R
        den = (a_e[i] + beta * sigma[0][i] + gamma) % R
        den = den * ((b_e[i] + beta * sigma[1][i] + gamma) % R) % R
        den = den * ((c_e[i] + beta * sigma[2][i] + gamma) % R) % R
        acc = acc * num % R * pow(den, R - 2, R) % R
        z_e.append(acc)
        x = x * w % R
    z_p = _poly_add(_interp(z_e, log_n), _mul_zh([rnd[8], rnd[7], rnd[6]], n))
    z_c = _kzg_commit(pk.srs, z_p)
    ts.absorb_point(z_c)
    alpha = ts.challenge(b"alpha")

    # quotient on the shift*<w_big> coset
    def ce(p):
        return _coset_evals(p, log_big, shift)

    a_b, b_b, c_b, z_b = ce(a_p), ce(b_p), ce(c_p), ce(z_p)
    ql_b, qr_b, qo_b, qm_b, qc_b = ce(pk.ql), ce(pk.qr), ce(pk.qo), ce(pk.qm), ce(pk.qc)
    s1_b, s2_b, s3_b, pi_b = ce(pk.s1), ce(pk.s2), ce(pk.s3), ce(pi_p)
    # z(w X) on the coset: rotate by big/n positions
    rot = big // n
    zw_b = z_b[rot:] + z_b[:rot]
    # Z_H on the coset cycles with period rot
    wbig = _domain_root(log_big)
    zh_cycle = []
    for i in range(rot):
        val = (pow(shift, n, R) * pow(wbig, n * i, R) - 1) % R
        zh_cycle.append(pow(val, R - 2, R))
    l1_b = ce(_interp([1] + [0] * (n - 1), log_n))

    t_b = []
    x = shift  # the i-th evaluation point is shift * w_big^i
    for i in range(big):
        gate = (qm_b[i] * a_b[i] % R * b_b[i] + ql_b[i] * a_b[i] + qr_b[i] * b_b[i]
                + qo_b[i] * c_b[i] + pi_b[i] + qc_b[i]) % R
        num = (a_b[i] + beta * x + gamma) % R
        num = num * ((b_b[i] + beta * K1 * x + gamma) % R) % R
        num = num * ((c_b[i] + beta * K2 * x + gamma) % R) % R
        den = (a_b[i] + beta * s1_b[i] + gamma) % R
        den = den * ((b_b[i] + beta * s2_b[i] + gamma) % R) % R
        den = den * ((c_b[i] + beta * s3_b[i] + gamma) % R) % R
        perm = (num * z_b[i] - den * zw_b[i]) % R
        start = (z_b[i] - 1) * l1_b[i] % R
        t_b.append((gate + alpha * perm + alpha * alpha % R * start) % R
                   * zh_cycle[i % rot] % R)
        x = x * wbig % R
    t_p = _coset_interp(t_b, log_big, shift)
    while t_p and t_p[-1] == 0:
        t_p.pop()
    assert len(t_p) <= 3 * n + 6

    t_lo = t_p[:n] + [rnd[9]]
    t_mid = _poly_add(t_p[n:2 * n], [-rnd[9]]) + [rnd[10]]
    t_hi = _poly_add(t_p[2 * n:], [-rnd[10]])
    tlo_c = _kzg_commit(pk.srs, t_lo)
    tmid_c = _kzg_commit(pk.srs, t_mid)
    thi_c = _kzg_commit(pk.srs, t_hi)
    ts.absorb_point(tlo_c)
    ts.absorb_point(tmid_c)
    ts.absorb_point(thi_c)
    zeta = ts.challenge(b"zeta")

    a_bar = _poly_eval(a_p, zeta)
    b_bar = _poly_eval(b_p, zeta)
    c_bar = _poly_eval(c_p, zeta)
    s1_bar = _poly_eval(pk.s1, zeta)
    s2_bar = _poly_eval(pk.s2, zeta)
    zw_bar = _poly_eval(z_p, zeta * w % R)
    for s in (a_bar, b_bar, c_bar, s1_bar, s2_bar, zw_bar):
        ts.absorb_scalar(s)
    nu = ts.challenge(b"nu")
    u = ts.challenge(b"u")

    # linearization polynomial r(X) with r(zeta) = 0
    zh_z = (pow(zeta, n, R) - 1) % R
    l1_z = zh_z * pow(n * (zeta - 1) % R, R - 2, R) % R
    pi_z = _poly_eval(pi_p, zeta)

    r_p = _poly_scale(pk.qm, a_bar * b_bar % R)
    r_p = _poly_add(r_p, _poly_scale(pk.ql, a_bar))
    r_p = _poly_add(r_p, _poly_scale(pk.qr, b_bar))
    r_p = _poly_add(r_p, _poly_scale(pk.qo, c_bar))
    r_p = _poly_add(r_p, pk.qc)
    r_p = _poly_add(r_p, [pi_z])
    num_z = (a_bar + beta * zeta + gamma) % R
    num_z = num_z * ((b_bar + beta * K1 * zeta + gamma) % R) % R
    num_z = num_z * ((c_bar + beta * K2 * zeta + gamma) % R) % R
    r_p = _poly_add(r_p, _poly_scale(z_p, alpha * num_z % R))
    den_part = (a_bar + beta * s1_bar + gamma) * (b_bar + beta * s2_bar + gamma) % R
    r_p = _poly_add(r_p, _poly_scale(pk.s3, (-alpha * den_part % R) * beta % R * zw_bar % R))
    r_p = _poly_add(r_p, [(-alpha * den_part % R) * ((c_bar + gamma) % R) % R * zw_bar % R])
    r_p = _poly_add(r_p, _poly_scale(z_p, alpha * alpha % R * l1_z % R))
    r_p = _poly_add(r_p, [(-alpha * alpha % R * l1_z) % R])
    zn = pow(zeta, n, R)
    t_comb = _poly_add(_poly_add(t_lo, _poly_scale(t_mid, zn)), _poly_scale(t_hi, zn * zn % R))
    r_p = _poly_add(r_p, _poly_scale(t_comb, (-zh_z) % R))
    assert _poly_eval(r_p, zeta) == 0, "linearization does not vanish at zeta"

    wz_num = list(r_p)
    np_ = nu
    for p, bar in ((a_p, a_bar), (b_p, b_bar), (c_p, c_bar), (pk.s1, s1_bar), (pk.s2, s2_bar)):
        wz_num = _poly_add(wz_num, _poly_scale(_poly_add(p, [(-bar) % R]), np_))
        np_ = np_ * nu % R
    wz = _div_linear(wz_num, zeta)
    wzw = _div_linear(_poly_add(z_p, [(-zw_bar) % R]), zeta * w % R)
    wz_c = _kzg_commit(pk.srs, wz)
    wzw_c = _kzg_commit(pk.srs, wzw)
    return PlonkProof(a_c, b_c, c_c, z_c, tlo_c, tmid_c, thi_c, wz_c, wzw_c,
                      a_bar, b_bar, c_bar, s1_bar, s2_bar, zw_bar)


# ---------------------------------------------------------------------------
# Verify
# ---------------------------------------------------------------------------


def verify(vk: PlonkVerifyingKey, proof: PlonkProof, public_inputs: list) -> bool:
    n = vk.n
    log_n = n.bit_length() - 1
    w = _domain_root(log_n)
    if len(public_inputs) != vk.num_public:
        return False

    ts = _Transcript()
    for q in (vk.qm_c, vk.ql_c, vk.qr_c, vk.qo_c, vk.qc_c, vk.s1_c, vk.s2_c, vk.s3_c):
        ts.absorb_point(q)
    for x in public_inputs:
        ts.absorb_scalar(x)
    ts.absorb_point(proof.a_c)
    ts.absorb_point(proof.b_c)
    ts.absorb_point(proof.c_c)
    beta = ts.challenge(b"beta")
    gamma = ts.challenge(b"gamma")
    ts.absorb_point(proof.z_c)
    alpha = ts.challenge(b"alpha")
    ts.absorb_point(proof.tlo_c)
    ts.absorb_point(proof.tmid_c)
    ts.absorb_point(proof.thi_c)
    zeta = ts.challenge(b"zeta")
    for s in (proof.a_bar, proof.b_bar, proof.c_bar, proof.s1_bar, proof.s2_bar, proof.zw_bar):
        ts.absorb_scalar(s)
    nu = ts.challenge(b"nu")
    u = ts.challenge(b"u")

    zh_z = (pow(zeta, n, R) - 1) % R
    if zh_z == 0:
        return False
    # L_i(zeta) for the public rows; PI(zeta) = -sum pub_i L_i(zeta)
    pi_z = 0
    wi = 1
    for i in range(vk.num_public):
        li = wi * zh_z % R * pow(n * (zeta - wi) % R, R - 2, R) % R
        pi_z = (pi_z - public_inputs[i] * li) % R
        wi = wi * w % R
    l1_z = zh_z * pow(n * (zeta - 1) % R, R - 2, R) % R

    den_part = (proof.a_bar + beta * proof.s1_bar + gamma) % R
    den_part = den_part * ((proof.b_bar + beta * proof.s2_bar + gamma) % R) % R
    r0 = (pi_z - l1_z * alpha % R * alpha
          - alpha * den_part % R * ((proof.c_bar + gamma) % R) % R * proof.zw_bar) % R

    def pt(p):
        return p  # None = infinity handled by g1 ops below

    def g1add(p, q):
        if p is None:
            return q
        if q is None:
            return p
        return ec.g1_add(p, q)

    def g1mul(p, k):
        if p is None or k % R == 0:
            return None
        return ec.g1_mul(p, k % R)

    num_z = (proof.a_bar + beta * zeta + gamma) % R
    num_z = num_z * ((proof.b_bar + beta * K1 * zeta + gamma) % R) % R
    num_z = num_z * ((proof.c_bar + beta * K2 * zeta + gamma) % R) % R
    d = g1mul(vk.qm_c, proof.a_bar * proof.b_bar % R)
    d = g1add(d, g1mul(vk.ql_c, proof.a_bar))
    d = g1add(d, g1mul(vk.qr_c, proof.b_bar))
    d = g1add(d, g1mul(vk.qo_c, proof.c_bar))
    d = g1add(d, pt(vk.qc_c))
    d = g1add(d, g1mul(proof.z_c, (alpha * num_z + alpha * alpha % R * l1_z + u) % R))
    d = g1add(d, g1mul(vk.s3_c, (-alpha * den_part % R * beta % R * proof.zw_bar) % R))
    zn = pow(zeta, n, R)
    t_comb = g1add(
        g1add(pt(proof.tlo_c), g1mul(proof.tmid_c, zn)), g1mul(proof.thi_c, zn * zn % R)
    )
    d = g1add(d, g1mul(t_comb, (-zh_z) % R))

    f = d
    np_ = nu
    e_scalar = (-r0) % R
    for c_pt, bar in ((proof.a_c, proof.a_bar), (proof.b_c, proof.b_bar),
                      (proof.c_c, proof.c_bar), (vk.s1_c, proof.s1_bar),
                      (vk.s2_c, proof.s2_bar)):
        f = g1add(f, g1mul(c_pt, np_))
        e_scalar = (e_scalar + np_ * bar) % R
        np_ = np_ * nu % R
    e_scalar = (e_scalar + u * proof.zw_bar) % R
    e_pt = g1mul(ec.G1_GEN, e_scalar)

    lhs_g1 = g1add(pt(proof.wz_c), g1mul(proof.wzw_c, u))
    rhs_g1 = g1add(
        g1add(g1mul(proof.wz_c, zeta), g1mul(proof.wzw_c, u * zeta % R * w % R)),
        g1add(f, g1mul(e_pt, R - 1) if e_pt is not None else None),
    )
    if lhs_g1 is None or rhs_g1 is None:
        return False
    # e(lhs, [tau]_2) == e(rhs, [1]_2)
    return ec.pairing_product_is_one(
        [(lhs_g1, vk.x2), (ec.g1_neg(rhs_g1), ec.G2_GEN)]
    )


# ---------------------------------------------------------------------------
# Native packed path: polynomials as (n, 4) u64 Montgomery arrays driven
# through csrc/bn254.c's vectorized Fr ops.  The int-list implementation
# above is its plain version; the two share the transcript and the verifier,
# and ``prove`` dispatches on the proving key's representation.
# ---------------------------------------------------------------------------


def _pk_ints(vals) -> "np.ndarray":
    """Canonical ints -> packed Montgomery array."""
    arr = nv.pack_fr(list(vals))
    nv.fr_vec_mont(arr)
    return arr


def _pk1(x: int) -> "np.ndarray":
    return _pk_ints([x % R])[0]


def _un1(row) -> int:
    c = np.array([row], dtype=np.uint64)
    nv.fr_vec_mont(c, to=False)
    return nv.unpack_fr(c)[0]


_ZERO1 = None
_ONE1 = None


def _zero1():
    global _ZERO1
    if _ZERO1 is None:
        _ZERO1 = _pk1(0)
    return _ZERO1


def _one1():
    global _ONE1
    if _ONE1 is None:
        _ONE1 = _pk1(1)
    return _ONE1


def _pfft(arr: "np.ndarray", log_n: int, inverse: bool) -> "np.ndarray":
    """FFT of a Montgomery packed array (padded to 2^log_n); Montgomery out."""
    n = 1 << log_n
    buf = np.zeros((n, 4), dtype=np.uint64)
    buf[: len(arr)] = arr
    nv.fr_fft_mont(buf, _domain_root(log_n), inverse=inverse)
    return buf


def _pinterp(evals: "np.ndarray", log_n: int) -> "np.ndarray":
    return _pfft(evals, log_n, inverse=True)


def _pcoset_evals(coeffs: "np.ndarray", log_big: int, shift: int) -> "np.ndarray":
    pw = nv.fr_vec_powers(_pk1(shift), _one1(), len(coeffs))
    return _pfft(nv.fr_vec_mul(coeffs, pw), log_big, inverse=False)


def _pcoset_interp(evals: "np.ndarray", log_big: int, shift: int) -> "np.ndarray":
    coeffs = _pfft(evals, log_big, inverse=True)
    pw = nv.fr_vec_powers(_pk1(pow(shift, R - 2, R)), _one1(), len(coeffs))
    return nv.fr_vec_mul(coeffs, pw)


def _padd(a: "np.ndarray", b: "np.ndarray") -> "np.ndarray":
    n = max(len(a), len(b))
    if len(a) < n:
        a = np.concatenate([a, np.zeros((n - len(a), 4), dtype=np.uint64)])
    if len(b) < n:
        b = np.concatenate([b, np.zeros((n - len(b), 4), dtype=np.uint64)])
    return nv.fr_vec_add(a, b)


def _pscale(a: "np.ndarray", k: int) -> "np.ndarray":
    return nv.fr_vec_scale_add(a, _pk1(k), _zero1())


def _peval(coeffs: "np.ndarray", z: int) -> int:
    """coeffs(z) as a canonical int (tree-reduced packed dot product)."""
    pw = nv.fr_vec_powers(_pk1(z), _one1(), len(coeffs))
    prods = nv.fr_vec_mul(coeffs, pw)
    while len(prods) > 1:
        m = len(prods) // 2
        head = nv.fr_vec_add(prods[:m], prods[m : 2 * m])
        prods = _padd(head, prods[2 * m :]) if 2 * m < len(prods) else head
    return _un1(prods[0])


def _ptrim(a: "np.ndarray") -> "np.ndarray":
    nz = np.flatnonzero(a.any(axis=1))
    return a[: nz[-1] + 1] if len(nz) else a[:0]


def _pcommit(srs: G1Vec, coeffs: "np.ndarray"):
    c = _ptrim(coeffs)
    if not len(c):
        return None
    canon = c.copy()
    nv.fr_vec_mont(canon, to=False)
    sc = np.ascontiguousarray(canon).view(np.uint8).reshape(len(canon), 32)
    return srs.slice(0, len(c)).msm(sc)


def _pprefix_prod(r: "np.ndarray") -> "np.ndarray":
    """Inclusive prefix product (Hillis-Steele over packed Montgomery rows)."""
    p = r.copy()
    shift = 1
    n = len(p)
    while shift < n:
        p[shift:] = nv.fr_vec_mul(p[shift:], p[:-shift])
        shift *= 2
    return p


def _pmul_zh(blind: list, n: int) -> "np.ndarray":
    """(b_{k-1} X^{k-1} + ... + b_0) * (X^n - 1) as a packed array."""
    k = len(blind)
    out = np.zeros((n + k, 4), dtype=np.uint64)
    b = _pk_ints(blind)
    out[n : n + k] = b
    out[:k] = nv.fr_vec_sub(out[:k], b)
    return out


def setup(g: GateSystem, rng=None):
    """PLONK setup over the packed pipeline: (pk, vk).  ``rng(n)`` draws the
    SRS trapdoor tau in [0, n) (default ``secrets.randbelow``)."""
    n = _domain_size(g)
    log_n = n.bit_length() - 1

    def sel_poly(q):
        return _pinterp(_pk_ints(list(q) + [0] * (n - len(q))), log_n)

    ql, qr, qo, qm, qc = (sel_poly(q) for q in (g.ql, g.qr, g.qo, g.qm, g.qc))
    sigma, _ids = _build_permutation(g, n)
    sigma_evals = [_pk_ints(sig) for sig in sigma]
    s1, s2, s3 = (_pinterp(se, log_n) for se in sigma_evals)

    tau = (rng or secrets.randbelow)(R - 2) + 2
    powers = []
    acc = 1
    for _ in range(n + 6):
        powers.append(acc)
        acc = acc * tau % R
    srs = _g1_mul_batch(powers)
    vk = PlonkVerifyingKey(
        n=n,
        num_public=g.num_public,
        qm_c=_pcommit(srs, qm), ql_c=_pcommit(srs, ql), qr_c=_pcommit(srs, qr),
        qo_c=_pcommit(srs, qo), qc_c=_pcommit(srs, qc),
        s1_c=_pcommit(srs, s1), s2_c=_pcommit(srs, s2), s3_c=_pcommit(srs, s3),
        x2=ec.g2_mul(ec.G2_GEN, tau),
    )
    pk = PlonkProvingKey(vk, srs, ql, qr, qo, qm, qc, s1, s2, s3, sigma_evals, g)
    return pk, vk


def _prove_native(pk: PlonkProvingKey, g: GateSystem, rng=None) -> PlonkProof:
    vk = pk.vk
    n = vk.n
    log_n = n.bit_length() - 1
    log_big = log_n + 2
    big = 1 << log_big
    rot = big // n
    w = _domain_root(log_n)
    wbig = _domain_root(log_big)
    shift = 7

    # wire evaluation vectors via one gather over the packed witness values
    vals_pk = _pk_ints(g.values)
    k_gates = g.num_gates

    def wire_evals(wlist):
        idx = np.zeros(n, dtype=np.int64)
        idx[:k_gates] = np.asarray(wlist, dtype=np.int64)
        return np.ascontiguousarray(vals_pk[idx])

    a_e, b_e, c_e = wire_evals(g.wa), wire_evals(g.wb), wire_evals(g.wc)
    pi_e = np.zeros((n, 4), dtype=np.uint64)
    if g.num_public:
        zero_block = np.zeros((g.num_public, 4), dtype=np.uint64)
        pi_e[: g.num_public] = nv.fr_vec_sub(zero_block, a_e[: g.num_public])

    draw = rng or secrets.randbelow
    rnd = [draw(R) for _ in range(11)]
    a_p = _padd(_pinterp(a_e, log_n), _pmul_zh([rnd[1], rnd[0]], n))
    b_p = _padd(_pinterp(b_e, log_n), _pmul_zh([rnd[3], rnd[2]], n))
    c_p = _padd(_pinterp(c_e, log_n), _pmul_zh([rnd[5], rnd[4]], n))
    pi_p = _pinterp(pi_e, log_n)

    ts = _Transcript()
    for q in (vk.qm_c, vk.ql_c, vk.qr_c, vk.qo_c, vk.qc_c, vk.s1_c, vk.s2_c, vk.s3_c):
        ts.absorb_point(q)
    for i in range(g.num_public):
        ts.absorb_scalar(g.values[1 + i])
    a_c, b_c, c_c = (_pcommit(pk.srs, p) for p in (a_p, b_p, c_p))
    ts.absorb_point(a_c)
    ts.absorb_point(b_c)
    ts.absorb_point(c_c)
    beta = ts.challenge(b"beta")
    gamma = ts.challenge(b"gamma")

    # permutation accumulator
    gamma_m = _pk1(gamma)
    x_h = nv.fr_vec_powers(_pk1(w), _one1(), n)
    s1_e, s2_e, s3_e = pk.sigma_slots

    def lin(base, vec, kf):
        return nv.fr_vec_add(base, nv.fr_vec_scale_add(vec, _pk1(beta * kf % R), gamma_m))

    num = nv.fr_vec_mul(
        nv.fr_vec_mul(lin(a_e, x_h, 1), lin(b_e, x_h, K1)), lin(c_e, x_h, K2)
    )
    den = nv.fr_vec_mul(
        nv.fr_vec_mul(lin(a_e, s1_e, 1), lin(b_e, s2_e, 1)), lin(c_e, s3_e, 1)
    )
    r_vec = nv.fr_vec_mul(num, nv.fr_vec_inv(den))
    prefix = _pprefix_prod(r_vec)
    z_e = np.empty((n, 4), dtype=np.uint64)
    z_e[0] = _one1()
    z_e[1:] = prefix[: n - 1]
    z_p = _padd(_pinterp(z_e, log_n), _pmul_zh([rnd[8], rnd[7], rnd[6]], n))
    z_c = _pcommit(pk.srs, z_p)
    ts.absorb_point(z_c)
    alpha = ts.challenge(b"alpha")

    # quotient on the coset
    def ce(p):
        return _pcoset_evals(p, log_big, shift)

    a_b, b_b, c_b, z_b = ce(a_p), ce(b_p), ce(c_p), ce(z_p)
    ql_b, qr_b, qo_b, qm_b, qc_b = ce(pk.ql), ce(pk.qr), ce(pk.qo), ce(pk.qm), ce(pk.qc)
    s1_b, s2_b, s3_b, pi_b = ce(pk.s1), ce(pk.s2), ce(pk.s3), ce(pi_p)
    zw_b = np.roll(z_b, -rot, axis=0)
    one_evals = np.zeros((n, 4), dtype=np.uint64)
    one_evals[0] = _one1()
    l1_b = ce(_pinterp(one_evals, log_n))

    gate = nv.fr_vec_mul(nv.fr_vec_mul(qm_b, a_b), b_b)
    gate = nv.fr_vec_add(gate, nv.fr_vec_mul(ql_b, a_b))
    gate = nv.fr_vec_add(gate, nv.fr_vec_mul(qr_b, b_b))
    gate = nv.fr_vec_add(gate, nv.fr_vec_mul(qo_b, c_b))
    gate = nv.fr_vec_add(gate, pi_b)
    gate = nv.fr_vec_add(gate, qc_b)

    x_b = nv.fr_vec_powers(_pk1(wbig), _pk1(shift), big)
    numq = nv.fr_vec_mul(
        nv.fr_vec_mul(lin(a_b, x_b, 1), lin(b_b, x_b, K1)), lin(c_b, x_b, K2)
    )
    denq = nv.fr_vec_mul(
        nv.fr_vec_mul(lin(a_b, s1_b, 1), lin(b_b, s2_b, 1)), lin(c_b, s3_b, 1)
    )
    perm = nv.fr_vec_sub(nv.fr_vec_mul(numq, z_b), nv.fr_vec_mul(denq, zw_b))
    ones = np.broadcast_to(_one1(), (big, 4)).copy()
    start = nv.fr_vec_mul(nv.fr_vec_sub(z_b, ones), l1_b)

    t_b = nv.fr_vec_add(
        gate,
        nv.fr_vec_add(_pscale(perm, alpha), _pscale(start, alpha * alpha % R)),
    )
    zh_inv = [
        pow((pow(shift, n, R) * pow(wbig, n * i, R) - 1) % R, R - 2, R) for i in range(rot)
    ]
    zh_tile = np.tile(_pk_ints(zh_inv), (n, 1))
    t_b = nv.fr_vec_mul(t_b, zh_tile)
    t_p = _ptrim(_pcoset_interp(t_b, log_big, shift))
    assert len(t_p) <= 3 * n + 6

    lo = np.zeros((n + 1, 4), dtype=np.uint64)
    lo[: min(n, len(t_p))] = t_p[:n]
    lo[n] = _pk_ints([rnd[9]])[0]
    t_lo = lo
    t_mid = np.zeros((n + 1, 4), dtype=np.uint64)
    t_mid[: max(0, min(n, len(t_p) - n))] = t_p[n : 2 * n]
    t_mid[:1] = nv.fr_vec_sub(t_mid[:1], _pk_ints([rnd[9]]))
    t_mid[n] = nv.fr_vec_add(t_mid[n : n + 1], _pk_ints([rnd[10]]))[0]
    hi = t_p[2 * n :].copy()
    if not len(hi):
        hi = np.zeros((1, 4), dtype=np.uint64)
    hi[:1] = nv.fr_vec_sub(hi[:1], _pk_ints([rnd[10]]))
    t_hi = hi
    tlo_c = _pcommit(pk.srs, t_lo)
    tmid_c = _pcommit(pk.srs, t_mid)
    thi_c = _pcommit(pk.srs, t_hi)
    ts.absorb_point(tlo_c)
    ts.absorb_point(tmid_c)
    ts.absorb_point(thi_c)
    zeta = ts.challenge(b"zeta")

    a_bar = _peval(a_p, zeta)
    b_bar = _peval(b_p, zeta)
    c_bar = _peval(c_p, zeta)
    s1_bar = _peval(pk.s1, zeta)
    s2_bar = _peval(pk.s2, zeta)
    zw_bar = _peval(z_p, zeta * w % R)
    for sc_ in (a_bar, b_bar, c_bar, s1_bar, s2_bar, zw_bar):
        ts.absorb_scalar(sc_)
    nu = ts.challenge(b"nu")
    u = ts.challenge(b"u")

    zh_z = (pow(zeta, n, R) - 1) % R
    l1_z = zh_z * pow(n * (zeta - 1) % R, R - 2, R) % R
    pi_z = _peval(pi_p, zeta)

    # linearization r(X): polynomial part accumulated packed, constants on
    # coefficient 0 accumulated as an int
    max_len = max(len(z_p), len(pk.s3), n + 2, len(t_lo), len(t_mid), len(t_hi))

    def pad(p):
        if len(p) >= max_len:
            return p
        return np.concatenate([p, np.zeros((max_len - len(p), 4), dtype=np.uint64)])

    num_z = (a_bar + beta * zeta + gamma) % R
    num_z = num_z * ((b_bar + beta * K1 * zeta + gamma) % R) % R
    num_z = num_z * ((c_bar + beta * K2 * zeta + gamma) % R) % R
    den_part = (a_bar + beta * s1_bar + gamma) * (b_bar + beta * s2_bar + gamma) % R

    r_p = pad(_pscale(pk.qm, a_bar * b_bar % R))
    r_p = nv.fr_vec_add(r_p, pad(_pscale(pk.ql, a_bar)))
    r_p = nv.fr_vec_add(r_p, pad(_pscale(pk.qr, b_bar)))
    r_p = nv.fr_vec_add(r_p, pad(_pscale(pk.qo, c_bar)))
    r_p = nv.fr_vec_add(r_p, pad(pk.qc))
    r_p = nv.fr_vec_add(
        r_p, pad(_pscale(z_p, (alpha * num_z + alpha * alpha % R * l1_z) % R))
    )
    r_p = nv.fr_vec_add(
        r_p, pad(_pscale(pk.s3, (-alpha * den_part % R) * beta % R * zw_bar % R))
    )
    zn = pow(zeta, n, R)
    t_comb = nv.fr_vec_add(
        pad(t_lo), nv.fr_vec_add(pad(_pscale(t_mid, zn)), pad(_pscale(t_hi, zn * zn % R)))
    )
    r_p = nv.fr_vec_add(r_p, _pscale(t_comb, (-zh_z) % R))
    r_const = (
        pi_z
        + (-alpha * den_part % R) * ((c_bar + gamma) % R) % R * zw_bar
        + (-alpha * alpha % R * l1_z)
    ) % R

    # W_zeta numerator: r(X) + sum nu^i (p_i(X) - bar_i)
    np_ = nu
    const_acc = r_const
    for p, bar in ((a_p, a_bar), (b_p, b_bar), (c_p, c_bar), (pk.s1, s1_bar), (pk.s2, s2_bar)):
        r_p = nv.fr_vec_add(r_p, pad(_pscale(p, np_)))
        const_acc = (const_acc - np_ * bar) % R
        np_ = np_ * nu % R
    r_p[0] = nv.fr_vec_add(r_p[:1], _pk_ints([const_acc]))[0]
    wz = nv.fr_vec_div_linear(_ptrim_keep(r_p), _pk1(zeta))

    z_open = z_p.copy()
    z_open[0] = nv.fr_vec_sub(z_open[:1], _pk_ints([zw_bar]))[0]
    wzw = nv.fr_vec_div_linear(_ptrim_keep(z_open), _pk1(zeta * w % R))
    wz_c = _pcommit(pk.srs, wz)
    wzw_c = _pcommit(pk.srs, wzw)
    return PlonkProof(a_c, b_c, c_c, z_c, tlo_c, tmid_c, thi_c, wz_c, wzw_c,
                      a_bar, b_bar, c_bar, s1_bar, s2_bar, zw_bar)


def _ptrim_keep(a: "np.ndarray") -> "np.ndarray":
    """Trim trailing zero rows but keep at least two (div_linear needs deg>=1)."""
    t = _ptrim(a)
    if len(t) < 2:
        return a[:2]
    return t
