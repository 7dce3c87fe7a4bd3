"""Groth16 zkSNARK over BN254 for R1CS instances.

The analog of gnark's ``groth16.{Setup,Prove,Verify}`` used by the reference
wrap stage (crates/recursion/gnark-ffi/go/main.go:42-120).  Standard Groth16
[Gro16]: QAP via Lagrange interpolation over a 2^k evaluation domain in the
scalar field (2-adicity 28).  The toxic waste is drawn per circuit (a real
deployment would run an MPC ceremony; the reference downloads a trusted
setup for the fixed wrap circuit).

Randomness is an argument: ``setup`` and ``prove`` draw through ``rng``, a
callable ``randbelow(n)`` that defaults to ``secrets.randbelow`` (a CSPRNG),
in the reference's order (setup: tau, alpha, beta, gamma, delta; prove: r,
s).  Given the same draws, keys and proofs equal the reference's.

The MSMs, the fixed-base batches and the Fr FFTs run in ``csrc/bn254.c``
(``snark/native``); a failed build raises.

Proof = (A in G1, B in G2, C in G1); verify checks
  e(A, B) == e(alpha, beta) * e(sum_i pub_i * ic_i, gamma) * e(C, delta).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np

from . import bn254_curve as ec, native
from .r1cs import ConstraintSystem, R

# 2^28 | R - 1; generator 5 of Fr* gives the two-adic roots.
_TWO_ADICITY = 28
_ROOT_2_28 = pow(5, (R - 1) >> _TWO_ADICITY, R)


def _domain_root(log_n: int) -> int:
    assert log_n <= _TWO_ADICITY
    return pow(_ROOT_2_28, 1 << (_TWO_ADICITY - log_n), R)


def _fft(vals: list[int], root: int, inverse: bool = False) -> list[int]:
    """Radix-2 FFT on Python ints: the plain version of ``native.fr_fft``."""
    n = len(vals)
    if n == 1:
        return list(vals)
    if inverse:
        root = pow(root, R - 2, R)
    # iterative radix-2 DIT
    out = list(vals)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            out[i], out[j] = out[j], out[i]
    length = 2
    while length <= n:
        step = pow(root, n // length, R)
        for start in range(0, n, length):
            w = 1
            for k in range(start, start + length // 2):
                u, v = out[k], out[k + length // 2] * w % R
                out[k], out[k + length // 2] = (u + v) % R, (u - v) % R
                w = w * step % R
        length <<= 1
    if inverse:
        n_inv = pow(n, R - 2, R)
        out = [x * n_inv % R for x in out]
    return out


class G1Vec:
    """A G1 point vector kept in the native packed layout ((n, 8) u64
    canonical limbs and (n,) infinity flags), so keys of millions of points
    never round-trip through Python objects."""

    GROUP = "g1"

    def __init__(self, pts: np.ndarray, infs: np.ndarray):
        self.pts = pts
        self.infs = infs

    def __len__(self):
        return len(self.pts)

    def __getitem__(self, i: int):
        unpack = native._unpack_g1 if self.GROUP == "g1" else native._unpack_g2
        return unpack(self.pts[i], self.infs[i])

    def msm(self, scalars):
        """sum scalars[i] * self[i]; scalars packed (n, 32) u8 or ints."""
        sc = scalars if hasattr(scalars, "dtype") else native.pack_scalars(scalars)
        fn = native.g1_msm_packed if self.GROUP == "g1" else native.g2_msm_packed
        return fn(self.pts, self.infs, sc)

    def slice(self, start, stop=None):
        return type(self)(self.pts[start:stop], self.infs[start:stop])


class G2Vec(G1Vec):
    GROUP = "g2"


@dataclass
class ProvingKeyG16:
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_query: G1Vec  # per witness index
    b1_query: G1Vec  # per witness index
    b2_query: G2Vec  # per witness index
    c_query: G1Vec  # per private index (index offset num_public+1)
    h_query: G1Vec  # powers tau^i * zh(tau) / delta
    num_public: int


@dataclass
class VerifyingKeyG16:
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    ic: list  # G1, len num_public + 1


@dataclass
class ProofG16:
    a: tuple  # G1
    b: tuple  # G2
    c: tuple  # G1


def _qap_evals_at_tau(cs: ConstraintSystem, n: int, tau: int):
    """u_i(tau), v_i(tau), w_i(tau): sparse accumulation over constraints
    (one pass; L_j(tau) = (tau^n - 1)/n * root^j / (tau - root^j))."""
    root = _domain_root(n.bit_length() - 1)
    zh_tau = (pow(tau, n, R) - 1) % R
    n_inv = pow(n, R - 2, R)
    # batch-invert (tau - root^j) over the domain
    denoms = []
    rj = 1
    for _ in range(n):
        denoms.append((tau - rj) % R)
        rj = rj * root % R
    inv = _batch_inverse(denoms)
    lag = []
    rj = 1
    for j in range(n):
        lag.append(zh_tau * n_inv % R * rj % R * inv[j] % R)
        rj = rj * root % R

    m = len(cs.values)
    u = [0] * m
    v = [0] * m
    w = [0] * m
    for j, (a, b, c) in enumerate(cs.constraints):
        lj = lag[j]
        for i, coeff in a.items():
            u[i] = (u[i] + coeff * lj) % R
        for i, coeff in b.items():
            v[i] = (v[i] + coeff * lj) % R
        for i, coeff in c.items():
            w[i] = (w[i] + coeff * lj) % R
    return u, v, w, zh_tau


def _batch_inverse(vals: list[int]) -> list[int]:
    prefix = [1] * (len(vals) + 1)
    for i, x in enumerate(vals):
        prefix[i + 1] = prefix[i] * x % R
    inv_all = pow(prefix[-1], R - 2, R)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv_all * prefix[i] % R
        inv_all = inv_all * vals[i] % R
    return out


def _g1_mul_batch(scalars: list[int]) -> G1Vec:
    return G1Vec(*native.g1_mul_batch_packed(ec.G1_GEN, native.pack_scalars(scalars)))


def _g2_mul_batch(scalars: list[int]) -> G2Vec:
    return G2Vec(*native.g2_mul_batch_packed(ec.G2_GEN, native.pack_scalars(scalars)))


def setup(cs: ConstraintSystem, rng=None):
    """Per-circuit trusted setup: (pk, vk).  ``rng(n)`` draws the toxic
    waste in [0, n) (default ``secrets.randbelow``); it is then discarded."""
    draw = rng or secrets.randbelow
    n = 1 << max(1, (len(cs.constraints) - 1).bit_length())
    m = len(cs.values)
    npub = cs.num_public

    tau = draw(R - 1) + 1
    alpha = draw(R - 1) + 1
    beta = draw(R - 1) + 1
    gamma = draw(R - 1) + 1
    delta = draw(R - 1) + 1

    u, v, w, zh_tau = _qap_evals_at_tau(cs, n, tau)

    delta_inv = pow(delta, R - 2, R)
    gamma_inv = pow(gamma, R - 2, R)

    kv = [(beta * u[i] + alpha * v[i] + w[i]) % R for i in range(m)]
    tau_pows = [1] * (n - 1)
    for i in range(1, n - 1):
        tau_pows[i] = tau_pows[i - 1] * tau % R
    singles = _g1_mul_batch([alpha, beta, delta])
    g2_singles = _g2_mul_batch([beta, delta, gamma])
    ic_vec = _g1_mul_batch([kv[i] * gamma_inv % R for i in range(npub + 1)])
    pk = ProvingKeyG16(
        alpha1=singles[0],
        beta1=singles[1],
        beta2=g2_singles[0],
        delta1=singles[2],
        delta2=g2_singles[1],
        a_query=_g1_mul_batch(u),
        b1_query=_g1_mul_batch(v),
        b2_query=_g2_mul_batch(v),
        c_query=_g1_mul_batch([kv[i] * delta_inv % R for i in range(npub + 1, m)]),
        h_query=_g1_mul_batch([t * zh_tau % R * delta_inv % R for t in tau_pows]),
        num_public=npub,
    )
    vk = VerifyingKeyG16(
        alpha1=pk.alpha1,
        beta2=pk.beta2,
        gamma2=g2_singles[2],
        delta2=pk.delta2,
        ic=[ic_vec[i] for i in range(npub + 1)],
    )
    return pk, vk


def _h_poly(cs: ConstraintSystem, wit: list[int], n: int) -> np.ndarray:
    """h(X) = (A(X) B(X) - C(X)) / Z_H(X) by coset evaluation: the n - 1
    coefficients as a packed (n - 1, 4) canonical array."""
    root = _domain_root(n.bit_length() - 1)
    a_dom = [0] * n
    b_dom = [0] * n
    c_dom = [0] * n
    for j, (a, b, c) in enumerate(cs.constraints):
        a_dom[j] = sum(wit[i] * cf for i, cf in a.items()) % R
        b_dom[j] = sum(wit[i] * cf for i, cf in b.items()) % R
        c_dom[j] = sum(wit[i] * cf for i, cf in c.items()) % R
    g = 5  # coset shift (multiplicative generator)
    g_inv = pow(g, R - 2, R)
    zh_inv = pow((pow(g, n, R) - 1) % R, R - 2, R)

    pa, pb, pc = (native.pack_fr(v) for v in (a_dom, b_dom, c_dom))
    for arr in (pa, pb, pc):
        native.fr_fft(arr, root, inverse=True)
        native.fr_scale_pows(arr, g)
        native.fr_fft(arr, root)
    h_cs = native.fr_mul_sub_scale(pa, pb, pc, zh_inv)
    native.fr_fft(h_cs, root, inverse=True)
    native.fr_scale_pows(h_cs, g_inv)
    assert not h_cs[n - 1].any()  # deg(h) <= n - 2
    return h_cs[: n - 1]


def prove(pk: ProvingKeyG16, cs: ConstraintSystem, rng=None) -> ProofG16:
    """A Groth16 proof of ``cs``'s witness; ``rng`` draws r and s."""
    assert cs.is_satisfied(), "witness does not satisfy the constraint system"
    draw = rng or secrets.randbelow
    n = 1 << max(1, (len(cs.constraints) - 1).bit_length())
    wit = [x % R for x in cs.values]
    h = _h_poly(cs, wit, n)
    # (n-1, 4) u64 canonical -> 32-byte LE scalars, zero-copy
    h_sc = np.ascontiguousarray(h).view(np.uint8).reshape(len(h), 32)

    r = draw(R)
    s = draw(R)

    wit_sc = native.pack_scalars(wit)
    a_pt = ec.g1_add(pk.alpha1, pk.a_query.msm(wit_sc))
    a_pt = ec.g1_add(a_pt, ec.g1_mul(pk.delta1, r))
    b1_pt = ec.g1_add(ec.g1_add(pk.beta1, pk.b1_query.msm(wit_sc)), ec.g1_mul(pk.delta1, s))
    b_pt = ec.g2_add(ec.g2_add(pk.beta2, pk.b2_query.msm(wit_sc)), ec.g2_mul(pk.delta2, s))
    wit_priv = wit_sc[pk.num_public + 1 :]
    c_pt = pk.c_query.msm(wit_priv)
    c_pt = ec.g1_add(c_pt, pk.h_query.msm(h_sc))
    c_pt = ec.g1_add(c_pt, ec.g1_mul(a_pt, s))
    c_pt = ec.g1_add(c_pt, ec.g1_mul(b1_pt, r))
    c_pt = ec.g1_add(c_pt, ec.g1_mul(pk.delta1, (-r * s) % R))
    return ProofG16(a_pt, b_pt, c_pt)


def verify(vk: VerifyingKeyG16, proof: ProofG16, public_inputs: list[int]) -> bool:
    assert len(public_inputs) == len(vk.ic) - 1, "wrong number of public inputs"
    acc = vk.ic[0]
    for base, x in zip(vk.ic[1:], public_inputs):
        acc = ec.g1_add(acc, ec.g1_mul(base, x % R))
    # e(A, B) = e(alpha, beta) e(acc, gamma) e(C, delta)
    return ec.pairing_product_is_one(
        [
            (ec.g1_neg(proof.a), proof.b),
            (vk.alpha1, vk.beta2),
            (acc, vk.gamma2),
            (proof.c, vk.delta2),
        ]
    )
