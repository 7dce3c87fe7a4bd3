"""Rank-1 constraint system over the BN254 scalar field.

The SNARK-side circuit representation for the wrap stage — the analog of
gnark's ``frontend.API`` surface that the reference's Go circuit builds
(crates/recursion/gnark-ffi/go/zkm/zkm.go).  Constraints are A·w * B·w = C·w
rows over sparse linear combinations; the builder API is the subset the
constraint-compiler interpreter needs (add/sub/mul/inverse/select/
assert_eq/bit decomposition via hints).

Witness generation is eager: every ``Var`` holds its value during build, so
proving needs no separate solver pass.
"""

from __future__ import annotations

from dataclasses import dataclass

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


@dataclass(frozen=True)
class Var:
    idx: int  # index into the witness vector


# linear combination: dict var_idx -> coeff
LC = dict


class ConstraintSystem:
    """w[0] = 1; public inputs follow; then private witness values."""

    def __init__(self):
        self.values: list[int] = [1]
        self.num_public = 0
        self.constraints: list[tuple[LC, LC, LC]] = []  # (A, B, C)

    # -- allocation ---------------------------------------------------------

    def public(self, value: int) -> Var:
        assert len(self.values) == 1 + self.num_public, (
            "public inputs must be allocated before any private witness"
        )
        self.values.append(value % R)
        self.num_public += 1
        return Var(len(self.values) - 1)

    def witness(self, value: int) -> Var:
        self.values.append(value % R)
        return Var(len(self.values) - 1)

    def value(self, v) -> int:
        if isinstance(v, Var):
            return self.values[v.idx]
        return v % R

    def _lc(self, v) -> LC:
        if isinstance(v, Var):
            return {v.idx: 1}
        return {0: v % R}

    # -- constraints --------------------------------------------------------

    def enforce(self, a, b, c):
        """a * b == c, each a Var, int constant, or LC dict."""
        to = lambda x: x if isinstance(x, dict) else self._lc(x)
        self.constraints.append((to(a), to(b), to(c)))

    def assert_eq(self, a, b):
        self.enforce(a, 1, b)

    def assert_bool(self, a):
        self.enforce(a, self._sub_lc(self._lc(a), self._lc(1)), 0)

    # -- arithmetic (returns new witness Vars, constraints enforced) --------

    def _sub_lc(self, x: LC, y: LC) -> LC:
        out = dict(x)
        for k, v in y.items():
            out[k] = (out.get(k, 0) - v) % R
        return out

    def _add_lc(self, x: LC, y: LC) -> LC:
        out = dict(x)
        for k, v in y.items():
            out[k] = (out.get(k, 0) + v) % R
        return out

    def add(self, a, b) -> Var:
        out = self.witness(self.value(a) + self.value(b))
        self.enforce(self._add_lc(self._lc(a), self._lc(b)), 1, out)
        return out

    def sub(self, a, b) -> Var:
        out = self.witness(self.value(a) - self.value(b))
        self.enforce(self._sub_lc(self._lc(a), self._lc(b)), 1, out)
        return out

    def mul(self, a, b) -> Var:
        out = self.witness(self.value(a) * self.value(b))
        self.enforce(a, b, out)
        return out

    def neg(self, a) -> Var:
        return self.sub(0, a)

    def inverse(self, a) -> Var:
        av = self.value(a)
        assert av != 0, "inverse of zero"
        out = self.witness(pow(av, R - 2, R))
        self.enforce(a, out, 1)
        return out

    def div(self, a, b) -> Var:
        bv = self.value(b)
        assert bv != 0
        out = self.witness(self.value(a) * pow(bv, R - 2, R))
        self.enforce(b, out, a)
        return out

    def select(self, cond, if_true, if_false) -> Var:
        """cond must be boolean; out = cond ? if_true : if_false."""
        cv = self.value(cond)
        out = self.witness(self.value(if_true) if cv else self.value(if_false))
        # cond * (t - f) == out - f
        self.enforce(
            cond,
            self._sub_lc(self._lc(if_true), self._lc(if_false)),
            self._sub_lc(self._lc(out), self._lc(if_false)),
        )
        return out

    def is_zero(self, a) -> Var:
        """out = 1 if a == 0 else 0 (gnark IsZero gadget)."""
        av = self.value(a)
        out = self.witness(1 if av == 0 else 0)
        inv = self.witness(0 if av == 0 else pow(av, R - 2, R))
        # a * inv == 1 - out;  a * out == 0
        self.enforce(a, inv, self._sub_lc(self._lc(1), self._lc(out)))
        self.enforce(a, out, 0)
        return out

    def to_bits(self, a, n: int) -> list[Var]:
        """Little-endian n-bit decomposition with a recomposition constraint."""
        av = self.value(a)
        assert av < (1 << n), f"value does not fit in {n} bits"
        bits = []
        lc: LC = {}
        for i in range(n):
            b = self.witness((av >> i) & 1)
            self.assert_bool(b)
            lc = self._add_lc(lc, {b.idx: (1 << i) % R})
            bits.append(b)
        self.enforce(lc, 1, a)
        return bits

    def from_bits(self, bits: list) -> Var:
        acc = 0
        lc: LC = {}
        for i, b in enumerate(bits):
            acc += self.value(b) << i
            lc = self._add_lc(lc, {b.idx: (1 << i) % R})
        out = self.witness(acc)
        self.enforce(lc, 1, out)
        return out

    # -- satisfaction check -------------------------------------------------

    def is_satisfied(self) -> bool:
        w = self.values

        def ev(lc: LC) -> int:
            return sum(w[i] * c for i, c in lc.items()) % R

        return all(ev(a) * ev(b) % R == ev(c) for a, b, c in self.constraints)
