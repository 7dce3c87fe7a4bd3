"""KoalaBear-in-Fr circuit gadgets for the outer (Groth16) wrap circuit.

The analog of the reference's gnark KoalaBear emulation + in-circuit
Poseidon2-BN254 (crates/recursion/gnark-ffi/go/zkm/koalabear/koalabear.go,
go/zkm/poseidon2/poseidon2.go): KoalaBear field elements live inside BN254's
scalar field Fr as exact non-negative integers with a tracked upper bound;
arithmetic is lazy (adds/subs are free linear-combination algebra; multiplies
emit one R1CS constraint) and values are reduced mod the KoalaBear prime only
when a canonical representative is required (transcript packing, bit
decompositions, equality assertions) via hinted (q, r) decompositions with
bit-range checks.

``OuterBuilder`` exposes the same surface as the recursion DSL ``Builder``
(add/sub/mul/div/select/num2bits/exp_reverse_bits/batch_fri/felts2ext/...),
so the in-DSL shard verifier emitter (recursion/verifier.py) can be re-run
unchanged against an R1CS ``ConstraintSystem``.

Every value is a Python int: the hints' extension-field products and
inverses use the recursion runtime's canonical int arithmetic, not tensors
(an outer circuit has millions of nodes).  The constraint order and the
variable numbering are those of the reference's gadgets, so the two
packages build equal constraint systems from equal proofs.
"""

from __future__ import annotations

from ..ops import bn254, ext4, field as ff
from ..recursion.runtime import _ext_inv_int, _ext_mul_int
from .r1cs import ConstraintSystem, R, Var


def _ext_mul_canonical(a, b) -> tuple:
    return _ext_mul_int(tuple(int(x) for x in a), tuple(int(x) for x in b))


def _ext_inv_canonical(a) -> tuple:
    return _ext_inv_int(tuple(int(x) for x in a))

P = ff.P  # KoalaBear prime 2^31 - 2^24 + 1
W = ext4.W  # quartic binomial: X^4 = 3

# reduce a lazy value once its bound reaches this; empirically 2^128 minimizes
# total constraints (longer chains save reduces but cost wider q range checks)
_REDUCE_BOUND = 1 << 128
_R_MINUS_1_BITS = [(R - 1) >> i & 1 for i in range(254)]


# ---------------------------------------------------------------------------
# Fr linear-combination handles
# ---------------------------------------------------------------------------


class FrVal:
    """An Fr value as (sparse linear combination, integer value, bound).

    Invariant: ``value ≡ lc (mod R)``, ``0 <= value <= bound``.  While
    ``bound < R`` the value is the EXACT integer the LC evaluates to — the
    KoalaBear emulation keeps its bounds far below R so (q, r) reduction
    hints stay exact; native-Fr values (Poseidon2 state) wrap mod R once
    their bound reaches R (``_norm``).  add/sub/scalar-mul are free, one
    constraint is emitted per multiplication.
    """

    __slots__ = ("lc", "value", "bound")

    def __init__(self, lc: dict, value: int, bound: int):
        self.lc = lc
        self.value = value
        self.bound = bound


def _norm(lc: dict, value: int, bound: int) -> FrVal:
    if bound >= R:
        value %= R
        bound = R - 1
    return FrVal(lc, value, bound)


class FrCtx:
    """Fr-level helpers over a ConstraintSystem (native-field layer)."""

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs

    # -- construction --------------------------------------------------------

    def const(self, v: int) -> FrVal:
        v = int(v) % R
        return FrVal({0: v} if v else {}, v, v)

    def witness(self, v: int, bound: int) -> FrVal:
        var = self.cs.witness(v)
        return FrVal({var.idx: 1}, int(v) % R, bound)

    def from_public(self, var: Var, value: int, bound: int) -> FrVal:
        return FrVal({var.idx: 1}, int(value), bound)

    # -- linear algebra (free) ----------------------------------------------

    def add(self, a: FrVal, b: FrVal) -> FrVal:
        lc = dict(a.lc)
        for k, c in b.lc.items():
            lc[k] = (lc.get(k, 0) + c) % R
        return _norm(lc, a.value + b.value, a.bound + b.bound)

    def scale(self, a: FrVal, c: int) -> FrVal:
        assert c >= 0
        return _norm({k: v * c % R for k, v in a.lc.items()}, a.value * c, a.bound * c)

    def linear(self, terms, const: int = 0) -> FrVal:
        """sum coeff_i * v_i + const (coeffs non-negative ints)."""
        lc: dict = {0: const % R} if const else {}
        value, bound = const, const
        for coeff, v in terms:
            for k, c in v.lc.items():
                lc[k] = (lc.get(k, 0) + c * coeff) % R
            value += coeff * v.value
            bound += coeff * v.bound
        return _norm(lc, value, bound)

    def materialize(self, a: FrVal) -> FrVal:
        """Snapshot a wide LC into a fresh variable (1 constraint)."""
        if len(a.lc) <= 1:
            return a
        out = self.cs.witness(a.value % R)
        self.cs.enforce(a.lc, 1, out)
        return FrVal({out.idx: 1}, a.value, a.bound)

    def _squeeze(self, a: FrVal, max_terms: int = 24) -> FrVal:
        return self.materialize(a) if len(a.lc) > max_terms else a

    # -- multiplication ------------------------------------------------------

    def mul(self, a: FrVal, b: FrVal) -> FrVal:
        if not a.lc or not b.lc:
            return self.const(0)
        if tuple(a.lc) == (0,):
            return self.scale(b, a.value)
        if tuple(b.lc) == (0,):
            return self.scale(a, b.value)
        out = self.cs.witness(a.value * b.value % R)
        self.cs.enforce(a.lc, b.lc, out)
        return _norm({out.idx: 1}, a.value * b.value, a.bound * b.bound)

    def assert_eq(self, a: FrVal, b: FrVal):
        assert a.value % R == b.value % R, "assert_eq on unequal Fr values"
        diff = dict(a.lc)
        for k, c in b.lc.items():
            diff[k] = (diff.get(k, 0) - c) % R
        self.cs.enforce(diff, 1, 0)

    # -- bit decomposition ---------------------------------------------------

    def bits_of(self, a: FrVal, n: int) -> list[FrVal]:
        """Constrained n-bit LSB-first decomposition; requires value < 2^n."""
        v = a.value
        assert v < (1 << n), "value does not fit the requested bit width"
        bits = []
        for i in range(n):
            bvar = self.cs.witness((v >> i) & 1)
            self.cs.enforce(bvar, {bvar.idx: 1, 0: R - 1}, 0)  # b(b-1)=0
            bits.append(FrVal({bvar.idx: 1}, (v >> i) & 1, 1))
        recomp = self.linear([(1 << i, b) for i, b in enumerate(bits)])
        self.assert_eq(recomp, a)
        return bits

    def assert_bits_canonical_fr(self, bits: list[FrVal]):
        """Enforce that 254 LSB-first bits encode an integer <= R - 1, making
        the decomposition of an Fr element unique (gnark ToBinary semantics)."""
        assert len(bits) == 254
        # chain MSB->LSB: lt = "strictly less so far", eq = "equal so far"
        lt = self.const(0)
        eq = self.const(1)
        one = self.const(1)
        for i in reversed(range(254)):
            b = bits[i]
            not_b = self.linear([(R - 1, b)], const=1)  # 1 - b  (mod R)
            not_b = FrVal(not_b.lc, 1 - b.value, 1)
            if _R_MINUS_1_BITS[i]:
                lt = self.add(lt, self.mul(eq, not_b))
                eq = self.mul(eq, b)
            else:
                eq = self.mul(eq, not_b)
            lt = self._squeeze(lt, 8)
        self.assert_eq(self.add(lt, eq), one)


# ---------------------------------------------------------------------------
# KoalaBear emulation
# ---------------------------------------------------------------------------


class KBFelt:
    """A KoalaBear element carried as an FrVal with value ≡ x (mod P)."""

    __slots__ = ("fr",)

    def __init__(self, fr: FrVal):
        self.fr = fr

    @property
    def canonical(self) -> int:
        return self.fr.value % P


class KBExt:
    """F_{P^4} element: 4 KBFelt coordinates (c0 + c1 X + c2 X^2 + c3 X^3)."""

    __slots__ = ("c",)

    def __init__(self, coords: list[KBFelt]):
        assert len(coords) == 4
        self.c = coords

    @property
    def canonical(self) -> tuple:
        return tuple(x.canonical for x in self.c)


class OuterBuilder:
    """Builder-compatible emitter over an R1CS with KoalaBear emulation.

    Implements the subset of recursion.builder.Builder used by the shard
    verifier emitter; values are eager (the R1CS witness is produced during
    the build, r1cs.py module docstring).
    """

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.fr = FrCtx(cs)
        self._const_memo: dict = {}

    # ------------------------------------------------------------- constants

    def const_felt(self, value: int) -> KBFelt:
        return KBFelt(self.fr.const(int(value) % P))

    def const_ext(self, coords) -> KBExt:
        return KBExt([self.const_felt(c) for c in coords])

    # ---------------------------------------------------------------- hints

    def hint_felt(self, value: int) -> KBFelt:
        """Witness a canonical KoalaBear value (range-checked < P)."""
        v = int(value) % P
        fv = self.fr.witness(v, (1 << 31) - 1)
        self._check_canonical_kb(fv)
        return KBFelt(fv)

    def hint_felt_loose(self, value: int) -> KBFelt:
        """Witness a KoalaBear value with only a 31-bit range check (no
        canonical top-pattern).  Sound for values that feed arithmetic or
        2^32-stride packing but are never observed into the transcript: the
        representative is pinned by the Merkle/FRI checks, and non-canonical
        encodings of the same residue behave identically mod P."""
        v = int(value) % P
        fv = self.fr.witness(v, (1 << 31) - 1)
        self.fr.bits_of(fv, 31)
        return KBFelt(fv)

    def hint_ext(self, coords) -> KBExt:
        return KBExt([self.hint_felt_loose(c) for c in coords])

    def _check_canonical_kb(self, fv: FrVal):
        """31-bit decomposition + KoalaBear canonical check: if the top 7 bits
        are all one the low 24 bits must be zero (builder.num2bits trick)."""
        bits = self.fr.bits_of(fv, 31)
        prod = bits[24]
        for k in range(25, 31):
            prod = self.fr.mul(prod, bits[k])
        low = self.fr.linear([(1, b) for b in bits[:24]])
        zero = self.fr.mul(prod, low)
        self.fr.assert_eq(zero, self.fr.const(0))
        fv.bound = P - 1
        return bits

    # ------------------------------------------------------------ reduction

    def _reduce(self, x: KBFelt) -> KBFelt:
        """Canonical representative: hint (q, r) with value = q*P + r."""
        fv = x.fr
        if fv.bound < P:
            return x
        v = fv.value
        q, r = divmod(v, P)
        q_bits = max(1, (fv.bound // P).bit_length())
        qv = self.fr.witness(q, (1 << q_bits) - 1)
        self.fr.bits_of(qv, q_bits)
        rv = self.fr.witness(r, (1 << 31) - 1)
        self._check_canonical_kb(rv)
        self.fr.assert_eq(self.fr.linear([(P, qv), (1, rv)]), fv)
        return KBFelt(rv)

    def _maybe_reduce(self, x: KBFelt, incoming_bound: int) -> KBFelt:
        if x.fr.bound * incoming_bound >= _REDUCE_BOUND:
            return self._reduce(x)
        return x

    # ----------------------------------------------------------- arithmetic

    def _promote(self, x):
        if isinstance(x, KBFelt):
            zero = self.const_felt(0)
            return KBExt([x, zero, zero, zero])
        return x

    def add(self, x, y):
        if isinstance(x, KBExt) or isinstance(y, KBExt):
            xe, ye = self._promote(x), self._promote(y)
            return KBExt([self.add(a, b) for a, b in zip(xe.c, ye.c)])
        out = self.fr.add(x.fr, y.fr)
        if out.bound >= _REDUCE_BOUND:
            return self._reduce(KBFelt(out))
        return KBFelt(out)

    def sub(self, x, y):
        if isinstance(x, KBExt) or isinstance(y, KBExt):
            xe, ye = self._promote(x), self._promote(y)
            return KBExt([self.sub(a, b) for a, b in zip(xe.c, ye.c)])
        # keep values non-negative: add the smallest k*P >= bound(y)
        k = (y.fr.bound + P - 1) // P
        out = self.fr.linear([(1, x.fr), (R - 1, y.fr)], const=k * P)
        out = FrVal(out.lc, x.fr.value - y.fr.value + k * P, x.fr.bound + k * P)
        assert out.value >= 0
        if out.bound >= _REDUCE_BOUND:
            return self._reduce(KBFelt(out))
        return KBFelt(out)

    def mul(self, x, y):
        if isinstance(x, KBExt) or isinstance(y, KBExt):
            return self._ext_mul(self._promote(x), self._promote(y))
        x = self._maybe_reduce(x, y.fr.bound)
        y = self._maybe_reduce(y, x.fr.bound)
        return KBFelt(self.fr.mul(x.fr, y.fr))

    def _ext_mul(self, x: KBExt, y: KBExt) -> KBExt:
        # reduce the wider operand's coords (then the other if still needed)
        # so a canonical operand never pays reduction for its partner's bound
        bx = max(c.fr.bound for c in x.c)
        by = max(c.fr.bound for c in y.c)
        if bx * by * 7 >= _REDUCE_BOUND:
            if bx >= by:
                x = KBExt([self._reduce(c) for c in x.c])
                bx = max(c.fr.bound for c in x.c)
            if bx * by * 7 >= _REDUCE_BOUND:
                y = KBExt([self._reduce(c) for c in y.c])
        prods = {}
        for i in range(4):
            for j in range(4):
                if x.c[i].fr.lc and y.c[j].fr.lc:
                    prods[(i, j)] = self.fr.mul(x.c[i].fr, y.c[j].fr)
        out = []
        for k in range(4):
            terms = []
            for i in range(4):
                j = k - i
                if (i, j) in prods:
                    terms.append((1, prods[(i, j)]))
                j4 = k - i + 4
                if (i, j4) in prods:
                    terms.append((W, prods[(i, j4)]))
            out.append(KBFelt(self.fr.linear(terms)))
        return KBExt(out)

    def div(self, x, y):
        if isinstance(x, KBExt) or isinstance(y, KBExt):
            xe, ye = self._promote(x), self._promote(y)
            q = _ext_inv_canonical(ye.canonical)
            out = self.hint_ext(_ext_mul_canonical(xe.canonical, q))
            self.assert_eq(self._ext_mul(ye, out), xe)
            return out
        inv = ff.inv_int(y.canonical)
        out = self.hint_felt(x.canonical * inv % P)
        self.assert_eq(self.mul(y, out), x)
        return out

    def assert_eq(self, x, y):
        if isinstance(x, KBExt) or isinstance(y, KBExt):
            xe, ye = self._promote(x), self._promote(y)
            for a, b in zip(xe.c, ye.c):
                self.assert_eq(a, b)
            return
        assert x.canonical == y.canonical, "assert_eq on unequal KoalaBear values"
        # divisibility check: x - y + kP == q * P with one hinted, range-
        # checked q — half the cost of reducing both sides to canonical
        k = (y.fr.bound + P - 1) // P
        diff_val = x.fr.value - y.fr.value + k * P
        diff_bound = x.fr.bound + k * P
        lc = dict(x.fr.lc)
        for kk, c in y.fr.lc.items():
            lc[kk] = (lc.get(kk, 0) - c) % R
        lc[0] = (lc.get(0, 0) + k * P) % R
        diff = FrVal(lc, diff_val, diff_bound)
        assert diff_val % P == 0 and diff_val >= 0
        q = diff_val // P
        q_bits = max(1, (diff_bound // P).bit_length())
        qv = self.fr.witness(q, (1 << q_bits) - 1)
        self.fr.bits_of(qv, q_bits)
        self.fr.assert_eq(self.fr.scale(qv, P), diff)

    def assert_zero(self, x):
        zero = self.const_ext((0, 0, 0, 0)) if isinstance(x, KBExt) else self.const_felt(0)
        self.assert_eq(x, zero)

    # ------------------------------------------------------------ primitives

    def select(self, bit: KBFelt, x: KBFelt, y: KBFelt):
        """(bit ? y : x, bit ? x : y) — recursion Select semantics; ``bit``
        must already be boolean-constrained."""
        assert bit.fr.value in (0, 1)
        d = self.sub(y, x)
        o1 = self.add(x, self.mul(bit, d))
        d2 = self.sub(x, y)
        o2 = self.add(y, self.mul(bit, d2))
        return o1, o2

    def exp_reverse_bits(self, base: KBFelt, bits: list[KBFelt]) -> KBFelt:
        one = self.const_felt(1)
        acc = one
        for bit in bits:
            acc = self.mul(acc, acc)
            m, _ = self.select(bit, one, base)
            acc = self.mul(acc, m)
        return acc

    def felts2ext(self, felts) -> KBExt:
        assert len(felts) == 4
        return KBExt(list(felts))

    def ext_to_felts(self, value: KBExt) -> list:
        return list(value.c)

    def ext2felts(self, value: KBExt) -> list:
        return list(value.c)

    def num2bits(self, value: KBFelt, num_bits: int = 31) -> list:
        v = self._reduce(value)
        bits = self._check_canonical_kb(v.fr)
        return [KBFelt(b) for b in bits[:num_bits]]

    def batch_fri(self, p_at_x: list, p_at_z: list, alpha_pow: list) -> KBExt:
        """acc = sum alpha_pow[m] * (p_at_z[m] - p_at_x[m]) (builder.batch_fri)."""
        acc = None
        for x, z, ap in zip(p_at_x, p_at_z, alpha_pow):
            term = self.mul(ap, self.sub(z, x))
            acc = term if acc is None else self.add(acc, term)
        return acc if acc is not None else self.const_ext((0, 0, 0, 0))


# ---------------------------------------------------------------------------
# Poseidon2-BN254 (width 3) over FrVal handles
# ---------------------------------------------------------------------------


def _sbox_fr(fx: FrCtx, x: FrVal) -> FrVal:
    x = fx._squeeze(x)
    x2 = fx.mul(x, x)
    x4 = fx.mul(x2, x2)
    return fx.mul(x4, x)


def _ext_mat_fr(fx: FrCtx, s):
    t = fx.add(fx.add(s[0], s[1]), s[2])
    return [fx._squeeze(fx.add(s[i], t)) for i in range(3)]


def permute3_gadget(fx: FrCtx, state: list[FrVal]) -> list[FrVal]:
    """In-circuit Poseidon2-BN254 width-3 permutation (ops/bn254.permute3)."""
    s = _ext_mat_fr(fx, state)
    for rc in bn254._RC_EXT_FIRST:
        s = [_sbox_fr(fx, fx.linear([(1, s[i])], const=rc[i])) for i in range(3)]
        s = _ext_mat_fr(fx, s)
    for rc in bn254._RC_INT:
        s0 = _sbox_fr(fx, fx.linear([(1, s[0])], const=rc))
        t = fx.add(fx.add(s0, s[1]), s[2])
        s = [
            fx._squeeze(fx.add(s0, t)),
            fx._squeeze(fx.add(s[1], t)),
            fx._squeeze(fx.add(fx.scale(s[2], 2), t)),
        ]
    for rc in bn254._RC_EXT_LAST:
        s = [_sbox_fr(fx, fx.linear([(1, s[i])], const=rc[i])) for i in range(3)]
        s = _ext_mat_fr(fx, s)
    return s


def split_32_gadget(b: OuterBuilder, fr: FrVal, n: int) -> list[KBFelt]:
    """In-circuit bn254.split_32: canonical 254-bit decomposition of an Fr
    element, then n 64-bit windows each reduced mod the KoalaBear prime."""
    fx = b.fr
    fr = fx.materialize(fr)
    v = fr.value % R
    bits = fx.bits_of(FrVal(fr.lc, v, R - 1), 254)
    fx.assert_bits_canonical_fr(bits)
    out = []
    for i in range(n):
        window = bits[64 * i : 64 * (i + 1)]
        wval = (v >> (64 * i)) & ((1 << 64) - 1)
        w = fx.linear([(1 << k, bit) for k, bit in enumerate(window)])
        q, r = divmod(wval, P)
        qv = fx.witness(q, (1 << 34) - 1)
        fx.bits_of(qv, 34)
        rv = fx.witness(r, (1 << 31) - 1)
        b._check_canonical_kb(rv)
        fx.assert_eq(fx.linear([(P, qv), (1, rv)]), w)
        out.append(KBFelt(rv))
    return out


def reduce_32_pack(b: OuterBuilder, felts: list[KBFelt]) -> FrVal:
    """In-circuit bn254.reduce_32: linear 2^32-stride packing of canonical
    KoalaBear values (callers must pass reduced felts)."""
    for f_ in felts:
        assert f_.fr.bound < (1 << 32), "pack requires canonical felts"
    return b.fr.linear([(1 << (32 * i), f_.fr) for i, f_ in enumerate(felts)])


# ---------------------------------------------------------------------------
# In-circuit MultiField32 challenger (stark/challenger_bn254.py mirror)
# ---------------------------------------------------------------------------


class OuterCircuitChallenger:
    """Mirror of MultiField32Challenger over circuit handles; the API matches
    recursion.verifier.CircuitChallenger so the emitter is hash-family
    agnostic (reference in-circuit version:
    crates/recursion/circuit/src/challenger.rs:236 MultiField32ChallengerVariable)."""

    PACK = bn254.CHALLENGER_PACK
    RATE = bn254.CHALLENGER_RATE

    def __init__(self, b: OuterBuilder):
        self.b = b
        self.state: list[FrVal] = [b.fr.const(0) for _ in range(3)]
        self.input_buffer: list[KBFelt] = []
        # split_32 is the most expensive gadget (254-bit canonical
        # decomposition), so state elements are split LAZILY: ``_pending``
        # holds unsplit state refs in buffer order; pops materialize from the
        # end, exactly mirroring the host's pop-from-end semantics
        self._pending: list[FrVal] = []
        self.output_buffer: list[KBFelt] = []

    def _duplex(self):
        assert len(self.input_buffer) <= self.PACK * self.RATE
        for i in range(0, len(self.input_buffer), self.PACK):
            self.state[i // self.PACK] = reduce_32_pack(
                self.b, self.input_buffer[i : i + self.PACK]
            )
        self.input_buffer.clear()
        self.state = permute3_gadget(self.b.fr, self.state)
        self.output_buffer = []
        self._pending = list(self.state)

    def observe(self, felt: KBFelt):
        self.output_buffer.clear()
        self._pending.clear()
        self.input_buffer.append(self.b._reduce(felt))
        if len(self.input_buffer) == self.PACK * self.RATE:
            self._duplex()

    def observe_slice(self, felts):
        for v in felts:
            self.observe(v)

    def observe_digest(self, digest: FrVal):
        """Observe a single-Fr commitment as its 3 split felts
        (challenger_bn254.observe_digest)."""
        for felt in split_32_gadget(self.b, digest, self.PACK):
            self.observe(felt)

    def sample(self) -> KBFelt:
        if self.input_buffer or (not self.output_buffer and not self._pending):
            self._duplex()
        if not self.output_buffer:
            st = self._pending.pop()
            self.output_buffer = split_32_gadget(self.b, st, self.PACK)
        return self.output_buffer.pop()

    def sample_ext(self) -> KBExt:
        return self.b.felts2ext([self.sample() for _ in range(4)])

    def sample_bits(self, nbits: int) -> list:
        return self.b.num2bits(self.sample(), 31)[:nbits]

    def check_witness(self, nbits: int, witness: KBFelt):
        self.observe(witness)
        for bit in self.sample_bits(nbits):
            self.b.assert_zero(bit)


# ---------------------------------------------------------------------------
# In-circuit multi-field sponge / Merkle compression (ops/bn254.hash_felts)
# ---------------------------------------------------------------------------


def hash_felts_gadget(b: OuterBuilder, felts: list[KBFelt]) -> FrVal:
    """In-circuit bn254.hash_felts.  Values only need bound < 2^32 for the
    packing to be injective (loose-hinted Merkle rows keep their 31-bit
    bound; anything wider is reduced)."""
    felts = [f_ if f_.fr.bound < (1 << 32) else b._reduce(f_) for f_ in felts]
    state = [b.fr.const(0) for _ in range(3)]
    for i in range(0, len(felts), bn254.RATE_FELTS):
        block = felts[i : i + bn254.RATE_FELTS]
        for cid in range(0, len(block), bn254.PACK):
            state[cid // bn254.PACK] = reduce_32_pack(b, block[cid : cid + bn254.PACK])
        state = permute3_gadget(b.fr, state)
    return state[0]


def compress_gadget(b: OuterBuilder, left: FrVal, right: FrVal) -> FrVal:
    return permute3_gadget(b.fr, [left, right, b.fr.const(0)])[0]
