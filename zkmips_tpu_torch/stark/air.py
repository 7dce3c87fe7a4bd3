"""Symbolic AIR expression DAG + builder, with vectorized evaluation.

The chip author writes ``eval(builder)`` once against this builder (the
analog of the reference's ``ZKMAirBuilder``, crates/stark/src/air/builder.rs).
The same expression DAG is then interpreted three ways:

  * degree analysis -> log_quotient_degree (reference: chip.rs:19-80)
  * vectorized base-field evaluation over the quotient domain (prover)
  * quartic-extension scalar evaluation at zeta (verifier)

Values during numeric evaluation are ``Val(arr, is_ext)``: base values are
Montgomery int32 tensors of the context shape, ext values carry a trailing
4-axis.  Promotion happens on demand.  The DAG classes are a copy of the
reference's (``zkmips_tpu/stark/air.py``); the evaluator is torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import torch

from ..ops import ext4, field as f

# --- variable segments ------------------------------------------------------

PREPROCESSED = 0
MAIN = 1
PERM = 2  # ext-valued


class LookupKind(IntEnum):
    """reference: crates/stark/src/lookup/lookup.rs:25-57."""

    Memory = 1
    Program = 2
    Instruction = 3
    Byte = 4
    Range = 5
    Syscall = 6
    Global = 7


class Scope(IntEnum):
    Global = 0
    Local = 1


# --- expression nodes -------------------------------------------------------


class Expr:
    __slots__ = ()

    def __add__(self, other):
        return _binop(Add, self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return _binop(Sub, self, other)

    def __rsub__(self, other):
        return _binop(Sub, _lift(other), self)

    def __mul__(self, other):
        return _binop(Mul, self, other)

    __rmul__ = __mul__

    def __neg__(self):
        return Neg(self)


class Const(Expr):
    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value % f.P


ZERO = Const(0)
ONE = Const(1)


class Var(Expr):
    __slots__ = ("segment", "col", "offset")

    def __init__(self, segment: int, col: int, offset: int):
        self.segment = segment
        self.col = col
        self.offset = offset  # 0 = local row, 1 = next row


class Public(Expr):
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class Challenge(Expr):
    """Ext-valued permutation challenge (0 = alpha, 1 = beta)."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class CumSumLocal(Expr):
    """The claimed local cumulative sum for this chip (ext-valued)."""

    __slots__ = ()


class GlobalSumCoord(Expr):
    """Coordinate i (0..13) of the claimed global septic digest (base)."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class Selector(Expr):
    __slots__ = ("which",)

    FIRST, LAST, TRANSITION = 0, 1, 2

    def __init__(self, which: int):
        self.which = which


class Add(Expr):
    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a, b


class Sub(Expr):
    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a, b


class Mul(Expr):
    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a, b


class Neg(Expr):
    __slots__ = ("a",)

    def __init__(self, a):
        self.a = a


def _lift(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, np.integer)):
        return Const(int(x))
    raise TypeError(f"cannot lift {type(x)} into Expr")


def _binop(cls, a, b):
    a, b = _lift(a), _lift(b)
    if isinstance(a, Const) and isinstance(b, Const):
        if cls is Add:
            return Const(a.value + b.value)
        if cls is Sub:
            return Const(a.value - b.value)
        return Const(a.value * b.value)
    # cheap identities keep DAGs small
    if cls is Mul:
        if isinstance(a, Const):
            if a.value == 0:
                return ZERO
            if a.value == 1:
                return b
        if isinstance(b, Const):
            if b.value == 0:
                return ZERO
            if b.value == 1:
                return a
    if cls is Add:
        if isinstance(a, Const) and a.value == 0:
            return b
        if isinstance(b, Const) and b.value == 0:
            return a
    if cls is Sub and isinstance(b, Const) and b.value == 0:
        return a
    return cls(a, b)


# --- lookups ----------------------------------------------------------------


@dataclass
class Lookup:
    """values + multiplicity are Exprs over (preprocessed, main) local row."""

    values: list
    multiplicity: Expr
    kind: LookupKind
    scope: Scope = Scope.Local

    @property
    def argument_index(self) -> int:
        return int(self.kind)


# --- builder ----------------------------------------------------------------


class AirBuilder:
    """Collects constraints and lookups from a chip's eval()."""

    def __init__(self, preprocessed_width: int, main_width: int, num_public_values: int = 0):
        self.preprocessed_width = preprocessed_width
        self.main_width = main_width
        self.constraints: list[Expr] = []  # each asserted == 0 on all rows
        self.sends: list[Lookup] = []
        self.receives: list[Lookup] = []
        self._condition: Expr | None = None
        self.num_public_values = num_public_values

    # -- variables ----------------------------------------------------------

    def preprocessed(self, col: int, offset: int = 0) -> Expr:
        assert 0 <= col < self.preprocessed_width
        return Var(PREPROCESSED, col, offset)

    def main(self, col: int, offset: int = 0) -> Expr:
        assert 0 <= col < self.main_width
        return Var(MAIN, col, offset)

    def main_row(self, offset: int = 0) -> list[Expr]:
        return [Var(MAIN, c, offset) for c in range(self.main_width)]

    def preprocessed_row(self, offset: int = 0) -> list[Expr]:
        return [Var(PREPROCESSED, c, offset) for c in range(self.preprocessed_width)]

    def public_value(self, index: int) -> Expr:
        return Public(index)

    @property
    def is_first_row(self) -> Expr:
        return Selector(Selector.FIRST)

    @property
    def is_last_row(self) -> Expr:
        return Selector(Selector.LAST)

    @property
    def is_transition(self) -> Expr:
        return Selector(Selector.TRANSITION)

    # -- assertions ----------------------------------------------------------

    def assert_zero(self, e):
        e = _lift(e)
        if self._condition is not None:
            e = self._condition * e
        if not (isinstance(e, Const) and e.value == 0):
            self.constraints.append(e)

    def assert_eq(self, a, b):
        self.assert_zero(_lift(a) - _lift(b))

    def assert_one(self, e):
        self.assert_eq(e, ONE)

    def assert_bool(self, e):
        e = _lift(e)
        self.assert_zero(e * (e - ONE))

    # -- condition scoping ----------------------------------------------------

    def when(self, cond):
        return _Filtered(self, _lift(cond))

    def when_not(self, cond):
        return _Filtered(self, ONE - _lift(cond))

    def when_first_row(self):
        return self.when(self.is_first_row)

    def when_last_row(self):
        return self.when(self.is_last_row)

    def when_transition(self):
        return self.when(self.is_transition)

    # -- lookups --------------------------------------------------------------

    def send(self, kind: LookupKind, values, multiplicity, scope: Scope = Scope.Local):
        assert self._condition is None, "lookups cannot be nested under when()"
        self.sends.append(Lookup([_lift(v) for v in values], _lift(multiplicity), kind, scope))

    def receive(self, kind: LookupKind, values, multiplicity, scope: Scope = Scope.Local):
        assert self._condition is None, "lookups cannot be nested under when()"
        self.receives.append(Lookup([_lift(v) for v in values], _lift(multiplicity), kind, scope))

    def send_byte(self, opcode, a, b, c, mult):
        self.send(LookupKind.Byte, [opcode, a, b, c], mult)

    def receive_byte(self, opcode, a, b, c, mult):
        self.receive(LookupKind.Byte, [opcode, a, b, c], mult)


class _Filtered:
    """Builder view that multiplies every assertion by a condition."""

    def __init__(self, parent: AirBuilder, cond: Expr):
        self._parent = parent
        self._cond = cond

    def __getattr__(self, name):
        return getattr(self._parent, name)

    def assert_zero(self, e):
        e = _lift(e)
        self._parent.constraints.append(self._cond * e)

    def assert_eq(self, a, b):
        self.assert_zero(_lift(a) - _lift(b))

    def assert_one(self, e):
        self.assert_eq(e, ONE)

    def assert_bool(self, e):
        e = _lift(e)
        self.assert_zero(e * (e - ONE))

    def when(self, cond):
        return _Filtered(self._parent, self._cond * _lift(cond))

    def when_not(self, cond):
        return _Filtered(self._parent, self._cond * (ONE - _lift(cond)))


# --- degree analysis --------------------------------------------------------


def expr_degree(e: Expr, cache: dict | None = None) -> int:
    """Degree multiple (reference chip.rs / p3 symbolic degree rules)."""
    if cache is None:
        cache = {}
    k = id(e)
    if k in cache:
        return cache[k]
    if isinstance(e, (Const, Public, Challenge, CumSumLocal, GlobalSumCoord)):
        d = 0
    elif isinstance(e, Var):
        d = 1
    elif isinstance(e, Selector):
        d = 0 if e.which == Selector.TRANSITION else 1
    elif isinstance(e, (Add, Sub)):
        d = max(expr_degree(e.a, cache), expr_degree(e.b, cache))
    elif isinstance(e, Mul):
        d = expr_degree(e.a, cache) + expr_degree(e.b, cache)
    elif isinstance(e, Neg):
        d = expr_degree(e.a, cache)
    else:
        raise TypeError(type(e))
    cache[k] = d
    return d

# --- numeric evaluation -----------------------------------------------------


@dataclass
class Val:
    arr: torch.Tensor  # Montgomery int32; ext values have a trailing 4-axis
    is_ext: bool


class EvalContext:
    """Bindings for one evaluation pass, all on ``device``.

    var_fn(segment, col, offset) -> base tensor (shape S), or ext (S, 4) for
    PERM; selectors: {FIRST, LAST, TRANSITION} -> base tensors of shape S;
    publics (num_pv,); challenges [(4,), (4,)]; cum_sum (4,); global_sum (14,).
    """

    ext_mode = False  # the verifier's IntEvalContext binds every var as ext

    def __init__(self, var_fn, selectors, publics=None, challenges=None, cum_sum=None,
                 global_sum=None, device="cpu"):
        self.device = torch.device(device)
        self.var_fn = var_fn
        self.selectors = selectors
        self.publics = self._on(publics)
        self.challenges = None if challenges is None else [self._on(c) for c in challenges]
        self.cum_sum = self._on(cum_sum)
        self.global_sum = self._on(global_sum)
        self.cache: dict[int, Val] = {}

    def _on(self, t):
        return None if t is None else torch.as_tensor(t).to(self.device)

    def const(self, value: int) -> torch.Tensor:
        return _const(value, self.device)

    # -- the alpha fold ------------------------------------------------------

    def alpha_powers(self, alpha, n: int):
        return ext4.powers(torch.as_tensor(alpha).to(self.device), n)

    def fold_term(self, acc, v: Val, apow):
        """acc + apow * v, summed in int64 and reduced by ``fold_result``."""
        if v.is_ext:
            term = ext4.mul(v.arr, apow)
        else:
            # base constraint times an ext power: 4 base products, not 16
            term = f.mul(apow, _bcast_base(v.arr))
        term = term.to(torch.int64)
        return term if acc is None else acc + term

    def fold_result(self, acc) -> torch.Tensor:
        return f.narrow(acc % f.P)

    # -- mixed base/ext ring ops ---------------------------------------------

    def vadd(self, a: Val, b: Val) -> Val:
        a, b = self._promote(a, b)
        return Val(f.add(a.arr, b.arr), a.is_ext)

    def vsub(self, a: Val, b: Val) -> Val:
        a, b = self._promote(a, b)
        return Val(f.sub(a.arr, b.arr), a.is_ext)

    def vmul(self, a: Val, b: Val) -> Val:
        if a.is_ext and b.is_ext:
            return Val(ext4.mul(a.arr, b.arr), True)
        if a.is_ext:
            return Val(f.mul(a.arr, _bcast_base(b.arr)), True)
        if b.is_ext:
            return Val(f.mul(b.arr, _bcast_base(a.arr)), True)
        return Val(f.mul(a.arr, b.arr), False)

    def vneg(self, a: Val) -> Val:
        return Val(f.neg(a.arr), a.is_ext)

    def _promote(self, a: Val, b: Val):
        if a.is_ext == b.is_ext:
            return a, b
        if a.is_ext:
            return a, Val(ext4.from_base(b.arr), True)
        return Val(ext4.from_base(a.arr), True), b


class IntEvalContext:
    """The verifier's bindings on Python ints, for one evaluation at a point:
    a base value is a Montgomery int, an ext value a list of four.  The same
    arithmetic as ``EvalContext`` in ext mode, without a tensor operation per
    DAG node.  The arguments are as for ``EvalContext`` (tensors or lists);
    ``var_fn`` returns ext values as lists."""

    ext_mode = True

    def __init__(self, var_fn, selectors, publics=None, challenges=None, cum_sum=None,
                 global_sum=None):
        self.var_fn = var_fn
        self.selectors = {k: _ints(v) for k, v in selectors.items()}
        self.publics = _ints(publics)
        self.challenges = None if challenges is None else [_ints(c) for c in challenges]
        self.cum_sum = _ints(cum_sum)
        self.global_sum = _ints(global_sum)
        self.cache: dict[int, Val] = {}

    @staticmethod
    def const(value: int) -> int:
        return f.to_monty_int(value)

    def vadd(self, a: Val, b: Val) -> Val:
        a, b = self._promote(a, b)
        if a.is_ext:
            return Val([(x + y) % f.P for x, y in zip(a.arr, b.arr)], True)
        return Val((a.arr + b.arr) % f.P, False)

    def vsub(self, a: Val, b: Val) -> Val:
        a, b = self._promote(a, b)
        if a.is_ext:
            return Val([(x - y) % f.P for x, y in zip(a.arr, b.arr)], True)
        return Val((a.arr - b.arr) % f.P, False)

    def vmul(self, a: Val, b: Val) -> Val:
        if a.is_ext and b.is_ext:
            return Val(_ext_mul_int(a.arr, b.arr), True)
        if a.is_ext or b.is_ext:
            e, c = (a.arr, b.arr) if a.is_ext else (b.arr, a.arr)
            return Val([x * c * f.R_INV % f.P for x in e], True)
        return Val(a.arr * b.arr * f.R_INV % f.P, False)

    def vneg(self, a: Val) -> Val:
        if a.is_ext:
            return Val([-x % f.P for x in a.arr], True)
        return Val(-a.arr % f.P, False)

    @staticmethod
    def _promote(a: Val, b: Val):
        if a.is_ext == b.is_ext:
            return a, b
        if a.is_ext:
            return a, Val([b.arr, 0, 0, 0], True)
        return Val([a.arr, 0, 0, 0], True), b

    def alpha_powers(self, alpha, n: int) -> list:
        alpha = _ints(alpha)
        out = [[f.ONE, 0, 0, 0]]
        while len(out) < n:
            out.append(_ext_mul_int(out[-1], alpha))
        return out[:n]

    def fold_term(self, acc, v: Val, apow):
        term = _ext_mul_int(v.arr, apow) if v.is_ext else [x * v.arr * f.R_INV % f.P for x in apow]
        return term if acc is None else [x + y for x, y in zip(acc, term)]

    def fold_result(self, acc) -> torch.Tensor:
        return torch.tensor([x % f.P for x in acc], dtype=torch.int32)


def _ints(t):
    """A tensor, array or list of field values as Python ints (nested lists)."""
    if t is None or isinstance(t, int):
        return t
    if isinstance(t, torch.Tensor):
        return t.tolist()
    return [int(x) for x in t] if not isinstance(t[0], (list, tuple)) else [_ints(x) for x in t]


def _ext_mul_int(a, b) -> list:
    """Product of two ext values of Montgomery ints (X^4 = 3)."""
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    c = (
        a0 * b0 + 3 * (a1 * b3 + a2 * b2 + a3 * b1),
        a0 * b1 + a1 * b0 + 3 * (a2 * b3 + a3 * b2),
        a0 * b2 + a1 * b1 + a2 * b0 + 3 * a3 * b3,
        a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0,
    )
    return [x % f.P * f.R_INV % f.P for x in c]


def _bcast_base(arr: torch.Tensor) -> torch.Tensor:
    """base (S,) -> (S, 1) so it broadcasts against ext (S, 4)."""
    return arr[..., None] if arr.dim() else arr


_CONSTS: dict = {}


def _const(value: int, device: torch.device) -> torch.Tensor:
    """The Montgomery form of a constant as a 0-d tensor on ``device``, made once."""
    key = (value, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(f.to_monty_int(value), dtype=torch.int32, device=device)
    return t


def _children(e: Expr) -> tuple:
    if isinstance(e, (Add, Sub, Mul)):
        return (e.a, e.b)
    if isinstance(e, Neg):
        return (e.a,)
    return ()


def _node_value(e: Expr, kids: list, ctx: EvalContext) -> Val:
    """The value of ``e`` given the values of its children."""
    if isinstance(e, Const):
        return Val(ctx.const(e.value), False)
    if isinstance(e, Var):
        return Val(ctx.var_fn(e.segment, e.col, e.offset), e.segment == PERM or ctx.ext_mode)
    if isinstance(e, Selector):
        return Val(ctx.selectors[e.which], ctx.ext_mode)
    if isinstance(e, Public):
        return Val(ctx.publics[e.index], False)
    if isinstance(e, Challenge):
        return Val(ctx.challenges[e.index], True)
    if isinstance(e, CumSumLocal):
        return Val(ctx.cum_sum, True)
    if isinstance(e, GlobalSumCoord):
        return Val(ctx.global_sum[e.index], False)
    if isinstance(e, Add):
        return ctx.vadd(*kids)
    if isinstance(e, Sub):
        return ctx.vsub(*kids)
    if isinstance(e, Mul):
        return ctx.vmul(*kids)
    if isinstance(e, Neg):
        return ctx.vneg(*kids)
    raise TypeError(type(e))


def eval_expr(e: Expr, ctx: EvalContext) -> Val:
    k = id(e)
    hit = ctx.cache.get(k)
    if hit is not None:
        return hit
    v = _node_value(e, [eval_expr(c, ctx) for c in _children(e)], ctx)
    ctx.cache[k] = v
    return v


def _schedule(roots) -> tuple[list, dict]:
    """The nodes below ``roots`` in post-order (children first), and for each
    node the number of its readers: one per parent edge, one per place in
    ``roots``."""
    order, readers, seen = [], {}, set()
    for r in roots:
        readers[id(r)] = readers.get(id(r), 0) + 1
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        e, expanded = stack.pop()
        if expanded:
            order.append(e)
            continue
        if id(e) in seen:
            continue
        seen.add(id(e))
        stack.append((e, True))
        kids = _children(e)
        for c in kids:
            readers[id(c)] = readers.get(id(c), 0) + 1
        stack.extend((c, False) for c in reversed(kids) if id(c) not in seen)
    return order, readers


def fold_constraints(constraints, alpha: torch.Tensor, ctx: EvalContext) -> torch.Tensor:
    """sum_k alpha^k * C_k as an ext value; the terms are summed in int64 and
    reduced once.

    The DAG is walked once in post-order and a node's value is dropped after
    its last reader, so the values held at once are the DAG's live set, not
    every node (a wide chip has tens of thousands of nodes)."""
    apows = ctx.alpha_powers(alpha, len(constraints))
    places: dict = {}
    for k, c in enumerate(constraints):
        places.setdefault(id(c), []).append(k)
    order, readers = _schedule(constraints)
    vals = ctx.cache
    acc = None
    for e in order:
        kids = _children(e)
        v = _node_value(e, [vals[id(c)] for c in kids], ctx)
        for c in kids:
            readers[id(c)] -= 1
            if not readers[id(c)]:
                del vals[id(c)]
        for k in places.get(id(e), ()):
            acc = ctx.fold_term(acc, v, apows[k])
            readers[id(e)] -= 1
        if readers[id(e)]:
            vals[id(e)] = v
    return ctx.fold_result(acc)
