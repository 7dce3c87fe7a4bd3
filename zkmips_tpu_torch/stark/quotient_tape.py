"""A chip's constraint DAG compiled to a tape, the program of the quotient's
fold kernel (``csrc/quotient.cu``), and the plain torch evaluator of it.

``compile_tape`` walks the DAG once, in ``air._schedule``'s post-order, and
emits one instruction per operation node (``Add``, ``Sub``, ``Mul``,
``Neg``) and one ``FOLD`` per place of a node among the constraints.  An
instruction is four int32 words ``(op, dst, a, b)``:

* ``op`` names the operation and the base/ext kinds of its operands, so the
  promotions of ``EvalContext.vadd``/``vsub``/``vmul`` are fixed when the tape
  is compiled, not found at run time (a commuted base*ext is ``MUL_EB`` with
  its operands swapped);
* ``dst`` is the result's slot, in the base or the ext pool by the result's
  kind; a ``FOLD``'s ``dst`` is the word of alpha^k in the uniform table;
* ``a`` and ``b`` are operand words: a kind in the top four bits, an index
  below.  Leaves take no slot: a ``Var`` is read where it lies (local or next
  row of a segment), a ``Selector`` is computed per row, and ``Const``,
  ``Public``, ``Challenge``, ``CumSumLocal`` and ``GlobalSumCoord`` are words
  of the uniform table.

Slots are reused after a value's last reader (the reader counts of
``_schedule``); an instruction may write the slot of one of its own operands,
which both evaluators read first.  So the slots a row needs are at most the
values ``fold_constraints`` holds at once.

The uniform table (``uniforms``) is one int32 vector a launch:
``[Z_H by row class (2^lqd) | 1/Z_H (2^lqd) | global sum (14) | challenges
(2 x 4) | cumulative sum (4) | alpha^k (4 per constraint) | constants | publics]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..ops import ext4, field as f
from . import air

(ADD_BB, SUB_BB, MUL_BB, NEG_B, ADD_EE, SUB_EE, MUL_EE, NEG_E,
 ADD_EB, SUB_EB, SUB_BE, MUL_EB, FOLD_B, FOLD_E) = range(14)

# operand kinds, in the top four bits of an operand word
(K_BSLOT, K_ESLOT, K_UNI, K_MAIN, K_MAIN_NEXT, K_PREP, K_PREP_NEXT,
 K_PERM, K_PERM_NEXT, K_SEL) = range(10)
INDEX_BITS = 28
INDEX_MASK = (1 << INDEX_BITS) - 1

_VAR_KINDS = {(air.MAIN, 0): K_MAIN, (air.MAIN, 1): K_MAIN_NEXT,
              (air.PREPROCESSED, 0): K_PREP, (air.PREPROCESSED, 1): K_PREP_NEXT,
              (air.PERM, 0): K_PERM, (air.PERM, 1): K_PERM_NEXT}
_BINOPS = {air.Add: (ADD_BB, ADD_EE), air.Sub: (SUB_BB, SUB_EE), air.Mul: (MUL_BB, MUL_EE)}


def operand(kind: int, index: int) -> int:
    """An operand word as the int32 the tape stores."""
    assert 0 <= index <= INDEX_MASK, index
    w = kind << INDEX_BITS | index
    return w - (1 << 32) if w >= 1 << 31 else w


def split(word: int) -> tuple[int, int]:
    w = word & 0xFFFFFFFF
    return w >> INDEX_BITS, w & INDEX_MASK


@dataclass
class Tape:
    code: np.ndarray  # (n_instr, 4) int32: op, dst, a, b
    consts: list  # Montgomery words, in the uniform table at ``CONSTS``
    n_base: int  # base slots a row needs
    n_ext: int  # ext slots a row needs
    n_constraints: int
    lqd: int  # the chip's log quotient degree (the row classes of Z_H)
    invert: bool  # reads FIRST or LAST: the evaluator inverts once a row
    reads: frozenset  # the segments read (air.MAIN, air.PREPROCESSED, air.PERM)
    n_publics: int  # 1 + the highest public index read (0: none)
    global_sum: bool  # reads GlobalSumCoord
    _code_on: dict = dc_field(default_factory=dict, repr=False)

    @property
    def n_instr(self) -> int:
        return self.code.shape[0]

    # offsets into the uniform table
    @property
    def ZH(self) -> int:
        return 0

    @property
    def INV_ZH(self) -> int:
        return 1 << self.lqd

    @property
    def GSUM(self) -> int:
        return 2 << self.lqd

    @property
    def CHAL(self) -> int:
        return self.GSUM + 14

    @property
    def CUM(self) -> int:
        return self.CHAL + 8

    @property
    def APOW(self) -> int:
        return self.CUM + 4

    @property
    def CONSTS(self) -> int:
        return self.APOW + 4 * self.n_constraints

    @property
    def PUBLICS(self) -> int:
        return self.CONSTS + len(self.consts)

    def code_on(self, device) -> torch.Tensor:
        """The code as an int32 tensor on ``device``, copied there once."""
        key = str(torch.device(device))
        t = self._code_on.get(key)
        if t is None:
            t = self._code_on[key] = torch.from_numpy(self.code).to(device)
        return t


def compile_tape(constraints, lqd: int) -> Tape:
    """The tape of ``fold_constraints(constraints, ...)`` over a quotient
    domain of 2^lqd row classes."""
    order, readers = air._schedule(constraints)
    consts: dict = {}
    for e in order:
        if isinstance(e, air.Const):
            consts.setdefault(f.to_monty_int(e.value), len(consts))
    tape = Tape(np.zeros((0, 4), np.int32), list(consts), 0, 0, len(constraints), lqd,
                False, frozenset(), 0, False)
    reads, n_pub, invert, gsum = set(), 0, False, False

    def leaf(e) -> tuple[int, bool]:
        nonlocal n_pub, invert, gsum
        if isinstance(e, air.Var):
            reads.add(e.segment)
        elif isinstance(e, air.Public):
            n_pub = max(n_pub, e.index + 1)
        elif isinstance(e, air.GlobalSumCoord):
            gsum = True
        elif isinstance(e, air.Selector):
            invert |= e.which != air.Selector.TRANSITION
        return _leaf(e, tape, consts)

    def place(k: int, word: int, ext: bool) -> tuple:
        return (FOLD_E if ext else FOLD_B, tape.APOW + 4 * k, word, 0)

    code, (tape.n_base, tape.n_ext) = emit(constraints, order, readers, leaf, place)
    tape.code = np.array(code, dtype=np.int64).astype(np.int32).reshape(-1, 4)
    tape.reads, tape.n_publics, tape.invert, tape.global_sum = frozenset(reads), n_pub, invert, gsum
    return tape


def emit(roots, order, readers, leaf, place) -> tuple[list, list]:
    """The instructions of the DAG under ``roots`` (``order``, ``readers``:
    ``air._schedule(roots)``): one for each operation node, into a slot of its
    kind that is free again after its last reader, and ``place(k, word,
    is_ext)`` for the k-th root, where ``leaf(e)`` gives a leaf's (operand
    word, is_ext).  Returns the instructions and the base and ext slots a row
    needs.  The LogUp tape (``logup_tape.py``) is emitted by it too."""
    places: dict = {}
    for k, c in enumerate(roots):
        places.setdefault(id(c), []).append(k)
    code: list = []
    ref: dict = {}  # id(node) -> (operand word, is_ext) while the node has readers
    free: tuple = ([], [])  # released slots, base and ext
    count = [0, 0]

    def release(word: int):
        kind, idx = split(word)
        if kind == K_BSLOT:
            free[0].append(idx)
        elif kind == K_ESLOT:
            free[1].append(idx)

    for e in order:
        kids = air._children(e)
        if kids:
            vals = [ref[id(c)] for c in kids]
            for c in kids:
                readers[id(c)] -= 1
                if not readers[id(c)]:
                    release(ref.pop(id(c))[0])
            op, ext, a, b = _instruction(e, vals)
            pool = free[ext]
            if pool:
                dst = pool.pop()
            else:
                dst, count[ext] = count[ext], count[ext] + 1
            code.append((op, dst, a, b))
            ref[id(e)] = (operand(K_ESLOT if ext else K_BSLOT, dst), ext)
        else:
            ref[id(e)] = leaf(e)
        word, ext = ref[id(e)]
        for k in places.get(id(e), ()):
            code.append(place(k, word, ext))
            readers[id(e)] -= 1
        if not readers[id(e)]:
            release(ref.pop(id(e))[0])
    assert not ref, "every value has been read"
    return code, count


def _leaf(e, tape: Tape, consts: dict) -> tuple[int, bool]:
    if isinstance(e, air.Var):
        if (e.segment, e.offset) not in _VAR_KINDS:
            raise ValueError(f"no row offset {e.offset} of segment {e.segment} on the tape")
        return operand(_VAR_KINDS[e.segment, e.offset], e.col), e.segment == air.PERM
    if isinstance(e, air.Const):
        return operand(K_UNI, tape.CONSTS + consts[f.to_monty_int(e.value)]), False
    if isinstance(e, air.Selector):
        return operand(K_SEL, e.which), False
    if isinstance(e, air.Public):
        return operand(K_UNI, tape.PUBLICS + e.index), False
    if isinstance(e, air.Challenge):
        return operand(K_UNI, tape.CHAL + 4 * e.index), True
    if isinstance(e, air.CumSumLocal):
        return operand(K_UNI, tape.CUM), True
    if isinstance(e, air.GlobalSumCoord):
        return operand(K_UNI, tape.GSUM + e.index), False
    raise TypeError(type(e))


def _instruction(e, vals) -> tuple[int, bool, int, int]:
    """(op, result is ext, a, b) of an operation node on its operands."""
    if isinstance(e, air.Neg):
        (a, ext), = vals
        return (NEG_E if ext else NEG_B), ext, a, 0
    (a, ea), (b, eb) = vals
    base_op, ext_op = _BINOPS[type(e)]
    if ea == eb:
        return (ext_op if ea else base_op), ea, a, b
    if isinstance(e, air.Sub):
        return (SUB_EB, True, a, b) if ea else (SUB_BE, True, a, b)
    op = ADD_EB if isinstance(e, air.Add) else MUL_EB
    return (op, True, a, b) if ea else (op, True, b, a)


def chip_tape(chip) -> Tape:
    """The chip's tape, compiled once and kept on the chip."""
    tape = getattr(chip, "_quotient_tape", None)
    if tape is None:
        tape = chip._quotient_tape = compile_tape(chip.constraints, chip.log_quotient_degree)
    return tape


# --- the launch's uniform values ---------------------------------------------


def _words(t, n: int | None = None) -> list:
    """Field words of a tensor, array or list as Python ints (flattened)."""
    if t is None:
        return [0] * (n or 0)
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().reshape(-1).tolist()
    else:
        t = np.asarray(t).reshape(-1).tolist()
    return [int(x) & 0xFFFFFFFF for x in t]


def vanishing_classes(log_h: int, lqd: int) -> tuple[list, list]:
    """Z_H(x) = x^H - 1 on the quotient domain g * <w_N> (N = H << lqd) and
    its inverse, Montgomery, by the class r mod 2^lqd of the row: x^H =
    g^H * w_{2^lqd}^r takes 2^lqd values."""
    gh = pow(f.GENERATOR, 1 << log_h, f.P)
    w = f.two_adic_generator_int(lqd)
    zh = [(gh * pow(w, j, f.P) - 1) % f.P for j in range(1 << lqd)]
    return [f.to_monty_int(z) for z in zh], [f.to_monty_int(f.inv_int(z)) for z in zh]


def uniforms(tape: Tape, log_h: int, publics, challenges, cum_sum, global_sum, alpha) -> torch.Tensor:
    """The launch's uniform table (see the module's docstring), a CPU int32
    tensor.  Arguments as ``EvalContext`` takes them, Montgomery."""
    zh, inv_zh = vanishing_classes(log_h, tape.lqd)
    pub = _words(publics)
    if tape.n_publics > len(pub):
        raise ValueError(f"the constraints read public value {tape.n_publics - 1}, "
                         f"{len(pub)} given")
    if tape.global_sum and global_sum is None:
        raise ValueError("the constraints read the global sum, none given")
    chal = [w for c in (challenges or [None, None]) for w in _words(c, 4)]
    apows = ext4.powers_host(alpha, tape.n_constraints) if tape.n_constraints else []
    words = (zh + inv_zh + _words(global_sum, 14) + chal + _words(cum_sum, 4)
             + _words(apows) + tape.consts + pub)
    assert len(words) == tape.PUBLICS + len(pub)
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32))


def coset_params(log_h: int, lqd: int) -> dict:
    """The Montgomery constants of the quotient domain g * <w_N>: its
    generator, shift, and the last point w_H^-1 of the trace domain."""
    return {
        "omega": f.to_monty_int(f.two_adic_generator_int(log_h + lqd)),
        "shift": f.to_monty_int(f.GENERATOR),
        "last": f.to_monty_int(f.inv_int(f.two_adic_generator_int(log_h))),
    }


# --- the plain evaluator ------------------------------------------------------


def fold_chunks_plain(tape: Tape, main_q, prep_q, perm_q, uni: torch.Tensor, log_h: int) -> torch.Tensor:
    """The fold kernel's result in plain torch on any device: the tape run
    over every row of the quotient domain at once, the alpha-folded sum
    times 1/Z_H, as (2^lqd, H, 4) int32 chunks (row r in chunk r mod 2^lqd,
    row r >> lqd).  ``main_q``, ``prep_q``: (N, w) int32; ``perm_q``:
    (N, 4 * ext columns); ``uni``: ``uniforms``' table."""
    lqd = tape.lqd
    n = main_q.shape[0]
    step = 1 << lqd
    dev = main_q.device
    rows = torch.arange(n, device=dev)
    nxt = (rows + step) % n
    w64 = lambda t: None if t is None else t.to(torch.int64)
    perm = None if perm_q is None else w64(perm_q).view(n, -1, 4)
    segs = {K_MAIN: w64(main_q), K_PREP: w64(prep_q), K_PERM: perm}
    segs.update({K_MAIN_NEXT: segs[K_MAIN][nxt],
                 K_PREP_NEXT: None if prep_q is None else segs[K_PREP][nxt],
                 K_PERM_NEXT: None if perm is None else perm[nxt]})
    uni = w64(uni.to(dev)) & 0xFFFFFFFF
    cls = rows & (step - 1)

    c = coset_params(log_h, lqd)
    x = f.mul64(f.batch_powers(f.from_monty_int(c["omega"]), n, dev), c["shift"])
    zh = uni[tape.ZH + cls]
    x_last = f.sub64(x, c["last"])
    sels = {air.Selector.TRANSITION: x_last}
    if tape.invert:
        sels[air.Selector.FIRST] = f.mul64(zh, w64(f.inv(f.sub64(x, f.ONE))))
        sels[air.Selector.LAST] = f.mul64(zh, w64(f.inv(x_last)))

    P, R = f.P, f.R_INV
    add = lambda x, y: (x + y) % P
    sub = lambda x, y: (x - y) % P
    mul = lambda x, y: x * y % P * R % P
    emul = lambda x, y: ext4._mul64(x, y) % P

    def lift(x):  # base -> ext (x, 0, 0, 0)
        z = torch.zeros_like(x)
        return torch.stack([x, z, z, z], dim=-1)

    # op -> (a is ext, b is ext, the result from the operands' values)
    ops = {
        ADD_BB: (False, False, add), SUB_BB: (False, False, sub), MUL_BB: (False, False, mul),
        NEG_B: (False, False, lambda x, _: (-x) % P),
        ADD_EE: (True, True, add), SUB_EE: (True, True, sub), MUL_EE: (True, True, emul),
        NEG_E: (True, True, lambda x, _: (-x) % P),
        ADD_EB: (True, False, lambda x, y: add(x, lift(y))),
        SUB_EB: (True, False, lambda x, y: sub(x, lift(y))),
        SUB_BE: (False, True, lambda x, y: sub(lift(x), y)),
        MUL_EB: (True, False, lambda x, y: mul(x, y[..., None])),
    }
    vals: dict = {}  # operand word -> value: the slots' current values, and every leaf read

    def get(word: int, ext: bool) -> torch.Tensor:
        v = vals.get(word)
        if v is None:
            kind, idx = split(word)
            if kind == K_UNI:
                v = uni[idx : idx + 4] if ext else uni[idx]
            elif kind == K_SEL:
                v = sels[idx]
            else:
                v = segs[kind][:, idx, :] if ext else segs[kind][:, idx]
            vals[word] = v
        return v

    acc = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    for op, dst, a, b in tape.code.tolist():
        if op == FOLD_B:
            acc = acc + mul(uni[dst : dst + 4], get(a, False)[..., None])
        elif op == FOLD_E:
            acc = acc + emul(get(a, True), uni[dst : dst + 4])
        elif op in ops:
            ea, eb, fn = ops[op]
            v = fn(get(a, ea), None if op in (NEG_B, NEG_E) else get(b, eb))
            vals[operand(K_ESLOT if ea or eb else K_BSLOT, dst)] = v
        else:
            raise ValueError(f"unknown opcode {op}")
    q = f.mul64(acc % f.P, uni[tape.INV_ZH + cls][:, None])
    return f.narrow(q.view(n >> lqd, step, 4).transpose(0, 1).contiguous())
