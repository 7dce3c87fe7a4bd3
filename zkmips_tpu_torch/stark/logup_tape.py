"""A chip's local lookups compiled to a tape, the program of the LogUp
kernels (``csrc/logup.cu``).

``compile_logup`` walks the lookups' value and multiplicity expressions once,
as one DAG, with ``quotient_tape``'s emitter: the same instruction words
``(op, dst, a, b)``, operand kinds and slot allocator.  The expressions read
the local row of the main and preprocessed traces and constants only, so
every operation is a base one (``ADD_BB``, ``SUB_BB``, ``MUL_BB``,
``NEG_B``).  Three opcodes of its own build each lookup's denominator and
multiplicity, lookup ``i`` in the order of ``permutation._lookup_chunks``
(sends, then receives):

* ``LK_OPEN  (i, c)``: D_i = alpha + constant c (the argument index), first;
* ``LK_DEN   (i, v, k)``: D_i += beta^k * v, for the k-th value (k from 1);
* ``LK_MULT  (i, m, s)``: m_i = m, or -m where ``s`` (a receive).

A constant is a word of the tape's own table (``consts``, kind ``K_UNI``);
alpha and the powers of beta are the launch's challenge table
(``challenge_table``: ``[alpha | beta^0 | beta^1 | ...]``, ext words), one a
shard for every chip.  The kernel then inverts the D_i as the eager path
does and sums the signed fractions by chunks of ``batch_size`` lookups.  The
tape never names a chip.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..ops import ext4, field as f
from . import air, permutation
from .quotient_tape import K_MAIN, K_PREP, K_UNI, emit, operand

LK_OPEN, LK_DEN, LK_MULT = 14, 15, 16

_SEGMENTS = {air.MAIN: K_MAIN, air.PREPROCESSED: K_PREP}


@dataclass
class LogUpTape:
    code: np.ndarray  # (n_instr, 4) int32: op, dst, a, b
    consts: np.ndarray  # int32 Montgomery words, the table of K_UNI operands
    n_base: int  # base slots a row needs for the expressions' values
    n_lookups: int
    batch_size: int  # lookups a chunk: one perm column each
    n_pows: int  # the powers of beta read: beta^0 .. beta^(n_pows - 1)
    reads: frozenset  # the segments read (air.MAIN, air.PREPROCESSED)
    n_cols: int  # distinct trace columns read
    _on: dict = dc_field(default_factory=dict, repr=False)

    @property
    def n_instr(self) -> int:
        return self.code.shape[0]

    @property
    def n_chunks(self) -> int:
        return -(-self.n_lookups // self.batch_size)

    @property
    def width(self) -> int:
        """The permutation trace's ext columns: the chunks, then the running sum."""
        return self.n_chunks + 1

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The code and the constants as int32 tensors on ``device``, copied
        there once."""
        key = str(torch.device(device))
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = (torch.from_numpy(self.code).to(device),
                                 torch.from_numpy(self.consts).to(device))
        return t


def compile_logup(chip, batch_size: int) -> LogUpTape:
    """The tape of the chip's local lookups in chunks of ``batch_size``."""
    sends, receives = permutation.local_lookups(chip)
    items = [lk for chunk in permutation._lookup_chunks(sends, receives, batch_size) for lk in chunk]
    roots, ends = [], []  # the expressions, and where each ends: (opcode, lookup, k or sign)
    for i, (lookup, is_send) in enumerate(items):
        for k, v in enumerate(lookup.values, 1):
            roots.append(v)
            ends.append((LK_DEN, i, k))
        roots.append(lookup.multiplicity)
        ends.append((LK_MULT, i, 0 if is_send else 1))
    consts: dict = {}

    def const(value: int) -> int:
        return operand(K_UNI, consts.setdefault(f.to_monty_int(value), len(consts)))

    code = [(LK_OPEN, i, const(lookup.argument_index), 0) for i, (lookup, _) in enumerate(items)]
    cols: set = set()

    def leaf(e) -> tuple[int, bool]:
        if isinstance(e, air.Const):
            return const(e.value), False
        if isinstance(e, air.Var) and e.segment in _SEGMENTS and e.offset == 0:
            cols.add((e.segment, e.col))
            return operand(_SEGMENTS[e.segment], e.col), False
        raise ValueError(f"a lookup of {chip.name} reads {e!r}: only the local main and "
                         f"preprocessed rows and constants are on the LogUp tape")

    def place(k: int, word: int, ext: bool) -> tuple:
        op, i, arg = ends[k]
        return (op, i, word, arg)

    order, readers = air._schedule(roots)
    body, (n_base, n_ext) = emit(roots, order, readers, leaf, place)
    assert n_ext == 0, "lookup expressions are base values"
    code = np.array(code + body, dtype=np.int64).astype(np.int32).reshape(-1, 4)
    return LogUpTape(
        code, np.array(list(consts), dtype=np.uint32).view(np.int32), n_base, len(items), batch_size,
        1 + max((len(l.values) for l, _ in items), default=0),
        frozenset(seg for seg, _ in cols), len(cols))


def chip_logup(chip, batch_size: int) -> LogUpTape:
    """The chip's LogUp tape at ``batch_size``, compiled once and kept on the chip."""
    tapes = chip.__dict__.setdefault("_logup_tapes", {})
    tape = tapes.get(batch_size)
    if tape is None:
        tape = tapes[batch_size] = compile_logup(chip, batch_size)
    return tape


def challenge_table(alpha, beta, n_pows: int) -> torch.Tensor:
    """``[alpha | beta^0 | ... | beta^(n_pows - 1)]`` as a CPU int32 (1 + n_pows, 4)."""
    alpha = torch.as_tensor(alpha, dtype=torch.int32).cpu().reshape(1, 4)
    return torch.cat([alpha, ext4.powers_host(beta, max(n_pows, 1))], dim=0)
