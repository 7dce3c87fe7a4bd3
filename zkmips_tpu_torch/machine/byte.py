"""Byte chip: 2^16-row preprocessed table of byte-pair operations + u16 range.

The analog of the reference's bytes chip (crates/core/machine/src/bytes/,
354 LoC): row i encodes the byte pair (b, c) = (i >> 8, i & 255) and the u16
value i; main trace is one multiplicity column per operation.
"""

from __future__ import annotations

import numpy as np

from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .lookups import ByteOpcode, byte_msg

NUM_ROWS = 1 << 16

_PRE = ["b8", "c8", "and", "or", "xor", "nor", "msb", "ltu", "u16", "pow2"]
_OPS = [
    (ByteOpcode.AND, lambda n: ("and", "b8", "c8")),
    (ByteOpcode.OR, lambda n: ("or", "b8", "c8")),
    (ByteOpcode.XOR, lambda n: ("xor", "b8", "c8")),
    (ByteOpcode.NOR, lambda n: ("nor", "b8", "c8")),
    (ByteOpcode.U16Range, lambda n: ("u16", None, None)),
    (ByteOpcode.U8Pair, lambda n: (None, "b8", "c8")),
    (ByteOpcode.MSB, lambda n: ("msb", "b8", None)),
    (ByteOpcode.LTU, lambda n: ("ltu", "b8", "c8")),
    (ByteOpcode.POW2, lambda n: ("pow2", "b8", None)),
]


class ByteAir(BaseAir):
    name = "Byte"
    preprocessed_width = len(_PRE)
    main_width = len(_OPS)
    # multiplicities come from the byte-lookup arrays the other chips' trace
    # fills append; must trace-gen after them (stark/machine.py trace pool)
    trace_consumes_fills = True

    def eval(self, b: AirBuilder):
        pre = {n: b.preprocessed(i) for i, n in enumerate(_PRE)}
        for col, (op, sel) in enumerate(_OPS):
            a_n, b_n, c_n = sel(None)
            msg = byte_msg(
                int(op),
                pre[a_n] if a_n else 0,
                pre[b_n] if b_n else 0,
                pre[c_n] if c_n else 0,
            )
            b.receive(LookupKind.Byte, msg, b.main(col))

    def generate_preprocessed(self, program):
        i = np.arange(NUM_ROWS, dtype=np.uint32)
        b8 = i >> 8
        c8 = i & 255
        t = np.zeros((NUM_ROWS, len(_PRE)), dtype=np.uint32)
        vals = {
            "b8": b8,
            "c8": c8,
            "and": b8 & c8,
            "or": b8 | c8,
            "xor": b8 ^ c8,
            "nor": (~(b8 | c8)) & 0xFF,
            "msb": b8 >> 7,
            "ltu": (b8 < c8).astype(np.uint32),
            "u16": i,
            "pow2": np.uint32(1) << (b8 & 7),
        }
        for k, v in vals.items():
            t[:, _PRE.index(k)] = v
        return t

    def generate_trace(self, record, output):
        t = np.zeros((NUM_ROWS, len(_OPS)), dtype=np.uint32)
        entries = record.byte_lookups.get("arrays", [])
        col_of = {int(op): ci for ci, (op, _sel) in enumerate(_OPS)}
        # accumulate per column with one bincount over the concatenated rows
        # (np.add.at is an order of magnitude slower per element)
        by_col: dict[int, list] = {}
        for op, a, bb, c in entries:
            if op == int(ByteOpcode.U16Range):
                rows = a
            elif op in (int(ByteOpcode.MSB), int(ByteOpcode.POW2)):
                rows = bb << 8
            else:
                rows = (bb << 8) | c
            by_col.setdefault(col_of[op], []).append(rows.astype(np.int64, copy=False))
        for ci, parts in by_col.items():
            rows = parts[0] if len(parts) == 1 else np.concatenate(parts)
            t[:, ci] += np.bincount(rows, minlength=NUM_ROWS).astype(np.uint32)
        return t

    def num_rows(self, record):
        return NUM_ROWS
