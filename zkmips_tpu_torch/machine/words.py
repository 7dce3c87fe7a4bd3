"""Word representation: u32 values as (lo16, hi16) field-element limb pairs.

The reference packs words as 4 byte-limbs (zkm_stark::Word); we use 2 x 16-bit
limbs — half the columns, and every limb is directly checkable against the
2^16-row byte table (U16Range).  u32 values cannot live in a single KoalaBear
element (p = 2^31 - 2^24 + 1 < 2^32), so limbed representation is forced.
"""

from __future__ import annotations

import numpy as np


def split_u32(x):
    """u32 -> (lo16, hi16); works on python ints and numpy arrays."""
    if isinstance(x, np.ndarray):
        return (x & np.uint32(0xFFFF), x >> np.uint32(16))
    return (x & 0xFFFF, (x >> 16) & 0xFFFF)


def word_cols(events_u32: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    lo, hi = split_u32(events_u32.astype(np.uint32))
    return lo, hi


class WordExpr:
    """An AIR-side word: a pair of limb expressions."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        self.lo = lo
        self.hi = hi

    def values(self):
        return [self.lo, self.hi]

    def value_expr(self):
        """The (possibly > 16-bit-limbed) combined field value lo + hi*2^16."""
        return self.lo + self.hi * 65536
