"""Fixed proof shapes: pad chip heights to a finite, precompiled menu.

Analog of the reference's CoreShapeConfig (crates/core/machine/src/shape/
mod.rs:40-718 + maximal_shapes.json): every shard's chip heights are rounded
up so that proofs have one of finitely many layouts.  The reference package
uses the shape as its compiled-kernel cache key; the port keeps the same menu
because the heights are part of the proof, which must equal the reference's.

Two mechanisms, composed:

1. **Height lattice** (always applies, never misses): every chip height is
   rounded up to the lattice {2^4, 2^6, ..., 2^16, 2^17, ..., 2^22} — coarse
   steps below 2^16 where padding is cheap, every power of two above.  This
   bounds the per-chip kernel population to 13 heights regardless of guest.
2. **Joint shape menu** (corpus-derived, shapes_data.json via shape_gen.py):
   maximal per-chip heights per CPU-log bucket observed over a guest corpus.
   A fitting menu shape also pins the *multiset* of heights (hence the FRI
   fold-chain layout); fix_shape picks the cheapest candidate by padded area
   so a polluted bucket can never beat plain lattice padding.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

# coarse below 2^16 (padding there is cheap), exact above (padding is not)
LATTICE = (4, 6, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22)


def lattice_log(rows: int) -> int:
    for lg in LATTICE:
        if rows <= (1 << lg):
            return lg
    return max(23, int(rows - 1).bit_length())


@dataclass(frozen=True)
class Shape:
    log_heights: tuple  # sorted tuple of (chip_name, log_h)

    def log_h(self, name: str):
        for n, lh in self.log_heights:
            if n == name:
                return lh
        return None

    def fits(self, heights: dict) -> bool:
        """Every observed chip is pinned by this shape and fits under it."""
        for name, h in heights.items():
            lh = self.log_h(name)
            if lh is None or h > (1 << lh):
                return False
        return True

    def area(self, heights: dict, widths: dict | None = None) -> int:
        total = 0
        for name in heights:
            w = (widths or {}).get(name, 1)
            total += w << self.log_h(name)
        return total


def _shape(**kw) -> Shape:
    return Shape(tuple(sorted(kw.items())))


def lattice_shape(heights: dict) -> Shape:
    return Shape(tuple(sorted((n, lattice_log(h)) for n, h in heights.items())))


DATA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "shapes_data.json")


def load_menu(path: str = DATA_PATH) -> list[Shape]:
    if not os.path.exists(path):
        return []
    data = json.load(open(path))
    return [
        Shape(tuple(sorted(s["log_heights"].items()))) for s in data.get("shapes", [])
    ]


class ShapeConfig:
    def __init__(self, menu: list[Shape] | None = None):
        self.menu = menu if menu is not None else load_menu()

    def fix_shape(self, heights: dict, widths: dict | None = None) -> Shape:
        """Cheapest (by padded area) fitting candidate: corpus menu shapes
        that cover every observed chip, plus the always-available lattice
        shape (fix_shape, shape/mod.rs:71 — but total: never None)."""
        best = lattice_shape(heights)
        best_area = best.area(heights, widths)
        from_menu = False
        for shape in self.menu:
            if shape.fits(heights):
                a = shape.area(heights, widths)
                if a < best_area:
                    best, best_area, from_menu = shape, a, True
        # menu-hit accounting: a miss means this shard took the plain
        # lattice shape
        if from_menu:
            self.menu_hits = getattr(self, "menu_hits", 0) + 1
        else:
            self.menu_misses = getattr(self, "menu_misses", 0) + 1
        return best

    def fix_preprocessed_rows(self, rows: int) -> int:
        """Preprocessed (program-table) heights snap to the lattice too
        (fix_preprocessed_shape, shape/mod.rs:51): programs of similar size
        share proof layouts."""
        return 1 << lattice_log(rows)
