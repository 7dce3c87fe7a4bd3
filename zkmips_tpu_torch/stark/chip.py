"""Chip = AIR + trace generators + symbolic analysis (degree, lookups).

Evaluating the AIR symbolically yields the constraint DAG and the
send/receive lookups; the LogUp constraints are appended generically; the
maximum degree fixes ``log_quotient_degree``.
"""

from __future__ import annotations

import numpy as np

from . import air, permutation
from .air import AirBuilder, Scope


class BaseAir:
    """Base class for chip AIR definitions (subclass and override)."""

    name: str = "?"
    main_width: int = 0
    preprocessed_width: int = 0
    commit_scope: Scope = Scope.Local

    def eval(self, builder: AirBuilder):
        raise NotImplementedError

    def generate_trace(self, record, output):
        """(rows, main_width) canonical uint32 numpy trace."""
        raise NotImplementedError

    def generate_preprocessed(self, program):
        return None

    def generate_dependencies(self, record, output):
        """Emit derived events (e.g. byte lookups) into ``output``."""

    def included(self, record) -> bool:
        return True

    def num_rows(self, record) -> int:
        raise NotImplementedError


class Chip:
    def __init__(self, a: BaseAir, num_public_values: int = 0, batch_size: int = permutation.BATCH_SIZE):
        self.air = a
        self.batch_size = batch_size
        builder = AirBuilder(a.preprocessed_width, a.main_width, num_public_values)
        a.eval(builder)
        self.sends = builder.sends
        self.receives = builder.receives
        self.commit_scope = a.commit_scope
        self.main_width = a.main_width
        permutation.eval_permutation_constraints(self, builder, batch_size)
        self.constraints = builder.constraints
        cache: dict = {}
        self.constraint_degree = max(
            (air.expr_degree(c, cache) for c in self.constraints), default=1
        )
        self.log_quotient_degree = max(self.constraint_degree - 1, 1).bit_length() - 1
        if 1 << self.log_quotient_degree < max(self.constraint_degree - 1, 1):
            self.log_quotient_degree += 1

    @property
    def name(self) -> str:
        return self.air.name

    @property
    def preprocessed_width(self) -> int:
        return self.air.preprocessed_width

    @property
    def perm_width_ext(self) -> int:
        sends, receives = permutation.local_lookups(self)
        return permutation.perm_width(len(sends) + len(receives), self.batch_size)

    @property
    def quotient_chunks(self) -> int:
        return 1 << self.log_quotient_degree

    def __repr__(self):
        return (
            f"Chip({self.name}, w={self.main_width}, perm_w={self.perm_width_ext}, "
            f"deg={self.constraint_degree}, sends={len(self.sends)}, recvs={len(self.receives)})"
        )


def padded_height(h: int, min_rows: int = 16) -> int:
    """The power-of-two height (>= min_rows) a trace of h rows is padded to."""
    if h and h & (h - 1) == 0 and h >= min_rows:
        return h
    return max(min_rows, 1 << max(h - 1, 1).bit_length())


def pad_to_power_of_two(trace: np.ndarray, min_rows: int = 16, fixed_rows: int | None = None) -> np.ndarray:
    """Zero-pad a host trace to ``padded_height`` rows, or to ``fixed_rows``."""
    h = trace.shape[0]
    target = padded_height(h, min_rows) if fixed_rows is None else fixed_rows
    assert h <= target
    if h == target:
        return trace
    out = np.zeros((target, trace.shape[1]), dtype=trace.dtype)
    out[:h] = trace
    return out
