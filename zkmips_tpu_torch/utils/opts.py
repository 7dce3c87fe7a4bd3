"""Prover options with environment overrides.

Analog of the reference's ZKMProverOpts / ZKMCoreOpts (crates/stark/src/
opts.rs:42-227): the same env variable names are honored where the concept
carries over (SHARD_SIZE, SHARD_BATCH_SIZE, TRACE_GEN_WORKERS,
SPLIT_THRESHOLD); RAM-tiered defaults reduce to a single sensible default
here since trace memory is device-resident.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclass
class ZKMCoreOpts:
    shard_size: int = field(default_factory=lambda: _env_int("SHARD_SIZE", 1 << 20))
    shard_batch_size: int = field(default_factory=lambda: _env_int("SHARD_BATCH_SIZE", 2))
    trace_gen_workers: int = field(default_factory=lambda: _env_int("TRACE_GEN_WORKERS", 2))
    split_threshold: int = field(default_factory=lambda: _env_int("SPLIT_THRESHOLD", 1 << 15))
    max_lde_size: int = field(default_factory=lambda: _env_int("MAX_LDE_SIZE", 1 << 31))

    @staticmethod
    def default() -> "ZKMCoreOpts":
        return ZKMCoreOpts()
