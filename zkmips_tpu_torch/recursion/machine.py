"""Recursion STARK machine: prove and verify recursion VM executions.

The reference's RecursionAir machines (crates/recursion/core/src/machine.rs
:39-153) over the generic stark layer; each recursion program gets its own
preprocessed commitment (pk/vk), like the reference's per-shape program
caches (crates/prover/src/lib.rs:366-438).  ``setup`` and ``prove`` run on
a CUDA device unless the caller passes another (``device="cpu"``);
``execute`` and ``verify`` are host work.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..stark.chip import Chip
from ..stark.machine import StarkConfig, StarkMachine
from . import native_runtime
from .chips import (
    RecBaseAluAir,
    RecBatchFRIAir,
    RecExpReverseBitsAir,
    RecExtAluAir,
    RecFriFoldAir,
    RecMemConstAir,
    RecMemVarAir,
    RecPoseidon2Air,
    RecPublicValuesAir,
    RecSelectAir,
)

NUM_PV = 8


class RecursionMachine:
    def __init__(self, config: StarkConfig | None = None, num_pv: int = NUM_PV):
        self.num_pv = num_pv
        self.airs = [
            RecMemConstAir(), RecMemVarAir(), RecBaseAluAir(), RecExtAluAir(),
            RecPoseidon2Air(), RecSelectAir(), RecFriFoldAir(), RecBatchFRIAir(),
            RecExpReverseBitsAir(), RecPublicValuesAir(num_pv),
        ]
        chips = [Chip(a, num_public_values=num_pv) for a in self.airs]
        self.machine = StarkMachine(config or StarkConfig.core(), chips, num_public_values=num_pv)

    def setup(self, program, device=None):
        return self.machine.setup(program, device=resolve_device(device))

    def execute(self, program, witness=()):
        """Run the recursion program on the C interpreter
        (``csrc/recursion_runtime.c``).  A failed build or run raises; a
        circuit assert raises ``AssertionError``.  There is no fallback to
        the Python interpreter (``runtime.RecursionRuntime``), which stays
        the reference the tests compare with."""
        return native_runtime.run(program, witness)

    def prove(self, pk, record, device=None):
        pvs = list(record.public_values)
        pvs += [0] * (self.num_pv - len(pvs))
        pv = np.array(pvs[: self.num_pv], dtype=np.uint32)
        return self.machine.prove_shard(pk, record, pv, device=device)

    def verify(self, vk, proof) -> bool:
        return self.machine.verify_shard(vk, proof)
