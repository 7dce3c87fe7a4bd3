"""Cost model: estimate per-shard trace area to bound shard size.

Analog of crates/core/executor/src/cost.rs (estimate_mips_event_counts :12,
estimate_mips_lde_size :96, pad_mips_event_counts :200) + the executor's
shape probes (executor.rs:2183-2272): instead of a static mips_costs.json
artifact, chip costs are derived once from the machine's own chips (main +
permutation + quotient columns, scaled by the FRI blowup), and the executor
consults the estimate every probe interval to bump the shard before its LDE
area outgrows memory.
"""

from __future__ import annotations

from .opcodes import (
    BRANCH_OPS,
    JUMP_OPS,
    LOAD_OPS,
    MISC_OPS,
    MOVCOND_OPS,
    STORE_OPS,
    Opcode,
)

O = Opcode

# opcode -> chip-family name (matches machine chip names)
_GROUP = {}
for op in (O.ADD, O.SUB):
    _GROUP[op] = "AddSub"
for op in (O.AND, O.OR, O.XOR, O.NOR):
    _GROUP[op] = "Bitwise"
for op in (O.SLT, O.SLTU):
    _GROUP[op] = "Lt"
for op in (O.SLL,):
    _GROUP[op] = "ShiftLeft"
for op in (O.SRL, O.SRA, O.ROR):
    _GROUP[op] = "ShiftRight"
for op in (O.MULT, O.MULTU, O.MUL):
    _GROUP[op] = "Mul"
for op in (O.DIV, O.DIVU, O.MOD, O.MODU):
    _GROUP[op] = "DivRem"
for op in (O.CLZ, O.CLO):
    _GROUP[op] = "CloClz"
for op in BRANCH_OPS:
    _GROUP[op] = "Branch"
for op in JUMP_OPS:
    _GROUP[op] = "Jump"
for op in LOAD_OPS | STORE_OPS:
    _GROUP[op] = "MemoryInstrs"
for op in MISC_OPS:
    _GROUP[op] = "MiscInstrs"
for op in MOVCOND_OPS:  # after MISC: MEQ/MNE live in the MovCond chip
    _GROUP[op] = "MovCond"
_GROUP[O.SYSCALL] = "SyscallInstrs"

BYTE_NUM_ROWS = 1 << 16


def chip_group(op) -> str | None:
    return _GROUP.get(op)


_COSTS_CACHE: dict = {}


def chip_costs(log_blowup: int = 1) -> dict:
    """chip name -> LDE cells per row (main + perm + quotient), cached."""
    key = log_blowup
    if key in _COSTS_CACHE:
        return _COSTS_CACHE[key]
    from ..machine.machine import core_chip_airs
    from ..stark.chip import Chip

    costs = {}
    for a in core_chip_airs():
        ch = Chip(a, num_public_values=20)
        main = a.main_width
        perm = ch.perm_width_ext * 4
        quotient = (1 << ch.log_quotient_degree) * 4
        costs[a.name] = (main + perm) * (1 << log_blowup) + quotient * (1 << log_blowup)
    _COSTS_CACHE[key] = costs
    return costs


def _npow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def estimate_lde_size(event_counts: dict, log_blowup: int = 1) -> int:
    """Estimated total LDE cells for a shard with the given per-chip event
    counts (chip name -> rows); fixed-height chips are always charged."""
    costs = chip_costs(log_blowup)
    cells = BYTE_NUM_ROWS * costs.get("Byte", 0)
    for name, n in event_counts.items():
        if n and name in costs:
            cells += _npow2(n) * costs[name]
    return cells
