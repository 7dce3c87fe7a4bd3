"""The recursion ladder: the recursion VM, its STARK machine, the in-circuit
shard verifier and the lift / compress / shrink / wrap aggregation
(the reference's ``zkmips_tpu/recursion``, ported)."""

from .builder import Builder
from .machine import RecursionMachine
from .program import RecursionProgram
from .runtime import RecursionRuntime

__all__ = ["Builder", "RecursionMachine", "RecursionProgram", "RecursionRuntime"]
