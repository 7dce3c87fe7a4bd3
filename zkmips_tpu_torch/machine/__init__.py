"""The MIPS core machine: AIR chips + machine assembly.

The analog of the reference's crates/core/machine: each MIPS instruction
class gets a chip (trace builder + constraints) wired to the CPU chip through
LogUp lookups; memory consistency uses local Memory lookups bridged to the
septic-curve global argument by the MemoryLocal / MemoryGlobal{Init,Finalize}
/ Global chips.  The port has the reference's 49 chips (``core_chip_airs``).
"""

from .machine import MipsMachine, mips_machine, prove_program, verify_program

__all__ = ["MipsMachine", "mips_machine", "prove_program", "verify_program"]
