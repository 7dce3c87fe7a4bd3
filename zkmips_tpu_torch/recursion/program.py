"""Recursion VM instruction set + program container.

Analog of crates/recursion/core/src/runtime/instruction.rs:9-23: a
straight-line program over a flat field-element memory; every variable has a
static address assigned by the compiler, every value is written exactly once
(SSA), and each write carries the number of future reads (the LogUp
multiplicity of its memory send).

Extension values occupy a block of 4 consecutive cells addressed by their
first cell.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class BaseOp(IntEnum):
    ADD = 0
    SUB = 1
    MUL = 2
    DIV = 3
    ASSERT_EQ = 4  # constrain in1 == in2; writes nothing (out/mult unused)


@dataclass(frozen=True, slots=True)
class MemConst:
    """Write an immediate (4-tuple block, base values padded) to memory."""

    addr: int
    value: tuple  # 4 canonical ints
    mult: int


@dataclass(frozen=True, slots=True)
class BaseAlu:
    op: BaseOp
    out: int
    in1: int
    in2: int
    mult: int


@dataclass(frozen=True, slots=True)
class ExtAlu:
    op: BaseOp
    out: int
    in1: int
    in2: int
    mult: int


@dataclass(frozen=True, slots=True)
class Poseidon2:
    """Permute 16 felts: out[i] <- perm(in[i])."""

    out: tuple  # 16 addrs
    inp: tuple  # 16 addrs
    mults: tuple  # 16 read-mults for the outputs


@dataclass(frozen=True, slots=True)
class HintBits:
    """Decompose mem[value_addr] (base) into its low ``num_bits`` bits,
    written LSB-first to ``output_addrs`` (runtime/instruction.rs HintBits)."""

    output_addrs: tuple
    value_addr: int
    mults: tuple


@dataclass(frozen=True, slots=True)
class HintExt2Felts:
    """Split an ext block into 4 felt blocks (HintExt2Felts)."""

    output_addrs: tuple  # 4 addrs
    value_addr: int
    mults: tuple


@dataclass(frozen=True, slots=True)
class Print:
    """Host-side debug print of a memory block; proves nothing."""

    addr: int
    label: str = ""


@dataclass(frozen=True, slots=True)
class FriFold:
    """FRI fold accumulator update (reference lib.rs:234-276 FriFoldInstr):
    per matrix m, with quotient q = (p_at_x[m] - p_at_z[m]) / (x - z):
      ro_out[m]        = ro_in[m] + alpha_pow_in[m] * q
      alpha_pow_out[m] = alpha_pow_in[m] * alpha
    """

    x: int              # base address
    z: int              # ext address
    alpha: int          # ext address
    mat_opening: tuple  # ext addrs, p(x) per matrix
    ps_at_z: tuple      # ext addrs, p(z) per matrix
    alpha_pow_input: tuple
    ro_input: tuple
    alpha_pow_output: tuple
    ro_output: tuple
    alpha_pow_mults: tuple
    ro_mults: tuple


@dataclass(frozen=True, slots=True)
class BatchFRI:
    """Batched FRI opening accumulation (runtime/mod.rs BatchFRI):
    acc = sum_m alpha_pow[m] * (p_at_z[m] - p_at_x[m]), p_at_x base-valued;
    one memory write of the final acc."""

    acc: int            # ext addr (output)
    p_at_x: tuple       # base addrs
    p_at_z: tuple       # ext addrs
    alpha_pow: tuple    # ext addrs
    acc_mult: int


@dataclass(frozen=True, slots=True)
class Select:
    """out1 = bit ? in2 : in1 ; out2 = bit ? in1 : in2 (runtime/instruction.rs Select)."""

    bit: int
    out1: int
    out2: int
    in1: int
    in2: int
    mult1: int
    mult2: int


@dataclass(frozen=True, slots=True)
class ExpReverseBitsLen:
    """out = base^(reverse_bits(exp_bits)) — the FRI x-recovery primitive."""

    out: int
    base: int
    bit_addrs: tuple
    mult: int


@dataclass(frozen=True, slots=True)
class Hint:
    """Pop one block from the witness stream into memory."""

    addr: int
    mult: int


@dataclass(frozen=True, slots=True)
class CommitPublicValues:
    addrs: tuple  # 8 felt addrs


@dataclass
class RecursionProgram:
    instructions: list
    memory_size: int
    num_public_values: int = 8
