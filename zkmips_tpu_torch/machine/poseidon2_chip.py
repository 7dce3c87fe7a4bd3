"""Poseidon2Permute precompile chip: one row per syscall event.

Analog of crates/core/machine/src/syscall/precompiles/poseidon2: the 16-word
state at state_ptr is permuted in place; the write-access gadgets' previous
values are the permutation input.  External-round outputs and internal
lane-0 s-boxes are witnessed (linear layers stay expressions, as in the
recursion Poseidon2 chip); written limbs are constrained below p so the
canonical output has a unique u32 representation.
"""

from __future__ import annotations

import numpy as np

from ..utils.pool import zeros_mt

from ..executor.opcodes import SyscallCode
from ..ops import field as ff, poseidon2 as p2
from ..ops.poseidon2 import ROUNDS_P
from ..stark.air import AirBuilder, LookupKind
from ..stark.chip import BaseAir
from .gadgets import ByteSink, ColView, Schema, eval_memory_access, populate_access, send_u16_check
from .lookups import syscall_msg
from .words import WordExpr

# the permutation's constants as Montgomery uint32 arrays, indexed as the
# reference's ops/poseidon2.py holds them
RC_EXT_FIRST = np.array(p2.RC_EXT_FIRST, dtype=np.uint32)  # (4, 16)
RC_INTERNAL = np.array(p2.RC_INTERNAL, dtype=np.uint32)  # (13,)
RC_EXT_SECOND = np.array(p2.RC_EXT_SECOND, dtype=np.uint32)  # (4, 16)
DIAG = np.array(p2.DIAG, dtype=np.uint32)


# Helpers the reference shares with its recursion Poseidon2 chip
# (recursion/chips.py:276-315); the port keeps its own copies here.


def _canon(monty_u32) -> int:
    return ff.from_monty_int(int(monty_u32))


def _ext_linear_expr(cols):
    out = list(cols)
    for i in range(0, 16, 4):
        s0, s1, s2, s3 = out[i], out[i + 1], out[i + 2], out[i + 3]
        t01 = s0 + s1
        t23 = s2 + s3
        t0123 = t01 + t23
        t01123 = t0123 + s1
        t01233 = t0123 + s3
        out[i + 3] = t01233 + 2 * s0
        out[i + 1] = t01123 + 2 * s2
        out[i] = t01123 + t01
        out[i + 2] = t01233 + t23
    sums = []
    for k in range(4):
        acc = out[k]
        for j in range(4, 16, 4):
            acc = acc + out[j + k]
        sums.append(acc)
    return [out[j] + sums[j % 4] for j in range(16)]


def _ext_linear_int(state_monty):
    """The external MDS-light layer on 16 Montgomery ints."""
    return p2._ext_linear_ints([int(x) for x in state_monty])


def _sbox_int(x_monty: int, rc_monty: int) -> int:
    v = (ff.from_monty_int(x_monty) + ff.from_monty_int(rc_monty)) % ff.P
    return ff.to_monty_int(pow(v, 3, ff.P))


CODE = SyscallCode.POSEIDON2_PERMUTE
ID_LO = int(CODE) & 0xFFFF
ID_HI = int(CODE) >> 16
P_HI = ff.P >> 16  # 0x7F00


class Poseidon2ChipAir(BaseAir):
    name = "Poseidon2Permute"

    def included(self, record) -> bool:
        return bool(record.precompile_events.get("poseidon2"))

    def __init__(self):
        names = ["shard", "clk", "ptr_lo", "ptr_hi", "is_real"]
        for r in range(8):
            names += [f"x{r}_{i}" for i in range(16)]
        names += [f"t{r}" for r in range(ROUNDS_P)]
        names += [f"w{i}_{l}" for i in range(16) for l in ("lo", "hi")]
        names += [f"z{i}" for i in range(16)] + [f"zi{i}" for i in range(16)]
        s = Schema(names)
        for i in range(16):
            s.names.extend(s.access_cols(f"m{i}"))
        self.schema = Schema(s.names)
        self.main_width = self.schema.width

    def eval(self, b: AirBuilder):
        col = ColView(b, self.schema)
        is_real = col("is_real")
        b.assert_bool(is_real)
        shard, clk = col("shard"), col("clk")
        ptr = col.word("ptr")
        b.receive(
            LookupKind.Syscall,
            syscall_msg(shard, clk, ID_LO, ID_HI, ptr, (0, 0)),
            is_real,
        )
        send_u16_check(b, ptr.lo, is_real)
        send_u16_check(b, (ptr.hi + 256) * 2, is_real)

        # the 16 state writes at clk; inputs are the gadgets' previous values
        inputs = []
        for i in range(16):
            w = col.word(f"w{i}")
            addr = ptr.value_expr() + 4 * i
            eval_memory_access(b, col, f"m{i}", shard, clk, addr, w, is_real)
            prev = col.word(f"m{i}_prev")
            inputs.append(prev.lo + prev.hi * 65536)
            # written value below p: w_hi <= P_HI, and w_lo == 0 when w_hi == P_HI
            send_u16_check(b, P_HI - w.hi, is_real)
            z, zi = col(f"z{i}"), col(f"zi{i}")
            b.assert_bool(z)
            b.assert_zero(z * (w.hi - P_HI))
            b.when(is_real).assert_zero(z + (w.hi - P_HI) * zi - 1)
            # the only canonical u32 with hi == 0x7F00 is p - 1 (lo == 0)
            b.when(z).assert_zero(w.lo)

        # permutation witness (same structure as the recursion Poseidon2 chip)
        state = _ext_linear_expr(inputs)
        widx = 0
        for r in range(4):
            sb = [col(f"x{widx}_{i}") for i in range(16)]
            for i in range(16):
                e = state[i] + int(_canon(RC_EXT_FIRST[r, i]))
                b.when(is_real).assert_eq(sb[i], e * e * e)
            state = _ext_linear_expr(sb)
            widx += 1
        for r in range(ROUNDS_P):
            t = col(f"t{r}")
            e = state[0] + int(_canon(RC_INTERNAL[r]))
            b.when(is_real).assert_eq(t, e * e * e)
            state = [t] + state[1:]
            total = state[0]
            for s_ in state[1:]:
                total = total + s_
            state = [state[i] * int(_canon(DIAG[i])) + total for i in range(16)]
        for r in range(4):
            sb = [col(f"x{widx}_{i}") for i in range(16)]
            for i in range(16):
                e = state[i] + int(_canon(RC_EXT_SECOND[r, i]))
                b.when(is_real).assert_eq(sb[i], e * e * e)
            state = _ext_linear_expr(sb)
            widx += 1
        # outputs == written values (as field elements; uniqueness from the
        # below-p constraint)
        for i in range(16):
            w = col.word(f"w{i}")
            b.when(is_real).assert_eq(w.lo + w.hi * 65536, state[i])

    def generate_trace(self, record, output):
        events = record.precompile_events.get("poseidon2", [])
        s = self.schema
        t = zeros_mt((len(events), s.width), dtype=np.uint32, order="F")
        sink = ByteSink(record)
        for i, ev in enumerate(events):
            t[i, s.idx("shard")] = ev["shard"]
            t[i, s.idx("clk")] = ev["clk"]
            ptr = ev["ptr"]
            t[i, s.idx("ptr_lo")], t[i, s.idx("ptr_hi")] = ptr & 0xFFFF, ptr >> 16
            t[i, s.idx("is_real")] = 1
            sink.u16(np.array([ptr & 0xFFFF], dtype=np.uint32))
            sink.u16(np.array([((ptr >> 16) + 256) * 2], dtype=np.uint32))
            for j, rec in enumerate(ev["records"]):
                w = rec.value
                t[i, s.idx(f"w{j}_lo")], t[i, s.idx(f"w{j}_hi")] = w & 0xFFFF, w >> 16
                sink.u16(np.array([P_HI - (w >> 16)], dtype=np.uint32))
                if (w >> 16) == P_HI:
                    t[i, s.idx(f"z{j}")] = 1
                else:
                    t[i, s.idx(f"zi{j}")] = ff.inv_int(((w >> 16) - P_HI) % ff.P)
                populate_access(
                    t, s, np.array([i]), f"m{j}",
                    np.array([rec.prev_shard]), np.array([rec.prev_timestamp]),
                    np.array([rec.prev_value]),
                    np.array([ev["shard"]]), np.array([rec.timestamp]), sink,
                )
            # permutation witnesses
            state = [ff.to_monty_int(v) for v in ev["pre_state"]]
            state = _ext_linear_int(state)
            widx = 0
            for r in range(4):
                state = [_sbox_int(x, int(RC_EXT_FIRST[r, j])) for j, x in enumerate(state)]
                for j in range(16):
                    t[i, s.idx(f"x{widx}_{j}")] = ff.from_monty_int(state[j])
                state = _ext_linear_int(state)
                widx += 1
            for r in range(ROUNDS_P):
                s0 = _sbox_int(state[0], int(RC_INTERNAL[r]))
                t[i, s.idx(f"t{r}")] = ff.from_monty_int(s0)
                state = [s0] + state[1:]
                total = sum(ff.from_monty_int(x) for x in state) % ff.P
                state = [
                    ff.to_monty_int((ff.from_monty_int(x) * ff.from_monty_int(int(DIAG[j])) + total) % ff.P)
                    for j, x in enumerate(state)
                ]
            for r in range(4):
                state = [_sbox_int(x, int(RC_EXT_SECOND[r, j])) for j, x in enumerate(state)]
                for j in range(16):
                    t[i, s.idx(f"x{widx}_{j}")] = ff.from_monty_int(state[j])
                state = _ext_linear_int(state)
                widx += 1
        return t
