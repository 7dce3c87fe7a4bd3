"""ctypes bridge to the native recursion-VM interpreter
(``csrc/recursion_runtime.c``, the reference's C++ runtime analog,
crates/recursion/core/src/sys.rs).

The program encodes once into a flat u32 opcode stream (cached on the
RecursionProgram), the C side executes it over write-once block memory
(canonical KoalaBear arithmetic incl. Poseidon2-16), and the chip event
record is reconstructed from the final memory image: every event value is
a memory read, except BatchFRI's running accumulators, which the C exports.
The source is compiled where it lies into ``build/native/`` at first use; a
failed build raises, and so does a failed run (a circuit assert as
``AssertionError``).  Held against the Python interpreter
(``runtime.RecursionRuntime``) by the tests.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..ops.poseidon2 import RC_16_30, _DIAG_CANON
from ..utils.cbuild import REPO_ROOT, build
from . import program as pr
from .runtime import RecursionRecord

_LIB = None
_SRC = os.path.join(str(REPO_ROOT), "csrc", "recursion_runtime.c")


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build(_SRC))
        lib.zkm_rec_run.restype = ctypes.c_int
        rc = np.array(RC_16_30, dtype=np.uint32)
        lib.zkm_rec_set_constants(
            np.ascontiguousarray(rc[0:4]).ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            np.ascontiguousarray(rc[4:17, 0]).ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            np.ascontiguousarray(rc[17:21]).ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            np.array(_DIAG_CANON, dtype=np.uint32).ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        _LIB = lib
    return _LIB


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def encode(program: pr.RecursionProgram):
    """(code u32[], batch_total); cached on the program object."""
    cached = getattr(program, "_native_code", None)
    if cached is not None:
        return cached
    words: list[int] = []
    batch_total = 0
    for ins in program.instructions:
        if isinstance(ins, pr.MemConst):
            words += [0, ins.addr, *ins.value]
        elif isinstance(ins, pr.Hint):
            words += [1, ins.addr]
        elif isinstance(ins, pr.BaseAlu):
            words += [2, int(ins.op), ins.out, ins.in1, ins.in2]
        elif isinstance(ins, pr.ExtAlu):
            words += [3, int(ins.op), ins.out, ins.in1, ins.in2]
        elif isinstance(ins, pr.Poseidon2):
            words += [4, *ins.inp, *ins.out]
        elif isinstance(ins, pr.Select):
            words += [5, ins.bit, ins.in1, ins.in2, ins.out1, ins.out2]
        elif isinstance(ins, pr.ExpReverseBitsLen):
            words += [6, ins.out, ins.base, len(ins.bit_addrs), *ins.bit_addrs]
        elif isinstance(ins, pr.HintBits):
            words += [7, ins.value_addr, len(ins.output_addrs), *ins.output_addrs]
        elif isinstance(ins, pr.HintExt2Felts):
            words += [8, ins.value_addr, *ins.output_addrs]
        elif isinstance(ins, pr.FriFold):
            n = len(ins.ps_at_z)
            words += [9, ins.x, ins.z, ins.alpha, n]
            for m in range(n):
                words += [
                    ins.mat_opening[m], ins.ps_at_z[m], ins.alpha_pow_input[m],
                    ins.ro_input[m], ins.alpha_pow_output[m], ins.ro_output[m],
                ]
        elif isinstance(ins, pr.BatchFRI):
            n = len(ins.p_at_z)
            batch_total += n
            words += [10, ins.acc, n]
            for m in range(n):
                words += [ins.p_at_x[m], ins.p_at_z[m], ins.alpha_pow[m]]
        elif isinstance(ins, pr.CommitPublicValues):
            words += [11, len(ins.addrs), *ins.addrs]
        elif isinstance(ins, pr.Print):
            pass  # host-side debug only
        else:
            raise TypeError(ins)
    code = np.asarray(words, dtype=np.uint32)
    program._native_code = (code, batch_total)
    return program._native_code


def run(program: pr.RecursionProgram, witness_stream=()) -> RecursionRecord:
    lib = _lib()
    code, batch_total = encode(program)
    wit = np.zeros((max(len(witness_stream), 1), 4), dtype=np.uint32)
    for i, w in enumerate(witness_stream):
        wit[i] = w
    mem = np.zeros((program.memory_size + 1, 4), dtype=np.uint32)
    bacc = np.zeros((max(batch_total, 1), 4), dtype=np.uint32)
    err = np.zeros(1, dtype=np.uint64)
    rc = lib.zkm_rec_run(
        _u32p(code), ctypes.c_uint64(len(code)), ctypes.c_uint64(mem.shape[0]),
        _u32p(wit), ctypes.c_uint64(len(witness_stream)),
        _u32p(mem), _u32p(bacc), err.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        kinds = {1: "circuit assert failed", 2: "bad opcode", 3: "witness underrun"}
        raise AssertionError(
            f"native recursion runtime: {kinds.get(rc, rc)} at instruction {int(err[0])}"
        )

    return _record(program, mem, bacc.tolist())


def _plan(program: pr.RecursionProgram) -> dict:
    """The program's instructions grouped by kind, in program order, with
    the addresses each event reads; cached on the program."""
    cached = getattr(program, "_native_plan", None)
    if cached is not None:
        return cached
    plan = {k: [] for k in (pr.BaseAlu, pr.ExtAlu, pr.Poseidon2, pr.Select, pr.ExpReverseBitsLen,
                            pr.FriFold, pr.BatchFRI)}
    consts = []  # MemConst instructions and Hint addresses, in program order
    hint_addrs = []  # every hinted address (Hint, HintBits, HintExt2Felts), in program order
    commit = None
    for ins in program.instructions:
        kind = type(ins)
        if kind is pr.MemConst:
            consts.append(ins)
        elif kind is pr.Hint:
            consts.append(ins)
            hint_addrs.append(ins.addr)
        elif kind is pr.HintBits or kind is pr.HintExt2Felts:
            hint_addrs.extend(ins.output_addrs)
        elif kind is pr.CommitPublicValues:
            commit = ins
        elif kind in plan:
            plan[kind].append(ins)
    plan["consts"], plan["hint_addrs"], plan["commit"] = consts, hint_addrs, commit
    program._native_plan = plan
    return plan


def _record(program, mem: np.ndarray, bacc: list) -> RecursionRecord:
    """The chip event record from the final memory image: every event value
    is a memory read (gathered per kind at once), except BatchFRI's running
    accumulators, which the C exports in instruction order."""
    plan = _plan(program)
    rec = RecursionRecord(program=program)

    def blocks(addrs):
        if not addrs:
            return []
        return list(map(tuple, mem[np.asarray(addrs, dtype=np.int64)].tolist()))

    def bases(addrs):
        if not addrs:
            return []
        return mem[np.asarray(addrs, dtype=np.int64), 0].tolist()

    def rows(addr_lists):
        """Base values of equal-length address tuples, one list per tuple."""
        if not addr_lists:
            return []
        return mem[np.asarray(addr_lists, dtype=np.int64), 0].tolist()

    hint_vals = blocks(plan["hint_addrs"])
    rec.hint_events = list(zip(plan["hint_addrs"], hint_vals))
    by_addr = dict(rec.hint_events)
    rec.mem_const_events = [
        (ins.addr, ins.value, ins.mult) if type(ins) is pr.MemConst
        else (ins.addr, by_addr[ins.addr], ins.mult)
        for ins in plan["consts"]
    ]
    zero = (0, 0, 0, 0)
    for kind, out in ((pr.BaseAlu, rec.base_alu_events), (pr.ExtAlu, rec.ext_alu_events)):
        alu = plan[kind]
        a = blocks([i.in1 for i in alu])
        b = blocks([i.in2 for i in alu])
        o = blocks([i.out for i in alu])
        out.extend(
            (i.op, i.out, i.in1, i.in2, ai, bi, zero if i.op == pr.BaseOp.ASSERT_EQ else oi, i.mult)
            for i, ai, bi, oi in zip(alu, a, b, o)
        )
    p2 = plan[pr.Poseidon2]
    rec.poseidon2_events = list(zip(
        [i.inp for i in p2], rows([i.inp for i in p2]),
        [i.out for i in p2], rows([i.out for i in p2]), [i.mults for i in p2],
    ))
    sel = plan[pr.Select]
    rec.select_events = list(zip(
        sel, bases([i.bit for i in sel]), blocks([i.in1 for i in sel]), blocks([i.in2 for i in sel]),
        blocks([i.out1 for i in sel]), blocks([i.out2 for i in sel]),
    ))
    erb = plan[pr.ExpReverseBitsLen]
    rec.exp_bits_events = list(zip(
        erb, bases([i.base for i in erb]), [bases(list(i.bit_addrs)) for i in erb],
        bases([i.out for i in erb]),
    ))
    for ins in plan[pr.FriFold]:
        x, z, alpha = bases([ins.x])[0], *blocks([ins.z, ins.alpha])
        cols = [blocks(list(c)) for c in (ins.mat_opening, ins.ps_at_z, ins.alpha_pow_input,
                                           ins.ro_input, ins.alpha_pow_output, ins.ro_output)]
        rec.fri_fold_events.extend(
            (x, z, alpha, *vals, ins, m) for m, vals in enumerate(zip(*cols))
        )
    bacc_i = 0
    for ins in plan[pr.BatchFRI]:
        n = len(ins.p_at_z)
        rec.batch_fri_events.extend(
            (px, pz, ap, tuple(acc), ins, m)
            for m, (px, pz, ap, acc) in enumerate(zip(
                bases(list(ins.p_at_x)), blocks(list(ins.p_at_z)), blocks(list(ins.alpha_pow)),
                bacc[bacc_i : bacc_i + n],
            ))
        )
        bacc_i += n
    if plan["commit"] is not None:
        rec.public_values = bases(list(plan["commit"].addrs))
    return rec
