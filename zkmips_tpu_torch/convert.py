"""Conversions between the reference's numpy layout and the port's tensors.

The reference keeps field elements as numpy uint32 Montgomery arrays; the
port as int32 tensors with the same bits.  These helpers take and return
numpy arrays, so a test can hand the reference's traces, preprocessed
tables, digests and ext values to the port and compare the two packages'
proofs field by field.  The record, program and proof converters are
duck-typed on attributes: nothing of the reference package is imported here.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy uint32 (any shape) -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy(t) -> np.ndarray:
    """int32 tensor -> numpy uint32 with the same bits."""
    return np.ascontiguousarray(t.detach().cpu().to(torch.int32).numpy()).view(np.uint32)


def _opt(t):
    return None if t is None else to_numpy(t)


def fri_proof_to_numpy(fp) -> dict:
    return {
        "commit_roots": [to_numpy(r) for r in fp.commit_roots],
        "final_poly": to_numpy(fp.final_poly),
        "pow_witness": int(fp.pow_witness),
        "query_proofs": [
            {
                "input_openings": [([to_numpy(r) for r in rows], to_numpy(sibs))
                                   for rows, sibs in qp.input_openings],
                "commit_openings": [(to_numpy(co.sibling_value), to_numpy(co.siblings))
                                    for co in qp.commit_openings],
            }
            for qp in fp.query_proofs
        ],
    }


def shard_proof_to_numpy(proof) -> dict:
    """The port's ShardProof as plain numpy fields, named as in the reference."""
    return {
        "main_root": to_numpy(proof.main_root),
        "perm_root": to_numpy(proof.perm_root),
        "quotient_root": to_numpy(proof.quotient_root),
        "chip_names": list(proof.chip_names),
        "opened": [
            {
                "preprocessed_local": _opt(ov.preprocessed_local),
                "preprocessed_next": _opt(ov.preprocessed_next),
                "main_local": to_numpy(ov.main_local),
                "main_next": to_numpy(ov.main_next),
                "perm_local": to_numpy(ov.perm_local),
                "perm_next": to_numpy(ov.perm_next),
                "quotient": [to_numpy(q) for q in ov.quotient],
                "local_cumulative_sum": to_numpy(ov.local_cumulative_sum),
                "global_sum": _opt(ov.global_sum),
                "log_degree": int(ov.log_degree),
            }
            for ov in proof.opened
        ],
        "fri_proof": fri_proof_to_numpy(proof.fri_proof),
        "public_values": to_numpy(proof.public_values),
    }


def shard_proof_to_reference(proof, ref_machine, ref_pcs):
    """The port's ShardProof as the reference's, for its verifier and codec.

    ``ref_machine`` and ``ref_pcs`` are the reference package's
    ``stark.machine`` and ``stark.pcs`` modules, handed in by the caller: this
    module imports nothing of that package."""
    d = shard_proof_to_numpy(proof)
    fp = d["fri_proof"]
    fri = ref_pcs.FriProof(
        fp["commit_roots"], fp["final_poly"], fp["pow_witness"],
        [ref_pcs.QueryProof(q["input_openings"],
                            [ref_pcs.CommitPhaseOpening(s, p) for s, p in q["commit_openings"]])
         for q in fp["query_proofs"]],
    )
    opened = [ref_machine.ChipOpenedValues(**o) for o in d["opened"]]
    return ref_machine.ShardProof(
        d["main_root"], d["perm_root"], d["quotient_root"], d["chip_names"], opened, fri,
        d["public_values"],
    )


def program_to_port(program):
    """A reference-package ``Program`` (or anything with its attributes) as
    the port's."""
    from .executor.instruction import Instruction
    from .executor.opcodes import Opcode
    from .executor.program import Program

    instructions = [
        Instruction(Opcode(int(i.opcode)), int(i.op_a), int(i.op_b), int(i.op_c),
                    bool(i.imm_b), bool(i.imm_c), i.raw)
        for i in program.instructions
    ]
    return Program(instructions, program.pc_start, program.pc_base, dict(program.image))


def record_to_port(record, program=None):
    """A reference-package ``ExecutionRecord`` as the port's, array-backed.

    Takes a record as the executor left it (before a machine appended its
    derived events), from either of the reference's executors: the CPU
    events are read by attribute into the column struct, the memory events
    and public values are rebuilt from their fields.  ``program`` is the
    port's program for the new record (converted from the record's when
    not given)."""
    from .executor import columnar, events as ev

    if any(record.precompile_events.values()):
        raise ValueError("record_to_port converts records without precompile events")
    if program is None:
        program = program_to_port(record.program)
    cols = columnar.Columns(
        {k: np.array(v, dtype=np.uint32) for k, v in columnar.cpu_struct(_EventsOnly(record)).items()}
    )
    out = ev.ExecutionRecord(shard=int(record.shard), program=program)
    out._cpu_struct = cols
    out.cpu_events = columnar.ArrayCpuEvents(cols, program, out.shard)

    def mem(r):
        return ev.MemoryRecord(int(r.value), int(r.shard), int(r.timestamp))

    def local(e):
        return ev.MemoryLocalEvent(int(e.addr), mem(e.initial), mem(e.final))

    def init_final(e):
        return ev.MemoryInitFinalEvent(int(e.addr), int(e.value), int(e.shard),
                                       int(e.timestamp), int(e.used))

    out.local_memory_access = {int(a): local(e) for a, e in record.local_memory_access.items()}
    out.cpu_local_memory_access = [local(e) for e in record.cpu_local_memory_access]
    out.global_memory_initialize_events = [init_final(e) for e in record.global_memory_initialize_events]
    out.global_memory_finalize_events = [init_final(e) for e in record.global_memory_finalize_events]
    rpv, pv = record.public_values, out.public_values
    pv.committed_value_digest = [int(x) for x in rpv.committed_value_digest]
    pv.deferred_proofs_digest = [int(x) for x in rpv.deferred_proofs_digest]
    for name in ("shard", "execution_shard", "start_pc", "next_pc", "exit_code", "prev_init_addr",
                 "last_init_addr", "prev_finalize_addr", "last_finalize_addr"):
        setattr(pv, name, int(getattr(rpv, name)))
    return out


class _EventsOnly:
    """What ``columnar.cpu_struct`` reads of a record, so that building the
    column struct leaves nothing cached on the caller's record."""

    def __init__(self, record):
        self._cpu_struct = getattr(record, "_cpu_struct", None)
        self.cpu_events = record.cpu_events
