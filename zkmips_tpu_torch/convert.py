"""Conversions between the reference's numpy layout and the port's tensors.

The reference keeps field elements as numpy uint32 Montgomery arrays; the
port as int32 tensors with the same bits.  These helpers take and return
numpy arrays, so a test can hand the reference's traces, preprocessed
tables, digests and ext values to the port and compare the two packages'
proofs field by field.  The record, program and proof converters are
duck-typed on attributes, or take the reference's modules as arguments:
nothing of the reference package is imported here.  Both ways: core and
recursion shard proofs, verifying keys, the recursion ladder's programs,
records, compressed and deferred proofs, and BN254 (outer config) digests,
which both packages keep as numpy object arrays of Python ints.  The SNARK
link's Groth16 and PLONK keys and proofs, wrapped proofs and
``ProofWithPublicValues`` go through each package's own byte codec.
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


def digest_to_numpy(d) -> np.ndarray:
    """A digest or a stack of digests as the reference holds it: uint32 for
    KoalaBear digests (int32 tensors), and a copy of the object array of
    Python ints for BN254 digests (the outer config), which both packages
    keep on the host."""
    if isinstance(d, np.ndarray) and d.dtype == object:
        return d.copy()
    return to_numpy(d)


def digest_to_port(d):
    """The inverse of ``digest_to_numpy``: int32 tensor, or object array."""
    a = np.asarray(d)
    if a.dtype == object:
        return a.copy()
    return to_torch(a)


def fri_proof_to_numpy(fp) -> dict:
    return {
        "commit_roots": [digest_to_numpy(r) for r in fp.commit_roots],
        "final_poly": to_numpy(fp.final_poly),
        "pow_witness": int(fp.pow_witness),
        "query_proofs": [
            {
                "input_openings": [([to_numpy(r) for r in rows], digest_to_numpy(sibs))
                                   for rows, sibs in qp.input_openings],
                "commit_openings": [(to_numpy(co.sibling_value), digest_to_numpy(co.siblings))
                                    for co in qp.commit_openings],
            }
            for qp in fp.query_proofs
        ],
    }


def shard_proof_to_numpy(proof) -> dict:
    """The port's ShardProof as plain numpy fields, named as in the reference."""
    return {
        "main_root": digest_to_numpy(proof.main_root),
        "perm_root": digest_to_numpy(proof.perm_root),
        "quotient_root": digest_to_numpy(proof.quotient_root),
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


# ---------------------------------------------------------------------------
# Reference -> port proofs and keys
# ---------------------------------------------------------------------------


def _opt_port(a):
    return None if a is None else to_torch(a)


def shard_proof_to_port(proof):
    """A reference-package ``ShardProof`` (or anything with its attributes)
    as the port's, on the CPU; BN254 digests stay object arrays."""
    from .stark import machine as tm, pcs as tpcs

    fp = proof.fri_proof
    fri = tpcs.FriProof(
        [digest_to_port(r) for r in fp.commit_roots], to_torch(fp.final_poly), int(fp.pow_witness),
        [tpcs.QueryProof(
            [([to_torch(r) for r in rows], digest_to_port(sibs)) for rows, sibs in qp.input_openings],
            [tpcs.CommitPhaseOpening(to_torch(co.sibling_value), digest_to_port(co.siblings))
             for co in qp.commit_openings])
         for qp in fp.query_proofs],
    )
    opened = [
        tm.ChipOpenedValues(
            _opt_port(ov.preprocessed_local), _opt_port(ov.preprocessed_next),
            to_torch(ov.main_local), to_torch(ov.main_next),
            to_torch(ov.perm_local), to_torch(ov.perm_next),
            [to_torch(q) for q in ov.quotient], to_torch(ov.local_cumulative_sum),
            _opt_port(ov.global_sum), int(ov.log_degree),
        )
        for ov in proof.opened
    ]
    return tm.ShardProof(
        digest_to_port(proof.main_root), digest_to_port(proof.perm_root),
        digest_to_port(proof.quotient_root), list(proof.chip_names), opened, fri,
        to_torch(proof.public_values),
    )


def verifying_key_to_reference(vk, ref_machine):
    """The port's ``VerifyingKey`` (a recursion program's, or any) as the
    reference's ``stark.machine.VerifyingKey``."""
    root = None if vk.prep_root is None else digest_to_numpy(vk.prep_root)
    return ref_machine.VerifyingKey(root, list(vk.prep_heights))


def verifying_key_to_port(vk):
    from .stark.machine import VerifyingKey

    root = None if vk.prep_root is None else digest_to_port(vk.prep_root)
    return VerifyingKey(root, [(n, int(h)) for n, h in vk.prep_heights])


# ---------------------------------------------------------------------------
# The recursion ladder
# ---------------------------------------------------------------------------


def compressed_proof_to_reference(cp, ref_compress, ref_machine, ref_pcs):
    """The port's ``CompressedProof`` as the reference's
    (``recursion.compress`` handed in as ``ref_compress``)."""
    return ref_compress.CompressedProof(
        shard_proof_to_reference(cp.proof, ref_machine, ref_pcs), tuple(cp.final_vk_root),
        int(cp.num_shards), cp.stage,
    )


def compressed_proof_to_port(cp):
    from .recursion.compress import CompressedProof

    return CompressedProof(shard_proof_to_port(cp.proof), tuple(cp.final_vk_root),
                           int(cp.num_shards), cp.stage)


def deferred_proof_to_reference(dp, ref_compress, ref_machine, ref_pcs):
    return ref_compress.DeferredProof(
        shard_proof_to_reference(dp.proof, ref_machine, ref_pcs), tuple(dp.final_vk_root),
        tuple(dp.child_vk_root), list(dp.prev_digest), list(dp.new_digest),
    )


def deferred_proof_to_port(dp):
    from .recursion.compress import DeferredProof

    return DeferredProof(shard_proof_to_port(dp.proof), tuple(dp.final_vk_root),
                         tuple(dp.child_vk_root), list(dp.prev_digest), list(dp.new_digest))


def _instruction_as(ins, module):
    """A recursion instruction as ``module``'s class of the same name, field
    for field (the op of an ALU instruction as ``module.BaseOp``)."""
    import dataclasses

    cls = getattr(module, type(ins).__name__)
    vals = {f.name: getattr(ins, f.name) for f in dataclasses.fields(ins)}
    if "op" in vals:
        vals["op"] = module.BaseOp(int(vals["op"]))
    return cls(**vals)


def recursion_program_to_port(program):
    """A reference ``RecursionProgram`` as the port's."""
    from .recursion import program as pr

    return pr.RecursionProgram([_instruction_as(i, pr) for i in program.instructions],
                               program.memory_size, program.num_public_values)


def recursion_program_to_reference(program, ref_program):
    """The port's ``RecursionProgram`` as the reference's
    (``recursion.program`` handed in as ``ref_program``)."""
    return ref_program.RecursionProgram([_instruction_as(i, ref_program) for i in program.instructions],
                                        program.memory_size, program.num_public_values)


_EVENT_LISTS = ("mem_const_events", "base_alu_events", "ext_alu_events", "poseidon2_events",
                "select_events", "exp_bits_events", "fri_fold_events", "batch_fri_events",
                "hint_events")


def _convert_record(record, program, new_record, module):
    """Copy a recursion record's events, its instruction objects replaced by
    ``program``'s (matched by position) and ALU ops by ``module.BaseOp``."""
    import enum

    same = {id(a): b for a, b in zip(record.program.instructions, program.instructions)}

    def conv(v):
        if id(v) in same:
            return same[id(v)]
        if isinstance(v, enum.IntEnum):
            return module.BaseOp(int(v))
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    for name in _EVENT_LISTS:
        setattr(new_record, name, [conv(ev) for ev in getattr(record, name)])
    new_record.public_values = [int(x) for x in record.public_values]
    return new_record


def recursion_record_to_port(record, program=None):
    """A reference ``RecursionRecord`` as the port's; ``program`` is the
    port's program for it (converted from the record's when not given)."""
    from .recursion import program as pr
    from .recursion.runtime import RecursionRecord

    if program is None:
        program = recursion_program_to_port(record.program)
    return _convert_record(record, program, RecursionRecord(program=program), pr)


def recursion_record_to_reference(record, ref_program, ref_runtime, program=None):
    """The port's ``RecursionRecord`` as the reference's (its
    ``recursion.program`` and ``recursion.runtime`` handed in)."""
    if program is None:
        program = recursion_program_to_reference(record.program, ref_program)
    return _convert_record(record, program, ref_runtime.RecursionRecord(program=program), ref_program)


# ---- the SNARK link: Groth16 and PLONK keys and proofs, proof containers ----

_SNARK_CODECS = {
    "groth16_vk": ("encode_groth16_vk", "decode_groth16_vk"),
    "groth16_proof": ("encode_groth16_proof", "decode_groth16_proof"),
    "groth16_wrapped": ("encode_groth16_wrapped", "decode_groth16_wrapped"),
    "plonk_vk": ("encode_plonk_vk", "decode_plonk_vk"),
    "plonk_proof": ("encode_plonk_proof", "decode_plonk_proof"),
    "plonk_wrapped": ("encode_plonk_wrapped", "decode_plonk_wrapped"),
}


def snark_to_reference(kind: str, obj, ref_verifier):
    """A Groth16 or PLONK verifying key, proof or wrapped proof of the port
    (``kind`` a key of ``_SNARK_CODECS``) as the reference's object: written
    by the port's byte codec, read by the reference's (``ref_verifier`` is
    the reference's ``verifier`` package)."""
    from . import verifier

    enc, dec = _SNARK_CODECS[kind]
    return getattr(ref_verifier, dec)(getattr(verifier, enc)(obj))


def snark_to_port(kind: str, obj):
    """The reference's Groth16 or PLONK object as the port's: the port's
    codec writes the reference's dataclasses (same fields) and reads the
    bytes back into its own."""
    from . import verifier

    enc, dec = _SNARK_CODECS[kind]
    return getattr(verifier, dec)(getattr(verifier, enc)(obj))


def proof_with_public_values_to_reference(pw, ref_sdk):
    """The port's ``ProofWithPublicValues`` as the reference's, through the
    container bytes (``ref_sdk`` is the reference's ``sdk`` package)."""
    return ref_sdk.ProofWithPublicValues.from_bytes(pw.to_bytes())


def proof_with_public_values_to_port(pw):
    from .sdk import ProofWithPublicValues

    return ProofWithPublicValues.from_bytes(pw.to_bytes())
