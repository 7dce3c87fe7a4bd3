"""Conversions between the reference's numpy layout and the port's tensors.

The reference keeps field elements as numpy uint32 Montgomery arrays; the
port as int32 tensors with the same bits.  These helpers take and return
numpy arrays, so a test can hand the reference's traces, preprocessed
tables, digests and ext values to the port and compare the two packages'
proofs field by field.
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
                "global_sum": None,
                "log_degree": int(ov.log_degree),
            }
            for ov in proof.opened
        ],
        "fri_proof": fri_proof_to_numpy(proof.fri_proof),
        "public_values": to_numpy(proof.public_values),
    }
