"""User-facing SDK: the analog of the reference's ProverClient
(crates/sdk/src/lib.rs:46-287)."""

from .client import ProverClient, ProofWithPublicValues, ZKMStdin

__all__ = ["ProverClient", "ProofWithPublicValues", "ZKMStdin"]
