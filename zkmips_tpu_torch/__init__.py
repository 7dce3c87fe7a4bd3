"""PyTorch/CUDA port of the zkmips_tpu STARK shard prover.

The JAX package ``zkmips_tpu`` is the reference; this package mirrors its
``ops/`` and ``stark/`` layout module for module and must reproduce its proofs
bit for bit.  Field elements are stored as ``torch.int32`` tensors in
Montgomery form (every value is below p < 2^31, so the bits equal the
reference's uint32 arrays) and computed in ``torch.int64``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
