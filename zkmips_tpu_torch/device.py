"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present; there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def current(device: torch.device):
    """A context that makes ``device`` the calling thread's current CUDA
    device (a no-op for any other device): a worker thread proving on one
    card of several launches there."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
