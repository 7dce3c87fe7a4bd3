"""Shared example scaffolding: the config and device flags, and timing."""

from __future__ import annotations

import argparse
import time

from ..device import resolve_device
from ..sdk import ProverClient, ZKMStdin  # noqa: F401  (the examples import it from here)
from ..stark.machine import StarkConfig

# one client per (config, device) in a process: building the 49 chips'
# constraint DAGs costs seconds, the same for every example
_CLIENTS: dict = {}


def parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--sound", action="store_true", help="production FRI config (slower)")
    ap.add_argument("--cpu", action="store_true",
                    help="prove on the CPU (default: the CUDA card, and without one the example raises)")
    return ap


def client_from_args(desc: str, argv=None, ap: argparse.ArgumentParser | None = None):
    """(client, args): the client at the test config (``--sound``: the core
    config) on the card, or on the CPU with ``--cpu``; ``args.device`` is the
    resolved device, for the examples that drive the machine directly."""
    args = (ap or parser(desc)).parse_args(argv)
    args.device = resolve_device("cpu" if args.cpu else None)
    key = (args.sound, str(args.device))
    if key not in _CLIENTS:
        config = StarkConfig.core() if args.sound else StarkConfig.test()
        _CLIENTS[key] = ProverClient(config=config, device=args.device)
    return _CLIENTS[key], args


def timed(label: str, fn, *a, **kw):
    t0 = time.time()
    out = fn(*a, **kw)
    print(f"  {label}: {time.time() - t0:.2f}s")
    return out
