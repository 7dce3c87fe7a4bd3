"""Content-addressed builds of the native C runtime.

``build`` compiles a ``.c`` source where it lies to
``build/native/lib<name>-<crc>.so`` (git-ignored, at the repository root),
where ``<crc>`` hashes the source text: a stale binary can never be picked up
after a source change, regardless of filesystem mtimes.  Older hash-named
binaries of the same source are best-effort pruned.
"""

from __future__ import annotations

import glob
import os
import subprocess
import zlib
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "native"


def build(src: str, extra_flags: tuple[str, ...] = ()) -> str:
    """Compile ``src`` (a .c path) to a content-hash-named .so; return path."""
    with open(src, "rb") as fh:
        crc = zlib.crc32(fh.read()) & 0xFFFFFFFF
    base = os.path.basename(src)[: -len(".c")]
    d = str(BUILD_DIR)
    so = os.path.join(d, f"lib{base}-{crc:08x}.so")
    if not os.path.exists(so):
        os.makedirs(d, exist_ok=True)
        tmp = so + f".tmp{os.getpid()}"
        subprocess.run(
            ["cc", "-O3", *extra_flags, "-shared", "-fPIC", "-o", tmp, src],
            check=True,
        )
        os.replace(tmp, so)  # atomic under concurrent builders
        for old in glob.glob(os.path.join(d, f"lib{base}-????????.so")):
            if old != so:
                try:
                    os.remove(old)
                except OSError:
                    pass
    return so
