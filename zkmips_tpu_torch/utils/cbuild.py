"""Content-addressed builds of the native C runtime and the CUDA kernels.

``build`` compiles a ``.c`` source where it lies to
``build/native/lib<name>-<crc>.so`` (git-ignored, at the repository root),
where ``<crc>`` hashes the source text: a stale binary can never be picked up
after a source change, regardless of filesystem mtimes.  Older hash-named
binaries of the same source are best-effort pruned.  ``build_cuda`` compiles
a ``.cu`` source with ``nvcc`` into ``build/kernels/<stem>-<tag>.so`` the same
way (``tag`` hashes the source and the flags).  Builders may race: the
threads of one process take turns, and each builder writes its own temporary
file (named by process and thread) before the atomic rename.
"""

from __future__ import annotations

import glob
import hashlib
import os
import subprocess
import threading
import zlib
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "native"
KERNEL_DIR = REPO_ROOT / "build" / "kernels"
CUDA_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_BUILD_LOCK = threading.Lock()


def build(src: str, extra_flags: tuple[str, ...] = ()) -> str:
    """Compile ``src`` (a .c path) to a content-hash-named .so; return path."""
    with open(src, "rb") as fh:
        crc = zlib.crc32(fh.read()) & 0xFFFFFFFF
    base = os.path.basename(src)[: -len(".c")]
    d = str(BUILD_DIR)
    so = os.path.join(d, f"lib{base}-{crc:08x}.so")
    if os.path.exists(so):
        return so
    with _BUILD_LOCK:
        if os.path.exists(so):  # another thread built it while this one waited
            return so
        os.makedirs(d, exist_ok=True)
        tmp = so + f".tmp{os.getpid()}.{threading.get_ident()}"
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


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_cuda(source: Path, stem: str) -> Path:
    """Compile a ``.cu`` source with a plain C interface into
    ``build/kernels/<stem>-<tag>.so`` (once per source and flags); returns
    the library's path.  The compiler's output (with ``-Xptxas=-v``:
    registers and spills per kernel) is kept beside it as
    ``<stem>-<tag>.log``."""
    source = Path(source)
    tag = hashlib.sha256(source.read_bytes() + " ".join(CUDA_FLAGS).encode()).hexdigest()[:16]
    lib = KERNEL_DIR / f"{stem}-{tag}.so"
    if lib.exists():
        return lib
    with _BUILD_LOCK:
        if lib.exists():  # another thread built it while this one waited
            return lib
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([nvcc(), *CUDA_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib
