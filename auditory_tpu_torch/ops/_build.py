"""Build the port's CUDA sources into plain-C shared libraries and load them
with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into ``build/auditory_tpu_torch/<name>-<hash>.so`` under the
checkout root; the hash covers the source and the flags, so an edited source
is rebuilt and an unchanged one is reused. Nothing here runs at import: the
CPU-only test environment has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "auditory_tpu_torch"

# no --use_fast_math: the kernels' exact-zero log floors need the accurate logf
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are built "
        "from source at first use and need the CUDA toolkit"
    )


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for the same source and
    flags exists; return the library's path. The compiler's output (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel) is kept
    beside it as ``<lib>.log``."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent builder never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        Path(str(lib) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it if needed."""
    return ctypes.CDLL(str(build(name)))
