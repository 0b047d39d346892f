"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

A library is built at first use, never at import, into ``_build/`` inside
the package (git-ignored).  A hash of the source and the flags names the
library, so an edited source builds anew.  nvcc writes to a temporary name
that ``os.replace`` moves into place, so parallel processes never load a
half-written library.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels build only on a machine with the CUDA toolkit"
    )


def library_name(stem: str, content: bytes, flags) -> str:
    """The file name of the library built from ``content`` with ``flags``:
    a hash of both, so an edited source or flag builds anew."""
    digest = hashlib.sha256(content + " ".join(flags).encode()).hexdigest()
    return f"lib{stem}_{digest[:16]}.so"


def compile_library(cmd, lib: Path, error=RuntimeError,
                    timeout=None) -> Path:
    """Run the compiler command ``cmd`` (its flags and source, not its
    output) with ``-o`` a temporary name beside ``lib`` that ``os.replace``
    moves into place; a failed compile removes the temporary file and raises
    ``error`` with the compiler's stderr."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [*cmd, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise error(
            f"{Path(cmd[0]).name} failed with exit code {proc.returncode}: "
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives.  The hash
    covers the shared headers ``csrc/*.cuh`` too, so an edited header
    rebuilds every library."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    return BUILD_DIR / library_name(name, src, NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    lib = library_path(name)
    if lib.exists():
        return lib
    return compile_library(
        [_nvcc(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu")], lib)


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one load per process."""
    return ctypes.CDLL(str(build(name)))
