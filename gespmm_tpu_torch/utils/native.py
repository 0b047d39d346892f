"""ctypes bindings of the native C++ graph-IO library — port of
``gespmm_tpu/utils/native.py``.

The repository's ``native/graphio.cpp`` holds the fast host paths: the
Matrix Market parser, COO -> CSR, CSR -> CSC (a counting sort with its
permutation) and the streaming Fennel partition.  The port builds its own
library from that source with g++ at first use, never at import, into the
git-ignored ``gespmm_tpu_torch/_build/``, as ``kernels/_build.py`` builds the
CUDA sources, through the same helpers: a hash of the source and the flags
names the library, and g++ writes to a temporary name that ``os.replace``
moves into place, so parallel processes never load a half-written library.  It never writes
``native/libgespmm_io.so``, which the JAX package's loader owns.

Every entry point keeps the JAX package's signature and returns NumPy
arrays, or None when the library is unavailable (no g++, no source, or a
failed build: ``available()`` is then False and ``error()`` holds g++'s
stderr).  The callers take a ``use_native`` argument (``wanted``): None
takes the native path when ``available()``, True demands it (raising
``NativeUnavailable`` with the reason), False refuses it.  The pack-chunks
entry is not bound: it fed only the JAX package's tiled plan, which the port
does not have.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from gespmm_tpu_torch.kernels import _build

PKG_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR / "_build"
SOURCE = PKG_DIR.parent / "native" / "graphio.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None
_TRIED = False


class NativeUnavailable(RuntimeError):
    """The native path was demanded (``use_native=True``) but the library
    could not be built or loaded."""


def library_path() -> Path:
    """Where the library built from ``native/graphio.cpp`` lives."""
    return BUILD_DIR / _build.library_name("gespmm_io", SOURCE.read_bytes(),
                                           CXX_FLAGS)


def build() -> Path:
    """Compile the source unless a library of the same hash exists; raises
    ``NativeUnavailable`` with the reason (g++'s stderr) on failure."""
    if not SOURCE.is_file():
        raise NativeUnavailable(f"no native source at {SOURCE}")
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("g++ not found on PATH")
    return _build.compile_library([cxx, *CXX_FLAGS, str(SOURCE)], lib,
                                  NativeUnavailable, timeout=300)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.gio_read_mtx.restype = ctypes.c_void_p
    lib.gio_read_mtx.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.gio_error.restype = ctypes.c_char_p
    lib.gio_error.argtypes = [ctypes.c_void_p]
    for f in ("gio_nnz", "gio_rows", "gio_cols"):
        getattr(lib, f).restype = ctypes.c_int64
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.gio_copy_out.restype = None
    lib.gio_copy_out.argtypes = [ctypes.c_void_p, i32, i32, f32]
    lib.gio_free.restype = None
    lib.gio_free.argtypes = [ctypes.c_void_p]
    lib.gio_coo_to_csr.restype = None
    lib.gio_coo_to_csr.argtypes = [i32, ctypes.c_int64, ctypes.c_int64, i32]
    lib.gio_csr_to_csc.restype = None
    lib.gio_csr_to_csc.argtypes = [i32, i32, ctypes.c_int64, ctypes.c_int64,
                                   i32, i32, i32]
    lib.gio_fennel_partition.restype = None
    lib.gio_fennel_partition.argtypes = [
        i32, i32, ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.c_double, i32]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None when it cannot be
    built or loaded (the reason is in ``error()``)."""
    global _LIB, _ERROR, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = _bind(ctypes.CDLL(str(build())))
            except (NativeUnavailable, OSError, subprocess.SubprocessError) as e:
                _LIB, _ERROR = None, str(e)
        return _LIB


def available() -> bool:
    return get_lib() is not None


def error() -> Optional[str]:
    """Why the library is unavailable (None when it is loaded or untried)."""
    return _ERROR


def wanted(use_native: Optional[bool]) -> bool:
    """Whether a caller's ``use_native`` takes the native path: None when
    ``available()``, True always (raising ``NativeUnavailable`` with the
    reason when it cannot), False never."""
    if use_native is None:
        return available()
    if use_native and get_lib() is None:
        raise NativeUnavailable(
            f"the native graph-IO library is unavailable: {error()}")
    return bool(use_native)


def read_mtx_native(
    path: str,
    symmetrize: Optional[bool] = None,
    remove_self_loops: bool = True,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]]:
    """Parse a .mtx file natively: (row, col, val, shape), or None without
    the library.  A malformed file raises ``ValueError``."""
    lib = get_lib()
    if lib is None:
        return None
    mode = 0 if symmetrize is None else (1 if symmetrize else 2)
    h = lib.gio_read_mtx(os.fsencode(path), mode,
                         1 if remove_self_loops else 0)
    try:
        err = lib.gio_error(h)
        if err:
            raise ValueError(f"native mtx parse: {err.decode()}")
        nnz = lib.gio_nnz(h)
        shape = (int(lib.gio_rows(h)), int(lib.gio_cols(h)))
        ri = np.empty(nnz, np.int32)
        ci = np.empty(nnz, np.int32)
        vals = np.empty(nnz, np.float32)
        if nnz:
            lib.gio_copy_out(h, ri, ci, vals)
        return ri, ci, vals, shape
    finally:
        lib.gio_free(h)


def coo_to_csr_native(rows: np.ndarray, m: int) -> Optional[np.ndarray]:
    """The (m + 1,) int32 indptr of sorted COO row ids, or None."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    indptr = np.empty(m + 1, np.int32)
    lib.gio_coo_to_csr(rows, rows.shape[0], m, indptr)
    return indptr


def csr_to_csc_native(
    indptr: np.ndarray, indices: np.ndarray, m: int, n: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(colptr, rows, perm) with perm: CSC position -> CSR position, or
    None.  A stable counting sort: equal to a stable argsort of the column
    ids."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    nnz = int(indptr[-1])
    colptr = np.empty(n + 1, np.int32)
    out_rows = np.empty(nnz, np.int32)
    perm = np.empty(nnz, np.int32)
    lib.gio_csr_to_csc(indptr, indices, m, n, colptr, out_rows, perm)
    return colptr, out_rows, perm


def fennel_partition_native(
    indptr: np.ndarray,
    indices: np.ndarray,
    num_parts: int,
    gamma: float = 1.5,
    passes: int = 3,
    slack: float = 0.1,
) -> Optional[np.ndarray]:
    """The native streaming Fennel partition, (m,) int32 labels, or None.

    The algorithm of ``sparse/reorder.py::fennel_partition``'s NumPy loop,
    with the lowest-shard tie-break in place of the loop's random jitter, so
    its labels can differ from the loop's where scores tie.
    """
    lib = get_lib()
    if lib is None:
        return None
    m = indptr.shape[0] - 1
    labels = np.empty(m, np.int32)
    lib.gio_fennel_partition(
        np.ascontiguousarray(indptr, np.int32),
        np.ascontiguousarray(indices, np.int32),
        m, int(num_parts), float(gamma), int(passes), float(slack), labels)
    return labels
