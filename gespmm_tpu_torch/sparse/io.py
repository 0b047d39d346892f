"""Matrix Market (.mtx) ingest — the NumPy reader of ``gespmm_tpu/sparse/io.py``.

Same semantics as the JAX package's reader:

  * coordinate format; ``real`` / ``integer`` / ``pattern`` fields
    (pattern -> 1.0); 1-based -> 0-based indices;
  * ``symmetric`` banner: mirror off-diagonal entries, remove self-loops,
    deduplicate keeping the first occurrence;
  * final stable row-major sort.

Host-side only.  ``read_mtx`` parses through the native C++ library
(``utils/native.py``, built from ``native/graphio.cpp``) when it is
available; its arrays equal this NumPy reader's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class MtxHeader:
    rows: int
    cols: int
    nnz: int
    field: str  # real | integer | pattern
    symmetry: str  # general | symmetric


class MtxFormatError(ValueError):
    pass


def _parse_banner(line: str) -> Tuple[str, str, str, str]:
    parts = line.strip().lower().split()
    if len(parts) != 5 or parts[0] != "%%matrixmarket":
        raise MtxFormatError(f"bad MatrixMarket banner: {line!r}")
    _, obj, fmt, field, symmetry = parts
    if obj != "matrix":
        raise MtxFormatError(f"unsupported object {obj!r}")
    if fmt != "coordinate":
        raise MtxFormatError(f"only coordinate format supported, got {fmt!r}")
    if field not in ("real", "integer", "pattern"):
        raise MtxFormatError(f"unsupported field {field!r}")
    if symmetry not in ("general", "symmetric"):
        raise MtxFormatError(f"unsupported symmetry {symmetry!r}")
    return obj, fmt, field, symmetry


def read_mtx_header(path: str) -> MtxHeader:
    with open(path, "r") as f:
        _, _, field, symmetry = _parse_banner(f.readline())
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, nnz = (int(t) for t in line.split()[:3])
    return MtxHeader(rows, cols, nnz, field, symmetry)


def symmetrize_coo(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                   remove_self_loops: bool = True):
    """Mirror off-diagonal entries, optionally drop self-loops, dedup, sort."""
    off_diag = row != col
    row2 = np.concatenate([row, col[off_diag]])
    col2 = np.concatenate([col, row[off_diag]])
    val2 = np.concatenate([val, val[off_diag]])
    order = np.lexsort((col2, row2))
    row2, col2, val2 = row2[order], col2[order], val2[order]
    keep = np.ones(row2.shape[0], dtype=bool)
    if remove_self_loops:
        keep &= row2 != col2
    if row2.shape[0] > 1:
        keep[1:] &= ~((row2[1:] == row2[:-1]) & (col2[1:] == col2[:-1]))
    return row2[keep], col2[keep], val2[keep]


def sort_coo(row: np.ndarray, col: np.ndarray, val: np.ndarray):
    """Stable row-major sort."""
    order = np.lexsort((col, row))
    return row[order], col[order], val[order]


def read_mtx(path: str, dtype=np.float32, symmetrize: Optional[bool] = None,
             remove_self_loops: bool = True, use_native: Optional[bool] = None):
    """Read a .mtx file into a sorted, canonical COO container (CPU tensors).

    ``symmetrize=None`` follows the banner; True/False forces it on/off.
    ``use_native``: None parses natively when the library is available
    (``utils/native.py``), True demands the native parser (raising
    ``NativeUnavailable`` without it), False takes the NumPy reader.  A file
    the native parser refuses goes to the NumPy reader under None, as in the
    JAX package, and raises ``MtxFormatError`` under True.
    """
    from gespmm_tpu_torch.sparse.formats import COO
    from gespmm_tpu_torch.utils import native

    if native.wanted(use_native):
        try:
            row, col, val, shape = native.read_mtx_native(
                path, symmetrize=symmetrize,
                remove_self_loops=remove_self_loops)
        except ValueError as e:
            if use_native:
                raise MtxFormatError(str(e)) from e
        else:
            return COO(row=torch.from_numpy(row), col=torch.from_numpy(col),
                       data=torch.from_numpy(val.astype(dtype)), shape=shape)

    header = read_mtx_header(path)
    with open(path, "r") as f:
        f.readline()  # banner
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        # `line` was the size line; the rest is the entry body.
        body = np.loadtxt(f, dtype=np.float64, ndmin=2)

    if body.size == 0:
        row = np.zeros(0, np.int64)
        col = np.zeros(0, np.int64)
        val = np.zeros(0, dtype)
    else:
        if body.shape[1] < 2:
            raise MtxFormatError("entries need at least 2 columns")
        row = body[:, 0].astype(np.int64) - 1
        col = body[:, 1].astype(np.int64) - 1
        if header.field == "pattern" or body.shape[1] < 3:
            # Some real-tagged files omit values; treat them as pattern.
            val = np.ones(body.shape[0], dtype)
        else:
            val = body[:, 2].astype(dtype)

    if body.size and row.shape[0] != header.nnz:
        raise MtxFormatError(
            f"expected {header.nnz} entries, parsed {row.shape[0]}"
        )

    do_sym = header.symmetry == "symmetric" if symmetrize is None else symmetrize
    if do_sym:
        row, col, val = symmetrize_coo(row, col, val,
                                       remove_self_loops=remove_self_loops)
    else:
        row, col, val = sort_coo(row, col, val)

    return COO(
        row=torch.from_numpy(row.astype(np.int32)),
        col=torch.from_numpy(col.astype(np.int32)),
        data=torch.from_numpy(np.ascontiguousarray(val)),
        shape=(header.rows, header.cols),
    )


def read_mtx_csr(path: str, binary: bool = False, **kwargs):
    """Read .mtx straight to CSR; ``binary=True`` drops edge values."""
    from gespmm_tpu_torch.sparse.formats import csr_from_coo

    csr = csr_from_coo(read_mtx(path, **kwargs))
    return csr.with_data(None) if binary else csr


def write_mtx(path: str, row, col, val, shape, symmetry: str = "general") -> None:
    """Write a COO matrix as .mtx (test fixture helper; 0-based -> 1-based)."""
    row = np.asarray(row)
    col = np.asarray(col)
    field = "pattern" if val is None else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{shape[0]} {shape[1]} {row.shape[0]}\n")
        if val is None:
            for r, c in zip(row, col):
                f.write(f"{int(r) + 1} {int(c) + 1}\n")
        else:
            for r, c, v in zip(row, col, np.asarray(val)):
                f.write(f"{int(r) + 1} {int(c) + 1} {float(v):.9g}\n")


def default_dataset_dir() -> str:
    """Directory of benchmark graphs: ``$GESPMM_TPU_DATA`` or the repo's
    ``data/``, whichever exists first; "" when neither does."""
    for cand in (
        os.environ.get("GESPMM_TPU_DATA", ""),
        os.path.join(os.path.dirname(__file__), "..", "..", "data"),
    ):
        if cand and os.path.isdir(cand):
            return os.path.abspath(cand)
    return ""
