"""Sparse matrix containers as dataclasses of torch tensors.

Counterpart of ``gespmm_tpu/sparse/formats.py``.  The containers keep the
JAX package's invariants:

  * ``indptr``/``indices`` are ``int32`` (the kernels index with 32 bits;
    the SpMM wrapper refuses nnz >= 2**31);
  * ``data`` may be ``None`` — the "topology only / implicit 1.0" variant,
    which lets the SpMM kernel skip the value load entirely;
  * ``shape`` is a plain ``(m, n)`` tuple.

Transforms run on whatever device their inputs live on; ``Adjacency`` in
``ops/spmm.py`` builds its orderings on the host once per graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _as_i32(x) -> Tensor:
    x = torch.as_tensor(x)
    return x if x.dtype == torch.int32 else x.to(torch.int32)


def _to(t: Optional[Tensor], device) -> Optional[Tensor]:
    return None if t is None else t.to(device)


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix, sorted row-major and deduplicated."""

    row: Tensor
    col: Tensor
    data: Optional[Tensor]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def dtype(self):
        return torch.float32 if self.data is None else self.data.dtype

    def with_data(self, data: Optional[Tensor]) -> "COO":
        return dataclasses.replace(self, data=data)

    def to(self, device) -> "COO":
        return COO(self.row.to(device), self.col.to(device),
                   _to(self.data, device), self.shape)

    def todense(self) -> Tensor:
        vals = (
            torch.ones(self.nnz, dtype=torch.float32, device=self.row.device)
            if self.data is None else self.data
        )
        out = torch.zeros(self.shape, dtype=vals.dtype, device=vals.device)
        out.index_put_((self.row.long(), self.col.long()), vals,
                       accumulate=True)
        return out


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix.

    ``indptr``: (m+1,) int32 row offsets.  ``indices``: (nnz,) int32 column
    ids, sorted within each row.  ``data``: (nnz,) values or ``None`` for
    implicit 1.0.
    """

    indptr: Tensor
    indices: Tensor
    data: Optional[Tensor]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return torch.float32 if self.data is None else self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def with_data(self, data: Optional[Tensor]) -> "CSR":
        return dataclasses.replace(self, data=data)

    def to(self, device) -> "CSR":
        return CSR(self.indptr.to(device), self.indices.to(device),
                   _to(self.data, device), self.shape)

    def row_ids(self) -> Tensor:
        """Per-nonzero row ids (the COO row array)."""
        return expand_indptr(self.indptr, self.nnz)

    def row_lengths(self) -> Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def to_coo(self) -> COO:
        return COO(row=self.row_ids(), col=self.indices, data=self.data,
                   shape=self.shape)

    def todense(self) -> Tensor:
        return self.to_coo().todense()


@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column matrix — structurally the CSR of Aᵀ.

    ``shape`` is the shape of the ORIGINAL matrix (m, n).
    """

    indptr: Tensor  # (n+1,) column offsets
    indices: Tensor  # (nnz,) row ids
    data: Optional[Tensor]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def with_data(self, data: Optional[Tensor]) -> "CSC":
        return dataclasses.replace(self, data=data)

    def to(self, device) -> "CSC":
        return CSC(self.indptr.to(device), self.indices.to(device),
                   _to(self.data, device), self.shape)

    def as_csr_of_transpose(self) -> CSR:
        """View this CSC as the CSR of Aᵀ (shape swapped)."""
        m, n = self.shape
        return CSR(indptr=self.indptr, indices=self.indices, data=self.data,
                   shape=(n, m))


def expand_indptr(indptr: Tensor, nnz: int) -> Tensor:
    """indptr (m+1,) -> per-nonzero row ids (nnz,) int32."""
    m = indptr.shape[0] - 1
    rows = torch.arange(m, dtype=torch.int32, device=indptr.device)
    return torch.repeat_interleave(
        rows, (indptr[1:] - indptr[:-1]).long(), output_size=nnz
    )


def indptr_from_rows(row: Tensor, m: int) -> Tensor:
    """Sorted per-nonzero row ids -> CSR indptr (m+1,) int32."""
    counts = torch.bincount(row.long(), minlength=m)
    out = torch.zeros(m + 1, dtype=torch.int32, device=row.device)
    out[1:] = torch.cumsum(counts, 0)
    return out


def csr_from_coo(coo: COO) -> CSR:
    """COO (sorted row-major, deduped) -> CSR."""
    m, _ = coo.shape
    return CSR(indptr=indptr_from_rows(coo.row, m), indices=_as_i32(coo.col),
               data=coo.data, shape=coo.shape)


def csr_to_csc(csr: CSR, return_permutation: bool = False):
    """CSR -> CSC via a stable sort on column ids.

    Stability keeps row order within each column (canonical CSC).  The
    permutation maps CSC edge order -> CSR edge order
    (``csc.data = csr.data[perm]``).
    """
    m, n = csr.shape
    perm = torch.argsort(csr.indices, stable=True).to(torch.int32)
    pl = perm.long()
    csc = CSC(
        indptr=indptr_from_rows(csr.indices[pl], n),
        indices=csr.row_ids()[pl],
        data=None if csr.data is None else csr.data[pl],
        shape=(m, n),
    )
    return (csc, perm) if return_permutation else csc


def transpose(csr: CSR) -> CSR:
    """CSR of Aᵀ (materialized)."""
    return csr_to_csc(csr).as_csr_of_transpose()


def csr_from_scipy(sp) -> CSR:
    """scipy.sparse matrix -> CSR container (host-side helper)."""
    sp = sp.tocsr()
    sp.sort_indices()
    return CSR(
        indptr=torch.from_numpy(sp.indptr.astype(np.int32)),
        indices=torch.from_numpy(sp.indices.astype(np.int32)),
        data=torch.from_numpy(np.ascontiguousarray(sp.data)),
        shape=tuple(sp.shape),
    )


def out_degrees(csr: CSR) -> Tensor:
    """Number of nonzeros per row."""
    return csr.row_lengths()


def in_degrees(csr: CSR) -> Tensor:
    """Number of nonzeros per column."""
    _, n = csr.shape
    return torch.bincount(csr.indices.long(), minlength=n).to(torch.int32)
