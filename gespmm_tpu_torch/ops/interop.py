"""Interop with ``torch.sparse`` — port of ``gespmm_tpu/ops/interop.py``.

``torch.sparse`` takes the role that ``jax.experimental.sparse`` (BCOO)
plays in the JAX package: these adapters let code holding a torch sparse
tensor route through the port's kernels, and hand the port's matrices to
stock code.  Each function's JAX counterpart:

  * ``csr_from_torch_sparse``      <- ``csr_from_bcoo``
  * ``csr_to_torch_sparse``        <- ``csr_to_bcoo``
  * ``torch_sparse_spmm_baseline`` <- ``bcoo_spmm_baseline`` (the stock
    sparse-library tier: ``torch.sparse.mm``, cuSPARSE on the card)
  * ``AdjacencyMatrix``            <- ``AdjacencyMatrix`` (``from_bcoo`` is
    ``from_torch_sparse``, ``todense`` is ``to_dense``, ``to_bcoo`` is
    ``to_torch_sparse``)

``AdjacencyMatrix`` needs no pytree registration: autograd follows tensors,
not containers.
"""

from __future__ import annotations

import warnings

import torch

from gespmm_tpu_torch.sparse.formats import COO, CSR, csr_from_coo

Tensor = torch.Tensor

_LAYOUTS = (torch.sparse_coo, torch.sparse_csr)


def csr_from_torch_sparse(t: Tensor) -> CSR:
    """A 2-D ``torch.sparse_coo_tensor`` or ``sparse_csr`` tensor -> CSR.

    Duplicates are summed and entries sorted by (row, col); the CSR lives on
    the tensor's device and keeps its values.
    """
    if not isinstance(t, torch.Tensor) or t.layout not in _LAYOUTS:
        raise TypeError("expected a torch.sparse COO or CSR tensor, got "
                        f"{type(t) if not isinstance(t, torch.Tensor) else t.layout}")
    if t.dim() != 2 or t.dense_dim() != 0:
        raise ValueError("only plain 2-D torch.sparse tensors supported")
    coo = (t.to_sparse_coo() if t.layout == torch.sparse_csr else t).coalesce()
    rows, cols = coo.indices()
    return csr_from_coo(COO(row=rows.to(torch.int32), col=cols.to(torch.int32),
                            data=coo.values(), shape=tuple(t.shape)))


def csr_to_torch_sparse(csr: CSR) -> Tensor:
    """CSR -> ``torch.sparse_csr_tensor`` on the CSR's device, f32 ones
    where the CSR has no values.  Both index arrays are int64: cuSPARSE
    wants ``crow_indices`` and ``col_indices`` of one dtype."""
    vals = (torch.ones(csr.nnz, dtype=torch.float32, device=csr.device)
            if csr.data is None else csr.data)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(csr.indptr.long(), csr.indices.long(),
                                       vals, size=csr.shape)


def torch_sparse_spmm_baseline(csr: CSR, B: Tensor) -> Tensor:
    """The stock-library SpMM tier: ``torch.sparse.mm`` of the CSR and B."""
    return torch.sparse.mm(csr_to_torch_sparse(csr), B)


class AdjacencyMatrix:
    """A sparse matrix with the surface of a torch sparse tensor (``@``,
    ``.T``, ``.shape``, ``.dtype``, ``.to_dense()``) whose every product runs
    the port's ``spmm`` (on the card the CSR kernel, kernel row 1) with its
    gradients to the dense operand and to the values; it never calls
    ``torch.sparse.mm``.

        A = AdjacencyMatrix.from_torch_sparse(t)   # or .from_csr(csr)
        out = A @ x                                # spmm, autograd
        y = x @ A                                  # through __rmatmul__

    ``torch.Tensor.__matmul__`` returns ``NotImplemented`` for this type, so
    ``x @ A`` reaches ``__rmatmul__``.  ``.T`` is O(1): the ``Adjacency``
    carries both orderings.
    """

    def __init__(self, adj, transposed: bool = False):
        from gespmm_tpu_torch.ops.spmm import Adjacency

        if not isinstance(adj, Adjacency):
            raise TypeError(f"expected Adjacency, got {type(adj)}")
        self.adj = adj
        self.transposed = bool(transposed)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_csr(cls, csr: CSR, plan=True, device=None,
                 **plan_kwargs) -> "AdjacencyMatrix":
        """``plan`` and ``plan_kwargs`` as for ``Adjacency.from_csr``."""
        from gespmm_tpu_torch.ops.spmm import Adjacency

        return cls(Adjacency.from_csr(csr, device=device, plan=plan,
                                      **plan_kwargs))

    @classmethod
    def from_torch_sparse(cls, t: Tensor, plan=True,
                          **plan_kwargs) -> "AdjacencyMatrix":
        return cls.from_csr(csr_from_torch_sparse(t), plan=plan, **plan_kwargs)

    @classmethod
    def from_scipy(cls, mat, plan=True, device=None,
                   **plan_kwargs) -> "AdjacencyMatrix":
        from gespmm_tpu_torch.sparse.formats import csr_from_scipy

        return cls.from_csr(csr_from_scipy(mat.tocsr()), plan=plan,
                            device=device, **plan_kwargs)

    # -- the torch.sparse surface -----------------------------------------
    @property
    def _eff(self):
        return self.adj.transpose() if self.transposed else self.adj

    @property
    def shape(self):
        m, n = self.adj.shape
        return (n, m) if self.transposed else (m, n)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        d = self.adj.csr.data
        return torch.float32 if d is None else d.dtype

    @property
    def nse(self) -> int:  # BCOO's name for nnz
        return self.adj.nnz

    @property
    def nnz(self) -> int:
        return self.adj.nnz

    @property
    def T(self) -> "AdjacencyMatrix":
        return AdjacencyMatrix(self.adj, not self.transposed)

    def transpose(self) -> "AdjacencyMatrix":
        return self.T

    def __matmul__(self, other):
        from gespmm_tpu_torch.ops.spmm import spmm

        if isinstance(other, AdjacencyMatrix) or not isinstance(other, Tensor):
            return NotImplemented
        if other.dim() == 1:
            return spmm(self._eff, other[:, None])[:, 0]
        if other.dim() == 2:
            return spmm(self._eff, other)
        return NotImplemented

    def __rmatmul__(self, other):
        # x @ A == (Aᵀ @ xᵀ)ᵀ: one product over the paired ordering, no
        # transpose of the sparse matrix materialised.
        if not isinstance(other, Tensor):
            return NotImplemented
        if other.dim() == 1:
            return self.T @ other
        if other.dim() == 2:
            return (self.T @ other.T).T
        return NotImplemented

    def to_dense(self) -> Tensor:
        eff = self._eff
        data = (torch.ones(self.nnz, dtype=self.dtype, device=eff.rows.device)
                if eff.csr.data is None else eff.csr.data)
        out = torch.zeros(self.shape, dtype=data.dtype, device=data.device)
        return out.index_put((eff.rows.long(), eff.csr.indices.long()), data,
                             accumulate=True)

    def to_torch_sparse(self) -> Tensor:
        return csr_to_torch_sparse(self._eff.csr)

    def with_data(self, data) -> "AdjacencyMatrix":
        if self.transposed:
            raise ValueError("set data on the untransposed matrix")
        return AdjacencyMatrix(self.adj.with_data(data))

    def __repr__(self):
        m, n = self.shape
        return (f"AdjacencyMatrix({m}x{n}, nse={self.nnz}, "
                f"dtype={self.dtype})")
