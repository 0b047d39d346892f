"""SpMM with a transpose-paired autograd Function — port of ``gespmm_tpu/ops/spmm.py``.

The backward of SpMM is SpMM on Aᵀ, so ``Adjacency`` carries both the CSR
and the CSC ordering (plus the CSC -> CSR edge permutation), built once per
graph, and the backward never transposes at step time:

  * grad_B = Aᵀ @ g, the same kernel over the CSC with ``data[perm]``;
  * grad_values[e] = g[row_e] · B[col_e] (SDDMM, in CSR order), computed
    only when the edge values require a gradient.

``reduce="mean"`` composes on sum.  Method tiers: ``"auto"``/``"tiled"`` run
the CUDA kernel on a CUDA tensor and its plain version on a CPU tensor;
``"xla"`` is the plain PyTorch version on any device (kept as the explicit
reference tier, named after the JAX package's tier).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from gespmm_tpu_torch.kernels.spmm_csr import spmm_csr
from gespmm_tpu_torch.ops import reference as ref
from gespmm_tpu_torch.sparse.formats import CSC, CSR

Tensor = torch.Tensor

MODES = ("trilo", "hilo", "fast", "highest")
METHODS = ("auto", "tiled", "xla", "pallas", "scatter", "dense")
REDUCES = ("sum", "mean", "max", "min")
# Accepted by the JAX package, not ported yet: each names its ROADMAP item.
_NOT_PORTED = {
    "pallas": "method='pallas' (per-row and grouped kernels) is ROADMAP B5/B6",
    "scatter": "method='scatter' (the push tier) is ROADMAP A2",
    "dense": "method='dense' (the densify tier) is ROADMAP A2",
    "max": "reduce='max' is ROADMAP B2",
    "min": "reduce='min' is ROADMAP B2",
}


@dataclasses.dataclass(frozen=True)
class Adjacency:
    """A sparse matrix with both row- and column-compressed orderings.

    ``perm`` maps CSC edge order -> CSR edge order (``csc.data = data[perm]``);
    ``inv_perm`` is its inverse.  ``rows``/``rows_t`` are the per-nonzero row
    ids of the CSR and of the CSC (the CSR of Aᵀ).
    """

    csr: CSR
    csc: CSC
    perm: Tensor
    rows: Tensor
    rows_t: Tensor
    inv_perm: Tensor

    @classmethod
    def from_csr(cls, csr: CSR, device=None) -> "Adjacency":
        """Build the paired orderings on the host, then move them to
        ``device`` (default: the device ``csr`` lives on)."""
        device = csr.device if device is None else torch.device(device)
        indptr_h = csr.indptr.cpu().numpy()
        indices_h = csr.indices.cpu().numpy()
        m, n = csr.shape
        nnz = int(indices_h.shape[0])
        order = np.argsort(indices_h, kind="stable")
        rows_h = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr_h))
        colptr_h = np.zeros(n + 1, np.int64)
        colptr_h[1:] = np.cumsum(np.bincount(indices_h, minlength=n))
        perm_h = order.astype(np.int32)
        inv_perm_h = np.empty_like(perm_h)
        inv_perm_h[perm_h] = np.arange(nnz, dtype=np.int32)

        def dev(a: np.ndarray) -> Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        csr_d = csr.to(device)
        perm = dev(perm_h)
        csc = CSC(
            indptr=dev(colptr_h.astype(np.int32)),
            indices=dev(rows_h[order]),
            data=None if csr_d.data is None else csr_d.data[perm.long()],
            shape=(m, n),
        )
        rows_t = dev(np.repeat(np.arange(n, dtype=np.int32), np.diff(colptr_h)))
        return cls(csr=csr_d, csc=csc, perm=perm, rows=dev(rows_h),
                   rows_t=rows_t, inv_perm=dev(inv_perm_h))

    @property
    def shape(self):
        return self.csr.shape

    @property
    def nnz(self) -> int:
        return self.csr.nnz

    @property
    def data(self) -> Optional[Tensor]:
        return self.csr.data

    def with_data(self, data: Optional[Tensor]) -> "Adjacency":
        csc_data = None if data is None else data[self.perm.long()]
        return dataclasses.replace(self, csr=self.csr.with_data(data),
                                   csc=self.csc.with_data(csc_data))

    def transpose(self) -> "Adjacency":
        """Adjacency of Aᵀ (cheap — swaps the paired orderings)."""
        m, n = self.shape
        return Adjacency(
            csr=CSR(self.csc.indptr, self.csc.indices, self.csc.data, (n, m)),
            csc=CSC(self.csr.indptr, self.csr.indices, self.csr.data, (n, m)),
            perm=self.inv_perm, rows=self.rows_t, rows_t=self.rows,
            inv_perm=self.perm,
        )


def _forward(method: str, indptr: Tensor, indices: Tensor,
             data: Optional[Tensor], B: Tensor, rows: Tensor) -> Tensor:
    if method == "xla":
        return ref.spmm_rows(rows, indices, data, B, indptr.shape[0] - 1)
    return spmm_csr(indptr, indices, data, B, rows=rows)


class _SpmmSum(torch.autograd.Function):
    """Sum-SpMM over ``adj``; differentiable in ``data`` and ``B``."""

    @staticmethod
    def forward(ctx, adj: Adjacency, method: str, data: Optional[Tensor],
                B: Tensor) -> Tensor:
        ctx.adj, ctx.method = adj, method
        ctx.save_for_backward(data, B if ctx.needs_input_grad[2] else None)
        return _forward(method, adj.csr.indptr, adj.csr.indices, data, B,
                        adj.rows)

    @staticmethod
    def backward(ctx, g: Tensor):
        adj, method = ctx.adj, ctx.method
        data, B = ctx.saved_tensors
        g = g.contiguous()  # autograd often hands in an expanded view
        grad_data = grad_B = None
        if ctx.needs_input_grad[3]:
            t_data = None if data is None else data[adj.perm.long()]
            grad_B = _forward(method, adj.csc.indptr, adj.csc.indices,
                              t_data, g, adj.rows_t)
        if data is not None and ctx.needs_input_grad[2]:
            grad_data = ref.sddmm_rows(adj.rows, adj.csr.indices, g, B)
            grad_data = grad_data.to(data.dtype)
        return None, None, grad_data, grad_B


def _check_method(reduce: str, method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    for key in (method, reduce):
        if key in _NOT_PORTED:
            raise NotImplementedError(
                f"{_NOT_PORTED[key]}: not ported yet; use method='auto' or "
                "'xla' with reduce='sum' or 'mean'"
            )


def spmm(adj: Union[Adjacency, CSR], B: Tensor, *, reduce: str = "sum",
         method: str = "auto", mode: str = "trilo") -> Tensor:
    """C = reduce_e A[r, c_e] * B[c_e, :] — sparse × dense.

    Args:
      adj: ``Adjacency`` (preferred — carries the transpose pairing) or a
        bare ``CSR`` (the pairing is built on the fly).
      B: dense (n, K) tensor, float32 or bfloat16 on the card.
      reduce: "sum" | "mean".
      method: "auto" | "tiled" (the CUDA kernel on the card) | "xla" (plain).
      mode: "trilo" | "hilo" | "fast" | "highest", validated as in the JAX
        package; every mode accumulates in f32 here, which meets each
        mode's tolerance.

    Differentiable in ``B`` and in ``adj``'s edge values (if present).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be trilo|hilo|fast|highest, got {mode!r}")
    if isinstance(adj, CSR):
        adj = Adjacency.from_csr(adj)
    if B.dim() != 2:
        raise ValueError(f"B must be rank 2, got shape {tuple(B.shape)}")
    m, n = adj.shape
    if B.shape[0] != n:
        raise ValueError(
            f"A is {adj.shape}, B is {tuple(B.shape)}: inner dims differ"
        )
    _check_method(reduce, method)
    if reduce == "mean":
        out = spmm(adj, B, reduce="sum", method=method, mode=mode)
        deg = (adj.csr.indptr[1:] - adj.csr.indptr[:-1]).to(out.dtype)
        return out / torch.clamp(deg, min=1.0)[:, None]
    return _SpmmSum.apply(adj, method, adj.csr.data, B)
