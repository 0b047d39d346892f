"""SDDMM with its VJP — port of ``gespmm_tpu/ops/sddmm.py``.

out[e] = D1[row(e), :] · D2[col(e), :] for every nonzero e of the pattern.
The forward is the plain gather-dot (``ops/reference.py::sddmm_rows``), as
in the JAX package, where it is XLA's and not a Pallas kernel.  The VJP is
a pair of SpMMs with the cotangent as edge values:

    grad_D1 = A(g) @ D2,   grad_D2 = A(g)ᵀ @ D1.

Over an ``Adjacency`` they run through ``ops/spmm.py::spmm``, so with
``method="auto"``/``"tiled"`` a CUDA tensor takes the CSR kernel (over the
CSR, then over the CSC) and ``"xla"`` the plain version.  ``sddmm_coo``,
over an explicit COO pattern, takes the plain SpMMs, as the JAX package's
does.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from gespmm_tpu_torch.ops import reference as ref
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.sparse.formats import CSR

Tensor = torch.Tensor

METHODS = ("auto", "tiled", "xla")


def _check_operands(D1: Tensor, D2: Tensor) -> None:
    if D1.dim() != 2 or D2.dim() != 2 or D1.shape[1] != D2.shape[1]:
        raise ValueError(f"D1 {tuple(D1.shape)} / D2 {tuple(D2.shape)} must be "
                         "(m,K)/(n,K)")


class _SddmmCoo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows: Tensor, cols: Tensor, m: int, n: int, D1: Tensor,
                D2: Tensor) -> Tensor:
        ctx.m, ctx.n = m, n
        ctx.save_for_backward(rows, cols, D1, D2)
        return ref.sddmm_rows(rows, cols, D1, D2)

    @staticmethod
    def backward(ctx, g: Tensor):
        rows, cols, D1, D2 = ctx.saved_tensors
        grad_D1 = ref.spmm_rows(rows, cols, g, D2, ctx.m).to(D1.dtype)
        grad_D2 = ref.spmm_rows(cols, rows, g, D1, ctx.n).to(D2.dtype)
        return None, None, None, None, grad_D1, grad_D2


class _SddmmAdj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adj: Adjacency, method: str, D1: Tensor,
                D2: Tensor) -> Tensor:
        ctx.adj, ctx.method = adj, method
        ctx.save_for_backward(D1, D2)
        return ref.sddmm_rows(adj.rows, adj.csr.indices, D1, D2)

    @staticmethod
    def backward(ctx, g: Tensor):
        adj, method = ctx.adj, ctx.method
        D1, D2 = ctx.saved_tensors
        weighted = adj.with_data(g.contiguous())
        grad_D1 = spmm(weighted, D2, method=method).to(D1.dtype)
        grad_D2 = spmm(weighted.transpose(), D1, method=method).to(D2.dtype)
        return None, None, grad_D1, grad_D2


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown sddmm method {method!r} (auto | tiled | xla)")


def sddmm_coo(rows: Tensor, cols: Tensor, D1: Tensor, D2: Tensor, *,
              shape: Optional[Tuple[int, int]] = None,
              method: str = "auto") -> Tensor:
    """SDDMM over an explicit COO pattern; returns per-edge values.

    Accumulates in f32; the values take D1's dtype.  ``method`` is "auto" or
    "xla", both the plain gather-dot.
    """
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown sddmm method {method!r} (auto | xla | tiled; "
                         "tiled needs an Adjacency)")
    _check_operands(D1, D2)
    m = D1.shape[0] if shape is None else shape[0]
    n = D2.shape[0] if shape is None else shape[1]
    return _SddmmCoo.apply(rows, cols, m, n, D1, D2)


def sddmm(adj: Union[Adjacency, CSR], D1: Tensor, D2: Tensor, *,
          method: str = "auto") -> Tensor:
    """SDDMM over a CSR/Adjacency pattern; per-edge values in CSR order.

    A bare ``CSR`` is paired into an ``Adjacency`` on the fly, as ``spmm``
    does.  ``method``: "auto" | "tiled" (the VJP's two SpMMs run the CUDA
    kernel on a CUDA tensor) | "xla" (every step plain).
    """
    _check_method(method)
    _check_operands(D1, D2)
    if isinstance(adj, CSR):
        adj = Adjacency.from_csr(adj)
    m, n = adj.shape
    if D1.shape[0] != m or D2.shape[0] != n:
        raise ValueError(f"D1/D2 rows {D1.shape[0]}/{D2.shape[0]} must match "
                         f"the pattern {adj.shape}")
    return _SddmmAdj.apply(adj, method, D1, D2)
