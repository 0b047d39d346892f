"""Plain PyTorch SpMM and SDDMM — the reference the CUDA kernels are held to.

Counterpart of ``gespmm_tpu/ops/reference.py``.  These run on any device:
the CPU tests use them, the ``method="xla"`` tier runs them on the card, and
``chip_smoke.py`` compares the kernels with them (in float64 there).

Max/min contributions are ``val_e * B[col_e]`` formed as one f32 product
(one f64 product for f64 inputs), exactly as the kernels form them, so that
an achieving edge can be found again with ``==``.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

REDUCTIONS = ("sum", "max", "min")
_SCATTER = {"max": "amax", "min": "amin"}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _contrib(indices: Tensor, data: Optional[Tensor], B: Tensor) -> Tensor:
    """(nnz, K) contributions val_e * B[col_e] in the accumulation dtype."""
    acc = _acc_dtype(B.dtype)
    contrib = B.index_select(0, indices.long()).to(acc)
    if data is not None:
        contrib = contrib * data.to(acc)[:, None]
    return contrib


def _minmax_rows(rows: Tensor, contrib: Tensor, m: int, reduce: str) -> Tensor:
    """Per-row max/min of ``contrib``; rows without an edge stay 0."""
    out = torch.zeros((m, contrib.shape[1]), dtype=contrib.dtype,
                      device=contrib.device)
    idx = rows.long()[:, None].expand_as(contrib)
    return out.scatter_reduce_(0, idx, contrib, _SCATTER[reduce],
                               include_self=False)


def spmm_rows(rows: Tensor, indices: Tensor, data: Optional[Tensor],
              B: Tensor, m: int, reduce: str = "sum") -> Tensor:
    """out[r] = reduce_{e: rows[e]=r} data[e] · B[indices[e]].

    Accumulates in f32 (f64 for f64 inputs); ``data=None`` means 1.0; the
    output takes B's dtype.  Empty rows give 0 under every reduction.
    """
    if reduce not in REDUCTIONS:
        raise ValueError(f"reduce must be one of {REDUCTIONS}, got {reduce!r}")
    contrib = _contrib(indices, data, B)
    if reduce == "sum":
        out = torch.zeros((m, B.shape[1]), dtype=contrib.dtype, device=B.device)
        out.index_add_(0, rows.long(), contrib)
    else:
        out = _minmax_rows(rows, contrib, m, reduce)
    return out.to(B.dtype)


def spmm_minmax_rows(rows: Tensor, indices: Tensor, data: Optional[Tensor],
                     B: Tensor, m: int, reduce: str):
    """(out, ties): the plain version of the max/min forward kernel.

    ``ties[r, k]`` (f32) counts the edges whose contribution equals the
    extremum in the accumulation dtype, before ``out`` is cast to B's
    dtype, as the kernel counts them.  Empty rows give 0 and 0.
    """
    contrib = _contrib(indices, data, B)
    best = _minmax_rows(rows, contrib, m, reduce)
    hit = (contrib == best.index_select(0, rows.long())).to(torch.float32)
    ties = torch.zeros((m, B.shape[1]), dtype=torch.float32, device=B.device)
    ties.index_add_(0, rows.long(), hit)
    return best.to(B.dtype), ties


def spmm_max_vjp_edges(rows: Tensor, indices: Tensor, data: Optional[Tensor],
                       B: Tensor, out: Tensor, g: Tensor, m: int) -> Tensor:
    """Per-(edge, k) cotangent of the contribution, with even tie-splitting.

    Mirrors ``gespmm_tpu/ops/reference.py::spmm_max_vjp_edges``: an edge
    achieves ``out[r, k]`` when its contribution equals the STORED output
    (cast up), and the ``ties`` achieving edges share ``g[r, k]`` evenly.
    Serves max and min alike.
    """
    contrib = _contrib(indices, data, B)
    acc = contrib.dtype
    r = rows.long()
    is_max = (contrib == out.index_select(0, r).to(acc)).to(acc)
    ties = torch.zeros((m, B.shape[1]), dtype=acc, device=B.device)
    ties.index_add_(0, r, is_max)
    weight = is_max / torch.clamp(ties.index_select(0, r), min=1.0)
    return g.index_select(0, r).to(acc) * weight


def spmm_minmax_vjp_cols(cols: Tensor, rows: Tensor, data: Optional[Tensor],
                         B: Tensor, out: Tensor, g_over_ties: Tensor,
                         want_values: bool = True):
    """(grad_B, grad_vals): the plain version of the max/min backward kernel.

    Walks the edges in CSC order: edge e joins column ``cols[e]`` (B's row)
    to row ``rows[e]`` (out's row).  An edge achieves ``out[r, k]`` when its
    contribution, formed in B's accumulation dtype as in the forward,
    equals the stored output; it then carries ``g_over_ties[r, k]``:

        grad_B[c, k]  = Σ_{e in col c} val_e · [achieves] · g_over_ties[r_e, k]
        grad_vals[e]  = Σ_k [achieves] · g_over_ties[r_e, k] · B[c, k]

    The sums run, and both results come back, in ``g_over_ties``'s
    accumulation dtype (f32, or float64 for a float64 reference): the
    kernel's wrapper casts ``grad_B`` to B's dtype.  ``grad_vals`` is in CSC
    order, None unless ``data`` is given and ``want_values``.
    """
    contrib = _contrib(cols, data, B)
    r = rows.long()
    eq = contrib == out.index_select(0, r).to(contrib.dtype)
    acc = _acc_dtype(g_over_ties.dtype)
    w = torch.where(eq, g_over_ties.index_select(0, r).to(acc),
                    torch.zeros((), dtype=acc, device=B.device))
    stream = w if data is None else w * data.to(acc)[:, None]
    grad_B = torch.zeros((B.shape[0], B.shape[1]), dtype=acc, device=B.device)
    grad_B.index_add_(0, cols.long(), stream)
    grad_vals = None
    if data is not None and want_values:
        grad_vals = (w * B.index_select(0, cols.long()).to(acc)).sum(-1)
    return grad_B, grad_vals


def sddmm_rows(rows: Tensor, cols: Tensor, D1: Tensor, D2: Tensor) -> Tensor:
    """out[e] = D1[rows[e]] · D2[cols[e]], accumulated in f32."""
    acc = _acc_dtype(D1.dtype)
    a = D1.index_select(0, rows.long()).to(acc)
    b = D2.index_select(0, cols.long()).to(acc)
    return (a * b).sum(-1).to(D1.dtype)
