"""Plain PyTorch SpMM and SDDMM — the reference the CUDA kernel is held to.

Counterpart of ``gespmm_tpu/ops/reference.py`` (sum reduction only in this
port so far).  These run on any device: the CPU tests use them, the
``method="xla"`` tier runs them on the card, and ``chip_smoke.py`` compares
the kernel with them (in float64 there).
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def spmm_rows(rows: Tensor, indices: Tensor, data: Optional[Tensor],
              B: Tensor, m: int) -> Tensor:
    """out[r] = Σ_{e: rows[e]=r} data[e] · B[indices[e]].

    Accumulates in f32 (f64 for f64 inputs); ``data=None`` means 1.0; the
    output takes B's dtype.  Empty rows give 0.
    """
    acc = _acc_dtype(B.dtype)
    contrib = B.index_select(0, indices.long()).to(acc)
    if data is not None:
        contrib = contrib * data.to(acc)[:, None]
    out = torch.zeros((m, B.shape[1]), dtype=acc, device=B.device)
    out.index_add_(0, rows.long(), contrib)
    return out.to(B.dtype)


def sddmm_rows(rows: Tensor, cols: Tensor, D1: Tensor, D2: Tensor) -> Tensor:
    """out[e] = D1[rows[e]] · D2[cols[e]], accumulated in f32."""
    acc = _acc_dtype(D1.dtype)
    a = D1.index_select(0, rows.long()).to(acc)
    b = D2.index_select(0, cols.long()).to(acc)
    return (a * b).sum(-1).to(D1.dtype)
