"""Plain PyTorch SpMM, SDDMM, edge segment reduce and fused GAT attention — the
reference the CUDA kernels are held to.

Counterpart of ``gespmm_tpu/ops/reference.py`` (and of the math of
``gespmm_tpu/kernels/gat_fused.py``).  These run on any device:
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


# --- edge segment reduce and fused GAT attention (kernel rows 4 and 5) -----

# The constants of gespmm_tpu/kernels/gat_fused.py: the exp() argument floor
# (arguments are <= 0 by construction; below -80 the result underflows) and
# the denominator guard, a normal f32, which only empty rows reach.
EXP_FLOOR = -80.0
DENOM_EPS = 1e-20
SEGMENT_OPS = ("sum", "max")


def leaky(x: Tensor, slope: float) -> Tensor:
    return torch.where(x >= 0, x, slope * x)


def dleaky(x: Tensor, slope: float) -> Tensor:
    """leaky'(x): 1 where x >= 0, else ``slope``."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, one * slope)


def edge_segment_rows(rows: Tensor, vals: Tensor, m: int, op: str = "sum") -> Tensor:
    """Per-row sum or max of (nnz, K) edge values: out[r] = op_{e: rows[e]=r} vals[e].

    Accumulates in f32 (f64 for f64 values); the output takes the values'
    dtype.  A non-finite max (an empty row, or an infinite value) becomes 0,
    as in ``gespmm_tpu/kernels/spmm_stream.py::edge_segment_reduce``.
    ``rows`` need not be sorted.
    """
    if op not in SEGMENT_OPS:
        raise ValueError(f"op must be one of {SEGMENT_OPS}, got {op!r}")
    if vals.dim() != 2:
        raise ValueError(f"vals must be (nnz, K), got {tuple(vals.shape)}")
    acc = _acc_dtype(vals.dtype)
    v = vals.to(acc)
    idx = rows.long()
    if op == "sum":
        out = torch.zeros((m, v.shape[1]), dtype=acc, device=v.device)
        out.index_add_(0, idx, v)
    else:
        out = torch.full((m, v.shape[1]), float("-inf"), dtype=acc,
                         device=v.device)
        out.scatter_reduce_(0, idx[:, None].expand_as(v), v, "amax")
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out.to(vals.dtype)


def _gat_acc(*tensors: Tensor) -> torch.dtype:
    """f32, or f64 when any input is f64 (the card's float64 references)."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
            else torch.float32)


def gat_bound_shift(src2: Tensor, dst2: Tensor, slope: float) -> Tensor:
    """The "bound" softmax shift (m, H): leaky(src[r] + max_c dst[c]) per
    head, an upper bound of every logit of the row (leaky is monotone)."""
    acc = _gat_acc(src2, dst2)
    return leaky(src2.to(acc) + dst2.to(acc).max(0).values, slope)


def gat_row_max(rows: Tensor, cols: Tensor, src2: Tensor, dst2: Tensor, m: int,
                slope: float, max_mode: str = "exact") -> Tensor:
    """The softmax shift ``mx`` (m, H) of the fused forward.

    "exact": the row max of leaky(src[r] + dst[c]), 0 where non-finite (empty
    rows).  "bound": ``gat_bound_shift``.
    """
    if max_mode == "bound":
        return gat_bound_shift(src2, dst2, slope)
    acc = _gat_acc(src2, dst2)
    s, d = src2.to(acc), dst2.to(acc)
    pre = s.index_select(0, rows.long()) + d.index_select(0, cols.long())
    return edge_segment_rows(rows, leaky(pre, slope), m, "max")


def _gat_edge_terms(rows, cols, src2, dst2, mx, slope):
    """(pre, z) per (edge, head): pre = src[r] + dst[c],
    z = exp(max(leaky(pre) - mx[r], EXP_FLOOR))."""
    r, c = rows.long(), cols.long()
    pre = src2.index_select(0, r) + dst2.index_select(0, c)
    z = torch.exp(torch.clamp(leaky(pre, slope) - mx.index_select(0, r),
                              min=EXP_FLOOR))
    return pre, z


def gat_fused_rows(rows: Tensor, cols: Tensor, src2: Tensor, dst2: Tensor,
                   B: Tensor, m: int, slope: float = 0.2,
                   max_mode: str = "exact", heads: int = 1, mx: Tensor = None):
    """(out, mx, den): the plain version of the fused GAT forward kernel.

    As ``gespmm_tpu/kernels/gat_fused.py::_forward`` computes it, per head
    block of B (n, H·dh): pre = src[r] + dst[c], l = leaky(pre), mx the
    shift of ``gat_row_max`` (or ``mx`` as given), z = exp(max(l − mx,
    EXP_FLOOR)), den = max(Σ z, DENOM_EPS), out = Σ z·B[c] / den.  ``out``
    takes B's dtype; ``mx`` and ``den`` (m, H) stay in the accumulation
    dtype (f32, or f64 for an f64 input).  Empty rows give out 0.
    """
    acc = _gat_acc(src2, dst2, B)
    H = heads
    dh = B.shape[1] // H
    s, d = src2.to(acc), dst2.to(acc)
    if mx is None:
        mx = gat_row_max(rows, cols, s, d, m, slope, max_mode)
    mx = mx.to(acc)
    _, z = _gat_edge_terms(rows, cols, s, d, mx, slope)
    den = torch.zeros((m, H), dtype=acc, device=B.device)
    den.index_add_(0, rows.long(), z)
    den = torch.clamp(den, min=DENOM_EPS)
    nnz = z.shape[0]
    gb = B.index_select(0, cols.long()).to(acc).view(nnz, H, dh)
    out = torch.zeros((m, H, dh), dtype=acc, device=B.device)
    out.index_add_(0, rows.long(), gb * z[:, :, None])
    out = (out / den[:, :, None]).view(m, H * dh)
    return out.to(B.dtype), mx, den


def _gat_dpre(rows, cols, src2, dst2, B, g, mx, den, s_row, slope, heads):
    """(alpha, dpre) per (edge, head), both in the accumulation dtype:
    alpha = exp(max(l − mx, EXP_FLOOR)) / den and
    dpre = alpha·(g[r]_h · B[c]_h − s[r])·leaky'(pre)."""
    acc = _gat_acc(src2, dst2, B, g)
    H = heads
    dh = B.shape[1] // H
    r, c = rows.long(), cols.long()
    pre, z = _gat_edge_terms(rows, cols, src2.to(acc), dst2.to(acc),
                             mx.to(acc), slope)
    alpha = z / torch.clamp(den.to(acc), min=DENOM_EPS).index_select(0, r)
    nnz = pre.shape[0]
    u = (g.to(acc).index_select(0, r) * B.to(acc).index_select(0, c)).view(
        nnz, H, dh).sum(-1)
    dpre = alpha * (u - s_row.to(acc).index_select(0, r)) * dleaky(pre, slope)
    return alpha, dpre


def gat_row_dot(g: Tensor, out: Tensor, heads: int) -> Tensor:
    """s = <g_r, out_r> per head (m, H), from the STORED ``out`` cast up, as
    ``gespmm_tpu/kernels/gat_fused.py::_gat_bwd`` forms it."""
    acc = _gat_acc(g, out)
    m, K = out.shape
    return (g.to(acc) * out.to(acc)).view(m, heads, K // heads).sum(-1)


def gat_fused_vjp_rows(rows, cols, src2, dst2, B, g, mx, den, s_row, m,
                       slope=0.2, heads=1) -> Tensor:
    """grad_src (m, H) = Σ_{e in row r} dpre_e: the plain version of the
    fused backward kernel over the CSR."""
    _, dpre = _gat_dpre(rows, cols, src2, dst2, B, g, mx, den, s_row, slope,
                        heads)
    out = torch.zeros((m, heads), dtype=dpre.dtype, device=dpre.device)
    return out.index_add_(0, rows.long(), dpre)


def gat_fused_vjp_cols(rows, cols, src2, dst2, B, g, mx, den, s_row,
                       slope=0.2, heads=1):
    """(grad_dst (n, H), grad_B (n, K)): grad_dst[c] = Σ_{e in col c} dpre_e
    and grad_B[c] = Σ_{e in col c} alpha_e·g[r_e] per head block, the plain
    version of the fused backward kernel over the CSC.  Both stay in the
    accumulation dtype."""
    alpha, dpre = _gat_dpre(rows, cols, src2, dst2, B, g, mx, den, s_row,
                            slope, heads)
    n, K = B.shape
    dh = K // heads
    c = cols.long()
    grad_dst = torch.zeros((n, heads), dtype=dpre.dtype, device=dpre.device)
    grad_dst.index_add_(0, c, dpre)
    nnz = alpha.shape[0]
    ga = (g.to(alpha.dtype).index_select(0, rows.long()).view(nnz, heads, dh)
          * alpha[:, :, None]).view(nnz, K)
    grad_B = torch.zeros((n, K), dtype=dpre.dtype, device=dpre.device)
    grad_B.index_add_(0, c, ga)
    return grad_dst, grad_B


def gat_fused_vjp(rows, cols, src2, dst2, B, out, mx, den, g, m, slope=0.2,
                  heads=1):
    """(grad_src, grad_dst, grad_B) of the fused GAT op, as ``_gat_bwd``
    computes them, with s = <g, out> from the stored ``out``."""
    s_row = gat_row_dot(g, out, heads)
    grad_src = gat_fused_vjp_rows(rows, cols, src2, dst2, B, g, mx, den, s_row,
                                  m, slope, heads)
    grad_dst, grad_B = gat_fused_vjp_cols(rows, cols, src2, dst2, B, g, mx, den,
                                          s_row, slope, heads)
    return grad_src, grad_dst, grad_B
