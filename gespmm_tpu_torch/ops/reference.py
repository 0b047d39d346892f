"""Plain PyTorch SpMM, SDDMM, edge segment reduce, fused GAT and dot-product
attention, the chunked and grouped SpMMs and the joint diag+halo SpMM of the
sharded tier — the reference the CUDA kernels are held to.

Counterpart of ``gespmm_tpu/ops/reference.py`` (with its scatter and dense
tiers) and of the math of ``gespmm_tpu/kernels/gat_fused.py``,
``spmm_pallas.py``, ``spmm_grouped.py`` and ``parallel/halo.py``.  These
run on any device: the CPU tests use them, the ``method="xla"`` tier runs
them on the card, and ``chip_smoke.py`` compares the kernels with them (in
float64 there).

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
    """Per-row max/min of ``contrib``; rows without an edge give 0.

    The scatter starts from the reduction's identity (±inf; rows without an
    edge are masked to 0 after), so that autograd splits a row's gradient
    among the edges that achieve its extremum only: from a start of 0 with
    ``include_self=False`` torch counts the start as one more tie of a row
    whose extremum is 0.  A NaN or ±inf extremum of a row with edges stays.
    """
    ident = float("-inf") if reduce == "max" else float("inf")
    out = torch.full((m, contrib.shape[1]), ident, dtype=contrib.dtype,
                     device=contrib.device)
    idx = rows.long()[:, None].expand_as(contrib)
    out.scatter_reduce_(0, idx, contrib, _SCATTER[reduce])
    has_edge = torch.zeros(m, dtype=torch.bool, device=out.device)
    has_edge.index_fill_(0, rows.long(), True)
    return torch.where(has_edge[:, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


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


def _minmax_vjp_stream(cols: Tensor, rows: Tensor, data: Optional[Tensor],
                       B: Tensor, out: Tensor, g_over_ties: Tensor):
    """(w, stream): each CSC edge's weight w_e[k] (the tie share of the
    output it achieves, else 0) and its grad_B term val_e · w_e[k], in
    ``g_over_ties``'s accumulation dtype."""
    contrib = _contrib(cols, data, B)
    r = rows.long()
    eq = contrib == out.index_select(0, r).to(contrib.dtype)
    acc = _acc_dtype(g_over_ties.dtype)
    w = torch.where(eq, g_over_ties.index_select(0, r).to(acc),
                    torch.zeros((), dtype=acc, device=B.device))
    return w, (w if data is None else w * data.to(acc)[:, None])


def _minmax_vjp_values(w: Tensor, cols: Tensor, data: Optional[Tensor],
                       B: Tensor, want_values: bool) -> Optional[Tensor]:
    """grad_vals[e] = Σ_k w_e[k] · B[c_e, k], or None."""
    if data is None or not want_values:
        return None
    return (w * B.index_select(0, cols.long()).to(w.dtype)).sum(-1)


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
    w, stream = _minmax_vjp_stream(cols, rows, data, B, out, g_over_ties)
    grad_B = torch.zeros((B.shape[0], B.shape[1]), dtype=w.dtype,
                         device=B.device)
    grad_B.index_add_(0, cols.long(), stream)
    return grad_B, _minmax_vjp_values(w, cols, data, B, want_values)


def spmm_minmax_vjp_split_cols(cols: Tensor, colptr: Tensor, rows: Tensor,
                               data: Optional[Tensor], B: Tensor, out: Tensor,
                               g_over_ties: Tensor, seg_row: Tensor,
                               long_rows: Tensor, seg_ptr: Tensor,
                               seg_len: int, want_values: bool = True):
    """The plain version of the split max/min backward kernel: the columns
    of at most ``seg_len`` edges reduced as in ``spmm_minmax_vjp_cols``;
    each longer column's segments of ``seg_len`` consecutive edges summed
    apart (the column split of ``sparse/partition.py::build_row_split``:
    ``seg_row``, ``long_rows``, ``seg_ptr``), then added into the column in
    segment order, as the kernel's carry adds them.  ``grad_vals`` is per
    edge, so the split leaves it as ``spmm_minmax_vjp_cols`` gives it.
    """
    n = colptr.shape[0] - 1
    w, stream = _minmax_vjp_stream(cols, rows, data, B, out, g_over_ties)
    # Rows 0..n-1 of the buffer take the short columns' edges, rows n.. the
    # segments'; a long column's own row stays 0 and then takes its
    # segments in order.
    target, _ = split_units(cols, colptr, n, long_rows, seg_ptr, seg_len)
    buf = torch.zeros((n + seg_row.shape[0], B.shape[1]), dtype=w.dtype,
                      device=B.device)
    buf.index_add_(0, target, stream)
    grad_B = buf[:n].index_add_(0, seg_row.long(), buf[n:])
    return grad_B, _minmax_vjp_values(w, cols, data, B, want_values)


def spmm_minmax_vjp_split_stacked(t_indptr: Tensor, t_rows: Tensor,
                                  t_vals: Optional[Tensor], B: Tensor,
                                  out: Tensor, g_over_ties: Tensor,
                                  seg_row: Tensor, long_rows: Tensor,
                                  seg_ptr: Tensor, seg_len: int,
                                  row0: int = 0, slot0: int = 0,
                                  want_values: bool = True):
    """The plain version of the stacked, split max/min backward kernel.

    n shards' CSCs stacked as ``spmm_minmax.cu`` takes them: ``t_indptr``
    (n, cols + 1), ``t_rows`` and ``t_vals`` (n, stride), padded past each
    shard's edges; shard i's row ids index its slab of ``out`` and
    ``g_over_ties`` (n * rows, K), and its column c is B's row i * cols + c.
    The shards are laid end to end as one CSC of n * cols columns, and
    ``spmm_minmax_vjp_split_cols`` walks it with the split of those stacked
    columns (``long_rows``/``seg_row`` from ``row0``, slots ``seg_ptr``
    from ``slot0``: ``sparse/partition.py::build_shard_split``).
    ``grad_vals`` comes back (n, stride) in each shard's CSC order, 0 past
    its edges.
    """
    n, stride = t_rows.shape
    dev = t_rows.device
    ptr = t_indptr.long()
    deg = (ptr[:, 1:] - ptr[:, :-1]).reshape(-1)
    colptr = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        torch.cumsum(deg, 0)])
    valid = torch.arange(stride, device=dev)[None, :] < ptr[:, -1:]
    shard = torch.arange(n, device=dev)[:, None]
    rows = (t_rows.long() + shard * (out.shape[0] // n))[valid]
    vals = None if t_vals is None else t_vals[valid]
    cols = torch.repeat_interleave(torch.arange(deg.shape[0], device=dev), deg)
    grad_B, gv = spmm_minmax_vjp_split_cols(
        cols, colptr, rows, vals, B, out, g_over_ties, seg_row.long() - row0,
        long_rows.long() - row0, seg_ptr.long() - slot0, seg_len, want_values)
    if gv is None:
        return grad_B, None
    full = torch.zeros((n, stride), dtype=gv.dtype, device=dev)
    full[valid] = gv
    return grad_B, full


def _head_contrib(indices: Tensor, data: Optional[Tensor], B: Tensor) -> Tensor:
    """``_contrib`` with per-head values too: (nnz, H) values over a
    head-blocked B, column k taking head k // (K / H)."""
    if data is None or data.dim() == 1:
        return _contrib(indices, data, B)
    acc = _acc_dtype(B.dtype)
    v = data.to(acc).repeat_interleave(B.shape[1] // data.shape[1], dim=1)
    return B.index_select(0, indices.long()).to(acc) * v


def halo_spmm_rows(d_rows: Tensor, d_indices: Tensor, d_vals: Optional[Tensor],
                   B_d: Tensor, h_rows: Optional[Tensor],
                   h_indices: Optional[Tensor], h_vals: Optional[Tensor],
                   B_h: Optional[Tensor], m: int, reduce: str = "sum"):
    """(out, ties): the plain version of the joint diag+halo kernel (row 7).

    The contributions of the diag edges (over ``B_d``) and of the halo
    edges (over ``B_h``; ``h_rows=None`` leaves that block out) form one
    stream, reduced by row: a sum, or a max/min with the count of the edges
    of both blocks that achieve it (f32; None for sum).  Values are None,
    (nnz,) or per-head (nnz, H).  Accumulates in f32 (f64 for f64 tables);
    ``out`` takes B_d's dtype; rows without an edge give 0 and 0.
    """
    rows, contrib = d_rows, _head_contrib(d_indices, d_vals, B_d)
    if h_rows is not None:
        rows = torch.cat([rows, h_rows])
        contrib = torch.cat([contrib, _head_contrib(h_indices, h_vals, B_h)])
    if reduce == "sum":
        out = torch.zeros((m, B_d.shape[1]), dtype=contrib.dtype,
                          device=B_d.device)
        return out.index_add_(0, rows.long(), contrib).to(B_d.dtype), None
    best = _minmax_rows(rows, contrib, m, reduce)
    hit = (contrib == best.index_select(0, rows.long())).to(torch.float32)
    ties = torch.zeros((m, B_d.shape[1]), dtype=torch.float32, device=B_d.device)
    ties.index_add_(0, rows.long(), hit)
    return best.to(B_d.dtype), ties


def _stacked_edges(indptr: Tensor, indices: Tensor, vals: Optional[Tensor],
                   table: Tensor):
    """(stacked row, position in its block row, contribution) of every edge
    of an (n, m + 1)-stacked block over a table of n equal shard slabs."""
    n, m = indptr.shape[0], indptr.shape[1] - 1
    dev, stride = indptr.device, indices.shape[1]
    ptr = indptr.long()
    e = torch.arange(stride, device=dev).expand(n, stride)
    valid = e < ptr[:, -1:]
    r = torch.clamp(torch.searchsorted(ptr, e.contiguous(), right=True) - 1,
                    max=m - 1)
    shard = torch.arange(n, device=dev)[:, None]
    K = table.shape[-1]
    tab = table.reshape(-1, K)
    cols = (indices.long() + shard * (tab.shape[0] // n))[valid]
    contrib = _head_contrib(cols, None if vals is None else vals[valid], tab)
    return ((shard * m + r)[valid], (e - ptr.gather(1, r))[valid], contrib)


def halo_spmm_split_rows(d_indptr: Tensor, d_indices: Tensor,
                         d_vals: Optional[Tensor], B_d: Tensor,
                         h_indptr: Optional[Tensor],
                         h_indices: Optional[Tensor], h_vals: Optional[Tensor],
                         B_h: Optional[Tensor], reduce: str, seg_row: Tensor,
                         long_rows: Tensor, seg_ptr: Tensor, seg_len: int,
                         row0: int = 0, slot0: int = 0):
    """(out, ties): the plain version of the stacked, split joint kernel.

    n shards' blocks stacked as ``halo_spmm.cu`` takes them: indptrs
    (n, m + 1), indices and values (n, stride[, H]), tables of n equal
    slabs ((n * rows, K) or (n, rows, K)); shard i's row r is out row
    i * m + r.  A row's joint edge list is its diag edges, then its halo
    edges (``h_indptr=None`` leaves that block out).  A row of at most
    ``seg_len`` joint edges is reduced as in ``halo_spmm_rows``; a longer
    one (``long_rows``, stacked rows from ``row0``) is cut into segments of
    ``seg_len`` joint positions (``seg_row``, slots ``seg_ptr`` from
    ``slot0``: ``sparse/partition.py::build_shard_split``), each reduced
    apart (sum; or max/min with its count), then carried in segment order:
    the sums added, or the (extremum, count) pairs folded, a better
    extremum replacing the pair and an equal one adding its count.  f32
    accumulation (f64 for f64 tables); ``out`` in B_d's dtype, ``ties`` f32
    (None for sum); rows without an edge give 0 and 0.
    """
    n, m = d_indptr.shape[0], d_indptr.shape[1] - 1
    M, K, dev, S = n * m, B_d.shape[1], B_d.device, seg_row.shape[0]
    rows, pos, contrib = _stacked_edges(d_indptr, d_indices, d_vals, B_d)
    deg = (d_indptr[:, 1:] - d_indptr[:, :-1]).reshape(-1).long()
    if h_indptr is not None:
        h_rows, h_pos, h_contrib = _stacked_edges(h_indptr, h_indices, h_vals,
                                                  B_h)
        rows = torch.cat([rows, h_rows])
        pos = torch.cat([pos, deg.index_select(0, h_rows) + h_pos])
        contrib = torch.cat([contrib, h_contrib])
    lr = long_rows.long() - row0
    is_long = torch.zeros(M, dtype=torch.bool, device=dev).index_fill_(0, lr,
                                                                       True)
    first_seg = torch.zeros(M, dtype=torch.long, device=dev).index_copy_(
        0, lr, seg_ptr[:-1].long() - slot0)
    seg = first_seg.index_select(0, rows) + torch.div(pos, seg_len,
                                                      rounding_mode="floor")
    # Rows 0..M-1 of the buffers take the short rows' edges, rows M.. the
    # segments'; a long row's own row stays empty until the carry.
    target = torch.where(is_long.index_select(0, rows), M + seg, rows)
    srow = seg_row.long() - row0
    if reduce == "sum":
        buf = torch.zeros((M + S, K), dtype=contrib.dtype, device=dev)
        buf.index_add_(0, target, contrib)
        return buf[:M].index_add_(0, srow, buf[M:]).to(B_d.dtype), None
    out, ties = _split_minmax(target, contrib, M, srow, is_long, reduce)
    return out.to(B_d.dtype), ties


def _split_minmax(target: Tensor, contrib: Tensor, M: int, srow: Tensor,
                  is_long: Tensor, reduce: str):
    """(extremum, ties) of M rows of a split walk: edge e's contribution
    goes to unit ``target[e]``, its row, or M + its segment for a long row
    (``is_long``; segment s belongs to row ``srow[s]``).  Each unit is
    reduced to an (extremum, count) pair, and a long row's pairs are folded
    in segment order (the pair carry): a better extremum replaces the pair,
    an equal one adds its count.  Rows without an edge give 0 and 0."""
    S, K = srow.shape[0], contrib.shape[1]
    best = _minmax_rows(target, contrib, M + S, reduce)
    hit = (contrib == best.index_select(0, target)).to(torch.float32)
    count = torch.zeros((M + S, K), dtype=torch.float32, device=contrib.device)
    count.index_add_(0, target, hit)
    # The pair carry: the extremum over a row's segments, and the counts of
    # the segments that reach it.
    joint = _minmax_rows(srow, best[M:], M, reduce)
    reach = (best[M:] == joint.index_select(0, srow)).to(torch.float32)
    ties = torch.zeros((M, K), dtype=torch.float32, device=contrib.device)
    ties.index_add_(0, srow, reach * count[M:])
    long_col = is_long[:, None]
    return (torch.where(long_col, joint, best[:M]),
            torch.where(long_col, ties, count[:M]))


def split_units(rows: Tensor, indptr: Tensor, m: int, long_rows: Tensor,
                seg_ptr: Tensor, seg_len: int):
    """(unit, pos) per edge of a split walk: the unit is the edge's row for
    rows of at most ``seg_len`` edges and m + its segment for longer rows
    (the split of ``sparse/partition.py::build_row_split``: ``long_rows``,
    ``seg_ptr``), pos its place in the unit's walk."""
    dev, nnz = rows.device, rows.shape[0]
    r = rows.long()
    lr = long_rows.long()
    is_long = torch.zeros(m, dtype=torch.bool, device=dev).index_fill_(0, lr,
                                                                       True)
    first_seg = torch.zeros(m, dtype=torch.long, device=dev).index_copy_(
        0, lr, seg_ptr[:-1].long())
    offset = torch.arange(nnz, device=dev) - indptr.long().index_select(0, r)
    long_e = is_long.index_select(0, r)
    seg = first_seg.index_select(0, r) + torch.div(offset, seg_len,
                                                   rounding_mode="floor")
    return (torch.where(long_e, m + seg, r),
            torch.where(long_e, offset % seg_len, offset))


def spmm_split_rows(rows: Tensor, indptr: Tensor, indices: Tensor,
                    data: Optional[Tensor], B: Tensor, m: int,
                    seg_row: Tensor, long_rows: Tensor, seg_ptr: Tensor,
                    seg_len: int) -> Tensor:
    """The plain version of the split CSR kernel: the rows of at most
    ``seg_len`` edges summed as in ``spmm_rows``; each longer row's
    segments of ``seg_len`` consecutive edges summed apart (the split of
    ``sparse/partition.py::build_row_split``: ``seg_row``, ``long_rows``,
    ``seg_ptr``), then added into the row in segment order.  f32
    accumulation (f64 for f64 inputs); B's dtype out.
    """
    contrib = _contrib(indices, data, B)
    # One buffer: rows 0..m-1 take the short rows' edges, rows m.. the
    # segments'; a long row's own buffer row stays 0 and then takes its
    # segments in order.
    target, _ = split_units(rows, indptr, m, long_rows, seg_ptr, seg_len)
    buf = torch.zeros((m + seg_row.shape[0], B.shape[1]), dtype=contrib.dtype,
                      device=B.device)
    buf.index_add_(0, target, contrib)
    out = buf[:m].index_add_(0, seg_row.long(), buf[m:])
    return out.to(B.dtype)


def spmm_minmax_split_rows(rows: Tensor, indptr: Tensor, indices: Tensor,
                           data: Optional[Tensor], B: Tensor, m: int,
                           reduce: str, seg_row: Tensor, long_rows: Tensor,
                           seg_ptr: Tensor, seg_len: int):
    """(out, ties): the plain version of the split max/min forward kernel.

    The rows of at most ``seg_len`` edges reduced as in
    ``spmm_minmax_rows``; each longer row's segments of ``seg_len``
    consecutive edges (the split of ``sparse/partition.py::
    build_row_split``: ``seg_row``, ``long_rows``, ``seg_ptr``) reduced
    apart to an (extremum, count) pair, then the pairs folded in segment
    order: a better extremum replaces the pair, an equal one adds its
    count.  That is the unsplit walk's out and ties exactly.  f32
    contributions (f64 for f64 inputs); ``out`` in B's dtype, ``ties`` f32;
    empty rows give 0 and 0.
    """
    contrib = _contrib(indices, data, B)
    target, _ = split_units(rows, indptr, m, long_rows, seg_ptr, seg_len)
    is_long = torch.zeros(m, dtype=torch.bool, device=B.device).index_fill_(
        0, long_rows.long(), True)
    out, ties = _split_minmax(target, contrib, m, seg_row.long(), is_long,
                              reduce)
    return out.to(B.dtype), ties


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


# The split walks of the fused kernels (csrc/gat_fused.cu), in plain PyTorch:
# each row (column) of at most seg_len edges is one unit, each segment of a
# longer one another; a unit's state is merged into its row in segment order,
# as the carry passes merge them.  The forward takes a unit's edges in batches
# of ``batch`` (the kernel's walker width) with an online softmax.  Nothing on
# the card's path calls these: they let the CPU check the carry math.


def _unit_rows(m: int, seg_row: Tensor) -> Tensor:
    """The row (column) of every unit: the rows, then each segment's."""
    return torch.cat([torch.arange(m, device=seg_row.device), seg_row.long()])


def gat_split_rows(rows: Tensor, indptr: Tensor, cols: Tensor, src2: Tensor,
                   dst2: Tensor, B: Tensor, m: int, seg_row: Tensor,
                   long_rows: Tensor, seg_ptr: Tensor, seg_len: int,
                   slope: float = 0.2, max_mode: str = "exact",
                   heads: int = 1, batch: int = 32):
    """(out, mx, den) of the forward walk over the row split.

    A unit's batch b shifts its z by the running maximum M_b of batches
    0..b and scales them by exp(M_b − m_u) to the unit's maximum m_u (the
    kernel's rescale), so z = exp(max(l − M_b, EXP_FLOOR))·exp(M_b − m_u).
    A long row takes M = max of its segments' m_u, den = Σ zsum_u·e^(m_u−M)
    and out likewise.  "bound": the shift of ``gat_bound_shift`` for every
    unit, no rescale.  Dtypes as ``gat_fused_rows``.
    """
    acc = _gat_acc(src2, dst2, B)
    s, d = src2.to(acc), dst2.to(acc)
    l = leaky(s.index_select(0, rows.long()) + d.index_select(0, cols.long()),
              slope)
    shift = (gat_bound_shift(s, d, slope).index_select(0, _unit_rows(m, seg_row))
             if max_mode == "bound" else None)
    return _split_softmax(rows, indptr, cols, l, B, m, seg_row, long_rows,
                          seg_ptr, seg_len, batch, shift)


def _split_softmax(rows, indptr, cols, l, B, m, seg_row, long_rows, seg_ptr,
                   seg_len, batch, shift=None):
    """(out, mx, den) of an online-softmax walk over the row split, from the
    (nnz, H) logits ``l`` in the accumulation dtype (``gat_split_rows``;
    ``shift``: the bound mode's per-unit shift, no rescale)."""
    acc, H = l.dtype, l.shape[1]
    nnz, K = cols.shape[0], B.shape[1]
    dh = K // H
    S = seg_row.shape[0]
    unit, pos = split_units(rows, indptr, m, long_rows, seg_ptr, seg_len)
    inf = torch.full((), float("inf"), dtype=acc, device=B.device)
    if shift is not None:
        m_unit = shift
        z = torch.exp(torch.clamp(l - m_unit.index_select(0, unit),
                                  min=EXP_FLOOR))
    else:
        b = torch.div(pos, batch, rounding_mode="floor")
        nb = int(b.max()) + 1 if nnz else 1
        run = torch.full((m + S, nb, H), -inf, dtype=acc, device=B.device)
        run.view(-1, H).scatter_reduce_(0, (unit * nb + b)[:, None].expand_as(l),
                                        l, "amax")
        run = torch.cummax(run, dim=1).values
        m_unit = run[:, -1]
        m_b = run[unit, b]
        z = (torch.exp(torch.clamp(l - m_b, min=EXP_FLOOR))
             * torch.exp(m_b - m_unit.index_select(0, unit)))
    zsum = torch.zeros((m + S, H), dtype=acc, device=B.device).index_add_(
        0, unit, z)
    gb = B.index_select(0, cols.long()).to(acc).view(nnz, H, dh)
    part = torch.zeros((m + S, H, dh), dtype=acc, device=B.device).index_add_(
        0, unit, gb * z[:, :, None])
    # The carry: a long row's own unit is empty; its segments merge into it.
    sr = seg_row.long()
    M = m_unit[:m].clone()
    if shift is None:
        M.scatter_reduce_(0, sr[:, None].expand(S, H), m_unit[m:], "amax")
    f = torch.exp(m_unit[m:] - M.index_select(0, sr))
    den = zsum[:m].index_add_(0, sr, zsum[m:] * f)
    out = part[:m].index_add_(0, sr, part[m:] * f[:, :, None])
    den = torch.clamp(den, min=DENOM_EPS)
    out = (out / den[:, :, None]).view(m, K)
    mx = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    return out.to(B.dtype), mx, den


def _unit_sums(unit: Tensor, units: int, vals: Tensor, m: int,
               seg_row: Tensor) -> Tensor:
    """Each unit's sum of its edges' (nnz, ...) ``vals``, the segments'
    sums then added into their rows in segment order (the sum carry)."""
    part = torch.zeros((units, *vals.shape[1:]), dtype=vals.dtype,
                       device=vals.device).index_add_(0, unit, vals)
    return part[:m].index_add_(0, seg_row.long(), part[m:])


def _gat_w(rows, cols, src2, dst2, mx, den, slope, acc):
    """(alpha, w = alpha·leaky'(pre)) per (edge, head) in ``acc``."""
    pre, z = _gat_edge_terms(rows, cols, src2.to(acc), dst2.to(acc),
                             mx.to(acc), slope)
    alpha = z / torch.clamp(den.to(acc), min=DENOM_EPS).index_select(
        0, rows.long())
    return alpha, alpha * dleaky(pre, slope)


def gat_split_vjp_rows(rows, indptr, cols, src2, dst2, B, g, mx, den, s_row,
                       m, seg_row, long_rows, seg_ptr, seg_len, slope=0.2,
                       heads=1) -> Tensor:
    """grad_src (m, H) of the backward walk over the row split, in the
    linear form: a unit's Σ_{k in h} g[r, k]·(Σ_e w_e B[c_e, k]) −
    s[r, h]·Σ_e w_e, the segments' partials added into their row."""
    acc = _gat_acc(src2, dst2, B, g)
    H, nnz, K = heads, cols.shape[0], B.shape[1]
    dh = K // H
    S = seg_row.shape[0]
    _, w = _gat_w(rows, cols, src2, dst2, mx, den, slope, acc)
    unit, _ = split_units(rows, indptr, m, long_rows, seg_ptr, seg_len)
    gb = B.index_select(0, cols.long()).to(acc).view(nnz, H, dh)
    part = torch.zeros((m + S, H, dh), dtype=acc, device=B.device).index_add_(
        0, unit, gb * w[:, :, None])
    wsum = torch.zeros((m + S, H), dtype=acc, device=B.device).index_add_(
        0, unit, w)
    ur = _unit_rows(m, seg_row)
    part = ((g.to(acc).index_select(0, ur).view(m + S, H, dh) * part).sum(-1)
            - s_row.to(acc).index_select(0, ur) * wsum)
    return part[:m].index_add_(0, seg_row.long(), part[m:])


def gat_split_vjp_cols(rows_t, colptr, cols_t, src2, dst2, B, g, mx, den,
                       s_row, seg_row, long_rows, seg_ptr, seg_len, slope=0.2,
                       heads=1):
    """(grad_dst (n, H), grad_B (n, K)) of the backward walk over the column
    split, in CSC order (``rows_t`` the row of each edge, ``cols_t`` the
    expanded colptr): a unit's grad_B = Σ_e alpha_e g[r_e] and grad_dst =
    Σ_{k in h} B[c, k]·(Σ_e w_e g[r_e, k]) − Σ_e w_e s[r_e, h], the
    segments' partials added into their column."""
    acc = _gat_acc(src2, dst2, B, g)
    H, nnz, (n, K) = heads, rows_t.shape[0], B.shape
    dh = K // H
    S = seg_row.shape[0]
    alpha, w = _gat_w(rows_t, cols_t, src2, dst2, mx, den, slope, acc)
    unit, _ = split_units(cols_t, colptr, n, long_rows, seg_ptr, seg_len)
    r = rows_t.long()
    gr = g.to(acc).index_select(0, r).view(nnz, H, dh)
    part_B = torch.zeros((n + S, H, dh), dtype=acc, device=B.device).index_add_(
        0, unit, gr * alpha[:, :, None])
    part_D = torch.zeros((n + S, H, dh), dtype=acc, device=B.device).index_add_(
        0, unit, gr * w[:, :, None])
    sw = torch.zeros((n + S, H), dtype=acc, device=B.device).index_add_(
        0, unit, w * s_row.to(acc).index_select(0, r))
    uc = _unit_rows(n, seg_row)
    part_D = (B.to(acc).index_select(0, uc).view(n + S, H, dh) * part_D).sum(-1) - sw
    sr = seg_row.long()
    grad_dst = part_D[:n].index_add_(0, sr, part_D[n:])
    grad_B = part_B[:n].index_add_(0, sr, part_B[n:]).view(n, K)
    return grad_dst, grad_B


# --- fused dot-product attention (kernel row 6) ----------------------------
#
# The math of gespmm_tpu/kernels/gat_fused.py::_dot_forward / _dot_bwd, term
# by term, with act = identity (slope None) or leaky(·, slope), per head h of
# H (D1, D2 and B in head blocks; H = 1 is the JAX package's one head), a
# scale sc (1 where None) and an edge factor m~ (1/keep_prob where the
# (nnz, H) mask keeps the (edge, head), 0 where it drops it; 1 without one):
#   pre_e = sc·<D1[r], D2[c]>_h,  l_e = act(pre_e),  mx[r] = max_{e in row r}
#   l_e (0 for an empty row),  z_e = exp(max(l_e − mx[r], EXP_FLOOR)),
#   den[r] = max(Σ z_e, DENOM_EPS),  out[r]_h = Σ z_e·m~_e·B[c]_h / den[r];
#   alpha_e = z_e / den[r],  u_e = <g[r], B[c]>_h,  s[r] = <g[r], out[r]>_h,
#   dpre_e = alpha_e·(m~_e·u_e − s[r])·act'(pre_e); the dot's gradient is
#   sc·dpre_e, and grad_B's weight alpha_e·m~_e.
# Per-edge values are (nnz,) and row tables (m,) at one head, else (nnz, H)
# and (m, H).


def _act(x: Tensor, slope: Optional[float]) -> Tensor:
    return x if slope is None else leaky(x, slope)


def _dact(x: Tensor, slope: Optional[float]) -> Tensor:
    return torch.ones_like(x) if slope is None else dleaky(x, slope)


def _head_sums(prod: Tensor, heads: int) -> Tensor:
    """Each row of ``prod`` summed over its columns (heads = 1, (nnz,)) or
    over each head block of them ((nnz, H))."""
    if heads == 1:
        return prod.sum(-1)
    return prod.view(prod.shape[0], heads, -1).sum(-1)


def _dot_pre(rows: Tensor, cols: Tensor, D1: Tensor, D2: Tensor,
             acc: torch.dtype, heads: int = 1,
             scale: Optional[float] = None) -> Tensor:
    """pre_e = sc·<D1[rows[e]], D2[cols[e]]>_h in ``acc``."""
    pre = _head_sums(D1.to(acc).index_select(0, rows.long())
                     * D2.to(acc).index_select(0, cols.long()), heads)
    return pre if scale is None else pre * scale


def _keep_factor(keep: Tensor, keep_prob: float, acc: torch.dtype) -> Tensor:
    """m~ (nnz, H): 1/keep_prob where ``keep`` holds, else 0, in ``acc``."""
    return keep.to(acc) * (1.0 / keep_prob)


def _by_head(vals: Tensor, table: Tensor, heads: int) -> Tensor:
    """(nnz, H, width/H) view of ``table`` rows scaled by ``vals`` ((nnz,)
    or (nnz, H)) per head, flattened back to (nnz, width)."""
    nnz, width = table.shape
    return (table.view(nnz, heads, width // heads)
            * vals.view(nnz, heads, 1)).view(nnz, width)


def dot_attention_rows(rows: Tensor, cols: Tensor, D1: Tensor, D2: Tensor,
                       B: Tensor, m: int, slope: Optional[float] = None, *,
                       heads: int = 1, scale: Optional[float] = None,
                       keep: Optional[Tensor] = None,
                       keep_prob: Optional[float] = None):
    """(out, mx, den): the plain version of the dot-attention forward kernels.

    D1 (m, Ka), D2 (n, Ka), B (n, K), in ``heads`` head blocks.  ``out``
    (m, K) takes B's dtype; ``mx`` and ``den`` ((m,) at one head, else
    (m, H)) stay in the accumulation dtype (f32, or f64 for an f64 input).
    ``keep`` ((nnz, H) bool, in the edges' order) and ``keep_prob`` give the
    edge factor.  Empty rows give out 0, mx 0 and den DENOM_EPS.
    """
    acc = _gat_acc(D1, D2, B)
    H = heads
    l = _act(_dot_pre(rows, cols, D1, D2, acc, H, scale), slope).view(-1, H)
    mx = edge_segment_rows(rows, l, m, "max")
    r = rows.long()
    z = torch.exp(torch.clamp(l - mx.index_select(0, r), min=EXP_FLOOR))
    den = torch.zeros((m, H), dtype=acc, device=B.device).index_add_(0, r, z)
    den = torch.clamp(den, min=DENOM_EPS)
    if keep is not None:
        z = z * _keep_factor(keep, keep_prob, acc).view(-1, H)
    K = B.shape[1]
    out = torch.zeros((m, K), dtype=acc, device=B.device)
    out.index_add_(0, r, _by_head(z, B.index_select(0, cols.long()).to(acc),
                                  H))
    out = (out.view(m, H, K // H) / den[:, :, None]).view(m, K)
    shape = (m,) if H == 1 else (m, H)
    return out.to(B.dtype), mx.view(shape), den.view(shape)


def dot_row_dot(g: Tensor, out: Tensor, heads: int = 1) -> Tensor:
    """s = <g_r, out_r> per head ((m,) at one head, else (m, H)), from the
    STORED ``out`` cast up, as ``_dot_bwd`` forms it (one torch op before
    the backward launches)."""
    acc = _gat_acc(g, out)
    return _head_sums(g.to(acc) * out.to(acc), heads)


def _dot_dpre(rows, cols, D1, D2, B, g, mx, den, s_row, slope, heads=1,
              scale=None, keep=None, keep_prob=None):
    """(alpha·m~, sc·dpre) per edge and head, in the accumulation dtype
    ((alpha, dpre) without a mask or a scale)."""
    acc = _gat_acc(D1, D2, B, g)
    r, c = rows.long(), cols.long()
    pre = _dot_pre(rows, cols, D1, D2, acc, heads, scale)
    alpha = (torch.exp(torch.clamp(_act(pre, slope) - mx.to(acc)[r],
                                   min=EXP_FLOOR))
             / torch.clamp(den.to(acc), min=DENOM_EPS)[r])
    u = _head_sums(g.to(acc).index_select(0, r)
                   * B.to(acc).index_select(0, c), heads)
    f = (None if keep is None
         else _keep_factor(keep, keep_prob, acc).view(pre.shape))
    if f is not None:
        u = f * u
    dpre = alpha * (u - s_row.to(acc)[r]) * _dact(pre, slope)
    if scale is not None:
        dpre = scale * dpre
    return (alpha if f is None else alpha * f), dpre


def dot_attention_vjp_rows(rows, cols, D1, D2, B, g, mx, den, s_row, m,
                           slope=None, *, heads=1, scale=None, keep=None,
                           keep_prob=None) -> Tensor:
    """grad_D1 (m, Ka) = Σ_{e in row r} sc·dpre_e·D2[c_e] per head: the
    plain version of the backward kernels over the CSR, in the
    accumulation dtype."""
    _, dpre = _dot_dpre(rows, cols, D1, D2, B, g, mx, den, s_row, slope,
                        heads, scale, keep, keep_prob)
    out = torch.zeros((m, D2.shape[1]), dtype=dpre.dtype, device=dpre.device)
    return out.index_add_(0, rows.long(), _by_head(
        dpre, D2.to(dpre.dtype).index_select(0, cols.long()), heads))


def dot_attention_vjp_cols(rows, cols, D1, D2, B, g, mx, den, s_row,
                           slope=None, *, heads=1, scale=None, keep=None,
                           keep_prob=None):
    """(grad_D2 (n, Ka), grad_B (n, K)): grad_D2[c] = Σ_{e in col c}
    sc·dpre_e·D1[r_e] and grad_B[c] = Σ_{e in col c} alpha_e·m~_e·g[r_e]
    per head, the plain version of the backward kernels over the CSC (the
    edges, and ``keep``, in any one order), in the accumulation dtype."""
    weight, dpre = _dot_dpre(rows, cols, D1, D2, B, g, mx, den, s_row, slope,
                             heads, scale, keep, keep_prob)
    r, c = rows.long(), cols.long()
    n = B.shape[0]
    grad_D2 = torch.zeros((n, D1.shape[1]), dtype=dpre.dtype,
                          device=dpre.device)
    grad_D2.index_add_(0, c, _by_head(
        dpre, D1.to(dpre.dtype).index_select(0, r), heads))
    grad_B = torch.zeros((n, B.shape[1]), dtype=dpre.dtype,
                         device=dpre.device)
    grad_B.index_add_(0, c, _by_head(
        weight, g.to(dpre.dtype).index_select(0, r), heads))
    return grad_D2, grad_B


# The split walks of the dot-attention kernels (csrc/dot_attention.cu) and
# of the edge segment reduce (csrc/edge_reduce.cu), in plain PyTorch, as the
# row-5 mirrors above: units (rows of at most seg_len edges, segments of
# longer ones), per-unit partial states, merges in segment order.  Nothing
# on the card's path calls these.


def dot_split_rows(rows: Tensor, indptr: Tensor, cols: Tensor, D1: Tensor,
                   D2: Tensor, B: Tensor, m: int, seg_row: Tensor,
                   long_rows: Tensor, seg_ptr: Tensor, seg_len: int,
                   slope: Optional[float] = None, batch: int = 32):
    """(out, mx, den) of the dot-attention forward walk over the row split:
    ``gat_split_rows``'s online softmax (a rescale per batch of ``batch``
    edges, the walker's SW) on the logits act(D1[r]·D2[c]).  Dtypes as
    ``dot_attention_rows``."""
    acc = _gat_acc(D1, D2, B)
    l = _act(_dot_pre(rows, cols, D1, D2, acc), slope)[:, None]
    out, mx, den = _split_softmax(rows, indptr, cols, l, B, m, seg_row,
                                  long_rows, seg_ptr, seg_len, batch)
    return out, mx[:, 0], den[:, 0]


def dot_split_vjp_rows(rows, indptr, cols, D1, D2, B, g, mx, den, s_row, m,
                       seg_row, long_rows, seg_ptr, seg_len,
                       slope=None) -> Tensor:
    """grad_D1 (m, Ka) of the backward walk over the row split: each unit's
    Σ_e dpre_e·D2[c_e], the segments' partials added into their rows."""
    _, dpre = _dot_dpre(rows, cols, D1, D2, B, g, mx, den, s_row, slope)
    unit, _ = split_units(rows, indptr, m, long_rows, seg_ptr, seg_len)
    contrib = D2.to(dpre.dtype).index_select(0, cols.long()) * dpre[:, None]
    return _unit_sums(unit, m + seg_row.shape[0], contrib, m, seg_row)


def dot_split_vjp_cols(rows_t, colptr, cols_t, D1, D2, B, g, mx, den, s_row,
                       seg_row, long_rows, seg_ptr, seg_len, slope=None):
    """(grad_D2 (n, Ka), grad_B (n, K)) of the backward walk over the
    column split, in CSC order (``rows_t`` the row of each edge, ``cols_t``
    the expanded colptr): each unit's Σ_e dpre_e·D1[r_e] and Σ_e
    alpha_e·g[r_e], the segments' partials added into their columns."""
    alpha, dpre = _dot_dpre(rows_t, cols_t, D1, D2, B, g, mx, den, s_row,
                            slope)
    n = B.shape[0]
    unit, _ = split_units(cols_t, colptr, n, long_rows, seg_ptr, seg_len)
    r, units = rows_t.long(), n + seg_row.shape[0]
    grad_D2 = _unit_sums(unit, units, D1.to(dpre.dtype).index_select(0, r)
                         * dpre[:, None], n, seg_row)
    grad_B = _unit_sums(unit, units, g.to(dpre.dtype).index_select(0, r)
                        * alpha[:, None], n, seg_row)
    return grad_D2, grad_B


def edge_segment_split(rows: Tensor, indptr: Tensor, vals: Tensor, m: int,
                       op: str, seg_row: Tensor, long_rows: Tensor,
                       seg_ptr: Tensor, seg_len: int) -> Tensor:
    """The split walk of the edge segment reduce: each unit's sum or max of
    its (nnz, K) values, then a long row's segment sums added in segment
    order (the sum carry) or their maximum taken (the max carry); a
    non-finite max becomes 0.  Dtypes as ``edge_segment_rows``."""
    if op not in SEGMENT_OPS:
        raise ValueError(f"op must be one of {SEGMENT_OPS}, got {op!r}")
    v = vals.to(_acc_dtype(vals.dtype))
    unit, _ = split_units(rows, indptr, m, long_rows, seg_ptr, seg_len)
    units = m + seg_row.shape[0]
    if op == "sum":
        out = _unit_sums(unit, units, v, m, seg_row)
    else:
        # Raw maxima (-inf for a long row's own, empty unit); the carry
        # folds the segments' into their rows.
        part = torch.full((units, v.shape[1]), float("-inf"), dtype=v.dtype,
                          device=v.device).scatter_reduce_(
            0, unit[:, None].expand_as(v), v, "amax")
        out = part[:m].clone()
        out.scatter_reduce_(0, seg_row.long()[:, None].expand_as(part[m:]),
                            part[m:], "amax")
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out.to(vals.dtype)


# --- the scatter and dense tiers, and the chunked sum (kernel row 8) --------

# The dense tier's guard: densifying A costs m·n·4 bytes
# (gespmm_tpu/ops/reference.py::DENSE_BYTES_LIMIT).
DENSE_BYTES_LIMIT = 4 << 30


def spmm_scatter(rows: Tensor, indices: Tensor, data: Optional[Tensor],
                 B: Tensor, m: int) -> Tensor:
    """Push-formulation SpMM, out[row_e] += val_e·B[col_e], as one
    ``index_add_`` (``spmm_scatter_xla``).  f32 accumulation; B's dtype out."""
    contrib = _contrib(indices, data, B)
    out = torch.zeros((m, B.shape[1]), dtype=contrib.dtype, device=B.device)
    return out.index_add_(0, rows.long(), contrib).to(B.dtype)


def spmm_dense(rows: Tensor, indices: Tensor, data: Optional[Tensor],
               B: Tensor, m: int) -> Tensor:
    """Densify-and-matmul SpMM (``spmm_dense_xla``): A built by one
    ``index_add_`` into its flat view at row·n + col (duplicate (row, col)
    pairs add up), then one full-f32 ``torch.matmul``.  Nothing waits for
    the device (``index_put_(accumulate=True)`` did, on the card).  Raises
    ValueError when A would exceed DENSE_BYTES_LIMIT."""
    n = B.shape[0]
    dense_bytes = m * n * 4
    if dense_bytes > DENSE_BYTES_LIMIT:
        raise ValueError(
            f"dense A would be {dense_bytes / 2**30:.1f} GiB "
            f"(> {DENSE_BYTES_LIMIT / 2**30:.0f} GiB guard): the dense tier is "
            "a small-graph crossover baseline, not a large-graph path; use "
            "method='tiled'")
    acc = _acc_dtype(B.dtype)
    vals = (torch.ones(indices.shape[0], dtype=acc, device=B.device)
            if data is None else data.to(acc))
    A = torch.zeros((m, n), dtype=acc, device=B.device)
    A.view(-1).index_add_(0, rows.long() * n + indices.long(), vals)
    return torch.matmul(A, B.to(acc)).to(B.dtype)


def spmm_chunks(chunk_start: Tensor, chunk_count: Tensor, indices: Tensor,
                data: Optional[Tensor], B: Tensor, rows: Tensor,
                m: int) -> Tensor:
    """The plain version of the chunked sum kernel: every chunk's partial
    sums per row, then the partials of each row added in chunk order.

    Chunk c holds the CSR edges [chunk_start[c], chunk_start[c] +
    chunk_count[c]); ``rows`` are the CSR's per-edge row ids.  The chunks
    cover each edge once, so the result is the SpMM, with each row's sum
    cut where the kernel cuts it.  f32 accumulation; B's dtype out.
    """
    nnz = indices.shape[0]
    r = rows.long()
    contrib = _contrib(indices, data, B)
    # A (chunk, row) pair starts at every chunk's first edge and every row
    # change; pairs are numbered in edge order, at most nnz of them (sized
    # without reading the count back, so that nothing waits for the device).
    # The chunks cover the edges in order, so a row's pairs come in chunk
    # order.
    new_pair = torch.zeros(nnz + 1, dtype=torch.long, device=B.device)
    new_pair.index_fill_(0, chunk_start.long(), 1)
    new_pair = new_pair[:nnz]
    new_pair[1:] |= (r[1:] != r[:-1]).long()
    pair = torch.cumsum(new_pair, 0) - 1
    partial = torch.zeros((nnz, B.shape[1]), dtype=contrib.dtype,
                          device=B.device).index_add_(0, pair, contrib)
    pair_row = torch.zeros(nnz, dtype=torch.long, device=B.device)
    pair_row.scatter_(0, pair, r)  # unused pairs: row 0, a zero partial
    out = torch.zeros((m, B.shape[1]), dtype=contrib.dtype, device=B.device)
    return out.index_add_(0, pair_row, partial).to(B.dtype)


def spmm_grouped_chunks(chunk_count: Tensor, groups: Tensor,
                        group_count: Tensor, slots: Tensor, group_rows: int,
                        data: Optional[Tensor], B: Tensor, rows: Tensor,
                        m: int) -> Tensor:
    """The plain version of the grouped sum kernel: it walks the grouped
    plan, not the CSR columns.

    Chunk c stages the B rows g·G + [0, G) of each of its groups g =
    ``groups[c, :group_count[c]]`` (zeros past row n and for the padding
    groups), its ``chunk_count[c]`` edges (the chunks tile the CSR edges in
    order) read staged row ``slots[e]`` of their chunk, and the products
    are summed by row (``rows``, the CSR's per-edge row ids) with one
    ``index_add_``.  f32 accumulation; B's dtype out.
    """
    n, K = B.shape
    acc = _acc_dtype(B.dtype)
    out = torch.zeros((m, K), dtype=acc, device=B.device)
    if slots.shape[0] == 0:
        return out.to(B.dtype)
    C, NG = groups.shape
    G = group_rows
    dev = B.device
    staged_rows = (groups.long()[:, :, None] * G
                   + torch.arange(G, device=dev)).reshape(C, NG * G)
    in_chunk = (torch.arange(NG, device=dev)[None, :]
                < group_count.long()[:, None]).repeat_interleave(G, dim=1)
    valid = (in_chunk & (staged_rows < n)).reshape(-1, 1)
    staged = B.index_select(0, staged_rows.reshape(-1).clamp(max=n - 1)).to(acc)
    staged = torch.where(valid, staged, torch.zeros((), dtype=acc, device=dev))
    # Sized on the host, so that nothing waits for the device.
    chunk_of_edge = torch.repeat_interleave(
        torch.arange(C, device=dev), chunk_count.long(),
        output_size=slots.shape[0])
    contrib = staged.index_select(0, chunk_of_edge * (NG * G) + slots.long())
    if data is not None:
        contrib = contrib * data.to(acc)[:, None]
    return out.index_add_(0, rows.long(), contrib).to(B.dtype)
