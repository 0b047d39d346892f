"""Graph-level ops on the SpMM primitive — port of part of ``gespmm_tpu/ops/graph.py``.

Ported: degree normalisation, the symmetric-normalised GCN aggregation,
the GraphSAGE aggregates, self-loop insertion, the attention building
blocks ``edge_softmax``, ``additive_attention_logits`` and
``gat_attention``, whose per-row reductions run the edge segment-reduce
kernel (``kernels/edge_reduce.py``) on a CUDA tensor, and
``attention_aggregate``, the dot-product attention layer, which runs the
fused kernels of ``kernels/gat_fused.py::dot_attention_aggregate``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from gespmm_tpu_torch.kernels.edge_reduce import edge_segment_reduce
from gespmm_tpu_torch.kernels.gat_fused import dot_attention_aggregate
from gespmm_tpu_torch.ops import reference as ref
from gespmm_tpu_torch.ops.sddmm import sddmm
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.sparse.formats import CSR, in_degrees, out_degrees
from gespmm_tpu_torch.sparse.partition import RowSplit

Tensor = torch.Tensor

# The edge ops' methods: "auto"/"tiled" run the segment-reduce kernel on a
# CUDA tensor (its plain version on a CPU tensor), "xla" the plain version
# on any device.
EDGE_METHODS = ("auto", "tiled", "xla")


def degree_norm(adj, power: float = -0.5, eps: float = 0.0):
    """(out_norm, in_norm): per-node degree**power with 0-degree clamped to 1."""
    csr = adj.csr if isinstance(adj, Adjacency) else adj
    dout = torch.clamp(out_degrees(csr).to(torch.float32), min=1.0) + eps
    din = torch.clamp(in_degrees(csr).to(torch.float32), min=1.0) + eps
    return dout ** power, din ** power


def gcn_aggregate(adj: Adjacency, x: Tensor, *, out_norm: Optional[Tensor] = None,
                  in_norm: Optional[Tensor] = None, method: str = "auto") -> Tensor:
    """Symmetric-normalised GCN aggregation: D_out^-1/2 · A · D_in^-1/2 · x.

    Pre-scale by the source-side norm, SpMM, post-scale by the
    destination-side norm; pass precomputed norms to amortise them.
    """
    if out_norm is None or in_norm is None:
        o, i = degree_norm(adj)
        out_norm = o if out_norm is None else out_norm
        in_norm = i if in_norm is None else in_norm
    x = x * in_norm[:, None].to(x.dtype)
    agg = spmm(adj, x, reduce="sum", method=method)
    return agg * out_norm[:, None].to(agg.dtype)


def sage_aggregate(adj: Adjacency, x: Tensor, *, aggregator: str = "mean",
                   method: str = "auto") -> Tensor:
    """Neighbourhood aggregation for GraphSAGE.

    aggregator:
      "mean": mean of neighbour features (SpMM mean-reduce).
      "gcn":  symmetric-norm aggregation including self (caller adds loops).
      "pool": elementwise max of neighbour features (SpMM max-reduce) — the
              caller applies the pre-pool MLP, per SAGEConv semantics.
      "sum":  plain sum.
    """
    if aggregator == "mean":
        return spmm(adj, x, reduce="mean", method=method)
    if aggregator == "sum":
        return spmm(adj, x, reduce="sum", method=method)
    if aggregator == "pool":
        return spmm(adj, x, reduce="max", method=method)
    if aggregator == "gcn":
        return gcn_aggregate(adj, x, method=method)
    raise ValueError(f"unknown aggregator {aggregator!r}")


def _check_edge_method(method: str) -> None:
    if method not in EDGE_METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{EDGE_METHODS}")


def _segment(method: str, indptr: Tensor, rows: Tensor, vals: Tensor,
             op: str, split: Optional[RowSplit]) -> Tensor:
    """Per-row ``op`` of the (nnz, K) ``vals``, in the edge order of
    ``indptr``; ``rows`` is that ordering's expanded indptr and ``split``
    its row split (the kernel's work list)."""
    if method == "xla":
        return ref.edge_segment_rows(rows, vals, indptr.shape[0] - 1, op)
    return edge_segment_reduce(indptr, vals.contiguous(), op, rows=rows,
                               split=split)


class _EdgeSoftmax(torch.autograd.Function):
    """Row-wise softmax of (nnz, K) CSR-ordered edge values."""

    @staticmethod
    def forward(ctx, adj: Adjacency, method: str, logits2d: Tensor) -> Tensor:
        indptr, rows = adj.csr.indptr, adj.rows
        r = rows.long()
        mx = _segment(method, indptr, rows, logits2d, "max", adj.split)
        ex = torch.exp(logits2d - mx.index_select(0, r))
        den = _segment(method, indptr, rows, ex, "sum", adj.split)
        alpha = ex / torch.clamp(den.index_select(0, r), min=ref.DENOM_EPS)
        ctx.adj, ctx.method = adj, method
        ctx.save_for_backward(alpha)
        return alpha

    @staticmethod
    def backward(ctx, g: Tensor):
        # dl = alpha ⊙ (g − rowsum(alpha ⊙ g)[row]): one more row reduction.
        adj, method = ctx.adj, ctx.method
        (alpha,) = ctx.saved_tensors
        t = alpha * g
        s = _segment(method, adj.csr.indptr, adj.rows, t, "sum", adj.split)
        return None, None, t - alpha * s.index_select(0, adj.rows.long())


def edge_softmax(adj: Union[Adjacency, CSR], logits: Tensor, *,
                 method: str = "auto") -> Tensor:
    """Per-destination-row softmax over edge logits (attention precursor).

    logits: (nnz,) or (nnz, heads) in CSR order; softmax within each row,
    per head.  Differentiable.  The forward is two row reductions (max, then
    the normaliser) and the backward one.  ``method``: "auto" | "tiled"
    run them on the edge segment-reduce kernel for a CUDA tensor, "xla" on
    the plain version; it stands in for the JAX package's test of whether
    the adjacency carries a plan, which the port does not build.
    """
    _check_edge_method(method)
    if isinstance(adj, CSR):
        adj = Adjacency.from_csr(adj)
    squeeze = logits.dim() == 1
    logits2d = logits[:, None] if squeeze else logits
    out = _EdgeSoftmax.apply(adj, method, logits2d)
    return out[:, 0] if squeeze else out


class _AdditiveLogits(torch.autograd.Function):
    """e = src[row_e] + dst[col_e]; the backward is a segment sum over the
    CSR (grad_src) and one over the CSC (grad_dst)."""

    @staticmethod
    def forward(ctx, adj: Adjacency, method: str, src_score: Tensor,
                dst_score: Tensor) -> Tensor:
        ctx.adj, ctx.method = adj, method
        return (src_score.index_select(0, adj.rows.long())
                + dst_score.index_select(0, adj.csr.indices.long()))

    @staticmethod
    def backward(ctx, g: Tensor):
        adj, method = ctx.adj, ctx.method
        g2 = g[:, None] if g.dim() == 1 else g
        gs = _segment(method, adj.csr.indptr, adj.rows, g2, "sum", adj.split)
        # The CSC's edge order: permute the cotangent.
        gd = _segment(method, adj.csc.indptr, adj.rows_t,
                      g2.index_select(0, adj.perm.long()), "sum", adj.split_t)
        if g.dim() == 1:
            gs, gd = gs[:, 0], gd[:, 0]
        return None, None, gs, gd


def additive_attention_logits(adj: Union[Adjacency, CSR], src_score: Tensor,
                              dst_score: Tensor, *,
                              method: str = "auto") -> Tensor:
    """Per-edge additive-attention logits: e = src[row_e] + dst[col_e].

    The GATv1 decomposition: two gathers forward, two per-node segment sums
    backward.  ``src_score``/``dst_score``: (m,) / (n,) or (m, H) / (n, H).
    ``method`` as for ``edge_softmax``.
    """
    _check_edge_method(method)
    if isinstance(adj, CSR):
        adj = Adjacency.from_csr(adj)
    return _AdditiveLogits.apply(adj, method, src_score, dst_score)


def gat_attention(adj: Union[Adjacency, CSR], q: Tensor, k: Tensor, *,
                  method: str = "auto") -> Tensor:
    """Edge attention scores softmax(SDDMM(q, k)) — composes the two
    primitives the way graph-attention layers do."""
    _check_edge_method(method)
    if isinstance(adj, CSR):
        adj = Adjacency.from_csr(adj)
    return edge_softmax(adj, sddmm(adj, q, k, method=method), method=method)


def attention_aggregate(adj: Union[Adjacency, CSR], q: Tensor, k: Tensor,
                        v: Tensor, *, negative_slope: Optional[float] = None,
                        method: str = "auto") -> Tensor:
    """out[r] = Σ_c softmax_c(act(q[r]·k[c])) · v[c] over the edge pattern —
    the whole dot-product attention layer (SDDMM scores, edge softmax,
    weighted aggregate) in one call.

    ``method``: "auto" | "tiled" run the fused op
    (``kernels/gat_fused.py::dot_attention_aggregate``: three kernels on a
    CUDA tensor, their plain versions on a CPU tensor); "xla" composes
    ``sddmm`` → leaky ReLU (when ``negative_slope`` is given) →
    ``edge_softmax`` → ``spmm(adj.with_data(alpha), v)``, each with
    ``method="xla"``.  ``act`` is the identity unless ``negative_slope`` is
    given.  Differentiable in q, k and v.
    """
    _check_edge_method(method)
    if isinstance(adj, CSR):
        adj = Adjacency.from_csr(adj)
    if method in ("auto", "tiled"):
        return dot_attention_aggregate(adj, q, k, v,
                                       negative_slope=negative_slope)
    scores = sddmm(adj, q, k, method=method)
    if negative_slope is not None:
        scores = torch.nn.functional.leaky_relu(scores, negative_slope)
    alpha = edge_softmax(adj, scores, method=method)
    return spmm(adj.with_data(alpha), v, reduce="sum", method=method)


def add_self_loops(csr: CSR, weight: float = 1.0) -> CSR:
    """Host-side A + weight·I (existing diagonal entries are replaced).

    The result always carries explicit values (1.0 for a binary input), so
    the SpMM downstream runs its valued path.  The tensors come back on the
    device ``csr`` lives on.
    """
    m, n = csr.shape
    if m != n:
        raise ValueError("self-loops need a square matrix")
    indptr = csr.indptr.cpu().numpy()
    indices = csr.indices.cpu().numpy()
    data = (np.ones(indices.shape[0], np.float32) if csr.data is None
            else csr.data.cpu().numpy())
    rows = np.repeat(np.arange(m), np.diff(indptr))
    keep = rows != indices
    rows = np.concatenate([rows[keep], np.arange(m)])
    cols = np.concatenate([indices[keep], np.arange(m)])
    vals = np.concatenate([data[keep], np.full(m, weight, data.dtype)])
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=m)
    new_indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return CSR(
        indptr=torch.from_numpy(new_indptr),
        indices=torch.from_numpy(cols.astype(np.int32)),
        data=torch.from_numpy(np.ascontiguousarray(vals)),
        shape=(m, n),
    ).to(csr.device)
