"""Graph-level ops on the SpMM primitive — port of part of ``gespmm_tpu/ops/graph.py``.

Ported: degree normalisation, the symmetric-normalised GCN aggregation,
the GraphSAGE aggregates, self-loop insertion, the attention building
blocks ``edge_softmax``, ``additive_attention_logits`` and
``gat_attention``, whose per-row reductions run the edge segment-reduce
kernel (``kernels/edge_reduce.py``) on a CUDA tensor, and the fused
attention ops of ``gespmm_tpu/kernels/gat_fused.py``:
``gat_attention_aggregate`` (GATv1, kernel row 5) and
``dot_attention_aggregate`` (dot-product attention, row 6), each an
autograd Function over the launches of ``kernels/gat_fused.py``, which run
the CUDA kernels on a CUDA tensor and their plain versions
(``ops/reference.py``) on a CPU tensor.  ``attention_aggregate``, the
dot-product attention layer, runs the fused op.

``dot_attention_aggregate`` takes heads (D1, D2 and B in head blocks, a
softmax a row and head), a scale of the dots and an edge factor (attention
dropout: a (nnz, H) mask whose kept weights are divided by the keep
probability after the softmax); its docstring gives the gradients.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from gespmm_tpu_torch.kernels.edge_reduce import edge_segment_reduce
from gespmm_tpu_torch.kernels.gat_fused import (dot_backward_cols,
                                                dot_backward_rows, dot_forward,
                                                gat_backward_cols,
                                                gat_backward_rows, gat_forward)
from gespmm_tpu_torch.ops import reference as ref
from gespmm_tpu_torch.ops.sddmm import sddmm
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.sparse.formats import CSR, in_degrees, out_degrees
from gespmm_tpu_torch.sparse.partition import RowSplit
from gespmm_tpu_torch.utils.profiling import span

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


class _GatFused(torch.autograd.Function):
    """The fused GAT op over ``adj``; differentiable in src2, dst2 and B."""

    @staticmethod
    def forward(ctx, adj: Adjacency, slope: float, max_mode: str, heads: int,
                src2: Tensor, dst2: Tensor, B: Tensor) -> Tensor:
        B = B.contiguous()
        out, mx, den = gat_forward(adj.csr.indptr, adj.csr.indices, src2, dst2,
                                   B, slope=slope, heads=heads,
                                   max_mode=max_mode, rows=adj.rows,
                                   split=adj.split)
        ctx.adj, ctx.slope, ctx.heads = adj, slope, heads
        ctx.save_for_backward(src2, dst2, B, out, mx, den)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        with span("op/gat.grad"):
            adj = ctx.adj
            src2, dst2, B, out, mx, den = ctx.saved_tensors
            g = g.contiguous()
            s_row = ref.gat_row_dot(g, out, ctx.heads)
            tables = (src2, dst2, B, g, mx, den, s_row)
            kw = dict(slope=ctx.slope, heads=ctx.heads)
            grad_src = grad_dst = grad_B = None
            if ctx.needs_input_grad[4]:
                grad_src = gat_backward_rows(adj.csr.indptr, adj.csr.indices,
                                             *tables, rows=adj.rows,
                                             split=adj.split, **kw)
            if ctx.needs_input_grad[5] or ctx.needs_input_grad[6]:
                grad_dst, grad_B = gat_backward_cols(
                    adj.csc.indptr, adj.csc.indices, *tables, cols=adj.rows_t,
                    split=adj.split_t, **kw)
            if grad_src is not None:
                grad_src = grad_src.to(src2.dtype)
            if grad_dst is not None:
                grad_dst = grad_dst.to(dst2.dtype)
                grad_B = grad_B.to(B.dtype)
            return None, None, None, None, grad_src, grad_dst, grad_B


def gat_attention_aggregate(adj: Union[Adjacency, CSR], src_score: Tensor,
                            dst_score: Tensor, B: Tensor, *,
                            negative_slope: float = 0.2,
                            max_mode: str = "exact", heads: int = 1) -> Tensor:
    """out[r] = Σ_c softmax_c(leaky(src[r]+dst[c])) · B[c] over the edge
    pattern — the whole GATv1 attention layer as one fused op.

    ``src_score``: (m,) or (m, H); ``dst_score``: (n,) or (n, H); ``B``:
    (n, H·dh) in head blocks (``heads`` = H); every head runs in the same
    kernel launch.  ``out`` takes B's dtype (f32 or bf16 on the card).
    Differentiable in all three tensors.  Rows without an edge give 0.

    ``adj``: an ``Adjacency``, or a bare ``CSR`` paired on the fly.  The
    JAX package needs tiled plans here; the port has none, and takes any.
    ``max_mode``: "exact" (the per-row max of the logits, one pass of the
    kernel) or "bound" (leaky(src[r] + max_c dst[c]) per head, computed
    before the launch; exact alphas while the dst scores span under ~80).
    The JAX package's ``mode`` is not taken: the kernels accumulate in f32,
    which meets every mode's tolerance.  The call runs under the span
    ``op/gat`` and its backward under ``op/gat.grad``
    (``utils/profiling.py``).
    """
    with span("op/gat"):
        if isinstance(adj, CSR):
            adj = Adjacency.from_csr(adj)
        m, n = adj.shape
        src2 = src_score[:, None] if src_score.dim() == 1 else src_score
        dst2 = dst_score[:, None] if dst_score.dim() == 1 else dst_score
        H = int(heads)
        if tuple(src2.shape) != (m, H) or tuple(dst2.shape) != (n, H):
            raise ValueError(
                f"score shapes {tuple(src_score.shape)}/"
                f"{tuple(dst_score.shape)} must be ({m}, {H})/({n}, {H}) for "
                f"heads={H} (1-D accepted when heads=1; single head means "
                f"heads=1)")
        if B.dim() != 2 or B.shape[0] != n or B.shape[1] % H:
            raise ValueError(f"B must be ({n}, {H}*dh), got {tuple(B.shape)}")
        return _GatFused.apply(adj, float(negative_slope), max_mode, H, src2,
                               dst2, B)


class _DotFused(torch.autograd.Function):
    """Fused dot-product attention over ``adj``; differentiable in D1, D2
    and B."""

    @staticmethod
    def forward(ctx, adj: Adjacency, slope: Optional[float], heads: int,
                scale: Optional[float], edge_keep: Optional[Tensor],
                keep_prob: Optional[float], D1: Tensor, D2: Tensor,
                B: Tensor) -> Tensor:
        B = B.contiguous()
        kw = dict(slope=slope, heads=heads, scale=scale, edge_keep=edge_keep,
                  keep_prob=keep_prob)
        out, mx, den = dot_forward(adj.csr.indptr, adj.csr.indices, D1, D2, B,
                                   rows=adj.rows, split=adj.split, **kw)
        ctx.adj, ctx.kw = adj, kw
        ctx.save_for_backward(D1, D2, B, out, mx, den)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        with span("op/dot.grad"):
            adj, kw = ctx.adj, ctx.kw
            D1, D2, B, out, mx, den = ctx.saved_tensors
            g = g.contiguous()
            s_row = ref.dot_row_dot(g, out, kw["heads"])
            tables = (D1, D2, B, g, mx, den, s_row)
            grad_D1 = grad_D2 = grad_B = None
            if ctx.needs_input_grad[6]:
                grad_D1 = dot_backward_rows(adj.csr.indptr, adj.csr.indices,
                                            *tables, rows=adj.rows,
                                            split=adj.split, **kw)
            if ctx.needs_input_grad[7] or ctx.needs_input_grad[8]:
                grad_D2, grad_B = dot_backward_cols(
                    adj.csc.indptr, adj.csc.indices, *tables,
                    perm=adj.perm, cols=adj.rows_t, split=adj.split_t, **kw)
            if grad_D1 is not None:
                grad_D1 = grad_D1.to(D1.dtype)
            if grad_D2 is not None:
                grad_D2 = grad_D2.to(D2.dtype)
                grad_B = grad_B.to(B.dtype)
            return (None,) * 6 + (grad_D1, grad_D2, grad_B)


def dot_attention_aggregate(adj: Union[Adjacency, CSR], D1: Tensor,
                            D2: Tensor, B: Tensor, *, heads: int = 1,
                            scale: Optional[float] = None,
                            edge_keep: Optional[Tensor] = None,
                            keep_prob: Optional[float] = None,
                            negative_slope: Optional[float] = None) -> Tensor:
    """out[r] = Σ_c softmax_c(act(sc·D1[r]·D2[c])) · m~ · B[c] over the edge
    pattern, per head — fused dot-product (transformer-style) graph
    attention.

    Heads: D1 (m, H·dk), D2 (n, H·dk) and B (n, H·dv) hold ``heads`` = H
    head blocks; head h's logits are the dots of D1's and D2's h-th blocks
    and weigh B's h-th block, and the heads' outputs lie side by side in
    ``out`` (m, H·dv) (a caller that averages them does so after).  One call
    runs every head: on the card each of its three kernels walks the edges
    once for all of them.  ``scale`` (sc, default 1) multiplies each dot
    before ``act``, the identity (default) or leaky ReLU when
    ``negative_slope`` is given.  ``edge_keep`` ((nnz, H) bool, in the CSR's
    edge order) is attention dropout: each softmax weight is multiplied by
    m~ = 1/``keep_prob`` where it is True and by 0 where it is False, after
    the softmax (its denominator sums every edge).

    Gradients (per head, with alpha the softmax, u_e = <g[r], B[c]>,
    s[r] = <g[r], out[r]>, taken from the stored out, which holds the
    dropped weights): dpre_e = alpha_e·(m~_e·u_e − s[r])·act'(pre_e);
    grad_D1[r] = Σ_e sc·dpre_e·D2[c], grad_D2[c] = Σ_e sc·dpre_e·D1[r],
    grad_B[c] = Σ_e alpha_e·m~_e·g[r].  ``out`` takes B's dtype (f32 or
    bf16 on the card); each gradient takes its input's dtype.  Rows without
    an edge give 0.  One head with no scale and no mask runs the
    single-head kernels, the JAX package's op.

    ``adj``: an ``Adjacency``, or a bare ``CSR`` paired on the fly.  The JAX
    package needs tiled plans here; the port walks the CSR and the CSC and
    needs none.  The call runs under the span ``op/dot`` and its backward
    under ``op/dot.grad`` (``utils/profiling.py``).
    """
    with span("op/dot"):
        if isinstance(adj, CSR):
            adj = Adjacency.from_csr(adj)
        m, n = adj.shape
        if D1.dim() != 2 or D2.dim() != 2 or D1.shape[1] != D2.shape[1]:
            raise ValueError(f"D1 {tuple(D1.shape)} / D2 {tuple(D2.shape)} "
                             "must be (m,Ka)/(n,Ka)")
        if D1.shape[0] != m or D2.shape[0] != n:
            raise ValueError(f"D1/D2 rows {D1.shape[0]}/{D2.shape[0]} must "
                             f"match the pattern {adj.shape}")
        if B.dim() != 2 or B.shape[0] != n:
            raise ValueError(f"B must be ({n}, K), got {tuple(B.shape)}")
        H = int(heads)
        if H < 1 or D1.shape[1] % H or B.shape[1] % H:
            raise ValueError(f"Ka={D1.shape[1]} and K={B.shape[1]} must be "
                             f"multiples of heads={heads}")
        if edge_keep is not None and keep_prob is None:
            raise ValueError("edge_keep needs keep_prob")
        slope = None if negative_slope is None else float(negative_slope)
        return _DotFused.apply(adj, slope, H,
                               None if scale is None else float(scale),
                               edge_keep,
                               None if keep_prob is None else float(keep_prob),
                               D1, D2, B)


def attention_aggregate(adj: Union[Adjacency, CSR], q: Tensor, k: Tensor,
                        v: Tensor, *, negative_slope: Optional[float] = None,
                        method: str = "auto") -> Tensor:
    """out[r] = Σ_c softmax_c(act(q[r]·k[c])) · v[c] over the edge pattern —
    the whole dot-product attention layer (SDDMM scores, edge softmax,
    weighted aggregate) in one call.

    ``method``: "auto" | "tiled" run the fused op
    (``dot_attention_aggregate``: three kernels on a CUDA tensor, their
    plain versions on a CPU tensor); "xla" composes
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
