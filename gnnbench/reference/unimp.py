"""PyG's UniMP (``examples/unimp_arxiv.py``: ``TransformerConv`` layers
with gated root weights, LayerNorm and ReLU between them) of a
configuration in plain PyTorch.

Layer i of H heads of width dh (``dims[i + 1] // H`` in hidden layers,
``dims[-1]`` at the output), over the graph's edges e = (r, c), row r
attending over its row (no self-loops):

    q, k, v = h @ Wq + bq, h @ Wk + bk, h @ Wv + bv       (n, H·dh)
    l_e     = <q[r], k[c]>_head / sqrt(dh)                 per head
    alpha_e = exp(l_e - max_row l) / sum_row exp(l - max_row l)
    alpha_e = alpha_e / keep where the mask keeps (e, head), else 0
    m[r]    = sum_e alpha_e v[c]                           per head block
    hidden layers: the heads concatenated; the output layer: their mean
    x_r     = h @ Ws + bs
    beta    = sigmoid([m, x_r, m - x_r] @ w_beta)
    out     = beta x_r + (1 - beta) m
    hidden layers: LayerNorm (gain 1 + norm_i.w, bias norm_i.b), ReLU.

The attention mask of each layer is ``torch.rand((nnz, H), generator=gen)
< keep`` over the edges in CSR order, one draw a layer in layer order, as
the program draws it.  Float32 with TF32 off; ``mm`` is every matrix
product (the projections, the skip, the gate), each under
``torch.utils.checkpoint`` so that the TF32 control reaches it.

The row's maximum is taken by ``scatter_reduce(amax)`` without a gradient:
the softmax does not depend on its shift.  The rest is autograd's.  The
per-edge rows q[r], k[c] and v[c] are (nnz, H·dh), 32 GB each at
ogbn-products' size, so the edges go in blocks that end on row boundaries
(a row's softmax lies in one block), each block under
``torch.utils.checkpoint``, which keeps only the block's inputs and runs it
again in the backward.

UniMP's label embedding is not here: the benchmark's step gives the model
no labels (the configuration's ``assumed``).  Nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from gnnbench.reference.common import EdgeGraph

Tensor = torch.Tensor

# Bytes of the per-edge rows of one table in one block of edges.
BLOCK_BYTES = 1 << 31
LAYER_NORM_EPS = 1e-5


def _widths(config: dict) -> List[Tuple[int, int, int, bool]]:
    """(input width, dh, H·dh, last) of each layer."""
    dims, H = config["dims"], int(config["heads"])
    layers = len(dims) - 1
    out = []
    for i in range(layers):
        last = i == layers - 1
        dh = dims[i + 1] if last else dims[i + 1] // H
        out.append((dims[i], dh, H * dh, last))
    return out


def param_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    shapes = {}
    for i, (d_in, dh, width, last) in enumerate(_widths(config)):
        merged = dh if last else width
        for name in ("query", "key", "value"):
            shapes[f"layer_{i}.{name}.w"] = (d_in, width)
            shapes[f"layer_{i}.{name}.b"] = (width,)
        shapes[f"layer_{i}.skip.w"] = (d_in, merged)
        shapes[f"layer_{i}.skip.b"] = (merged,)
        shapes[f"layer_{i}.beta.w"] = (3 * merged, 1)
    for i, (_, _, width, last) in enumerate(_widths(config)):
        if not last:
            shapes[f"norm_{i}.w"] = (width,)
            shapes[f"norm_{i}.b"] = (width,)
    return shapes


def row_blocks(indptr: Tensor, width: int) -> List[Tuple[int, int]]:
    """Row ranges [r0, r1) of the CSR row pointer ``indptr`` (int64, on the
    host) whose edges hold at most ``BLOCK_BYTES`` of f32 rows ``width``
    wide; a longer row is a block alone."""
    n = indptr.shape[0] - 1
    edges = max(1, BLOCK_BYTES // (4 * max(1, width)))
    blocks, r0 = [], 0
    while r0 < n:
        target = torch.tensor([int(indptr[r0]) + edges])
        r1 = int(torch.searchsorted(indptr, target, right=True)) - 1
        r1 = min(n, max(r1, r0 + 1))
        blocks.append((r0, r1))
        r0 = r1
    return blocks


def _block(q: Tensor, k: Tensor, v: Tensor, keep: Optional[Tensor],
           rows: Tensor, cols: Tensor, r0: int, r1: int, heads: int,
           scale: float, keep_prob: float) -> Tensor:
    """Rows [r0, r1) of the attention's output, from their edges (``rows``
    local to r0, int64; ``keep`` the block's rows of the mask)."""
    n_rows, K = r1 - r0, v.shape[1]
    qe = q[r0:r1].index_select(0, rows).view(-1, heads, q.shape[1] // heads)
    ke = k.index_select(0, cols).view(-1, heads, k.shape[1] // heads)
    logit = (qe * ke).sum(-1) * scale
    with torch.no_grad():
        mx = torch.full((n_rows, heads), float("-inf"), dtype=logit.dtype,
                        device=logit.device)
        mx.scatter_reduce_(0, rows[:, None].expand(-1, heads), logit, "amax")
    e = torch.exp(logit - mx.index_select(0, rows))
    den = torch.zeros((n_rows, heads), dtype=e.dtype, device=e.device)
    den = den.index_add(0, rows, e)
    alpha = e / den.index_select(0, rows)
    if keep is not None:
        alpha = torch.where(keep, alpha / keep_prob,
                            torch.zeros((), dtype=alpha.dtype,
                                        device=alpha.device))
    msg = v.index_select(0, cols).view(-1, heads, K // heads) * alpha[:, :, None]
    out = torch.zeros((n_rows, K), dtype=v.dtype, device=v.device)
    return out.index_add(0, rows, msg.view(-1, K))


def _checkpoint(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: it keeps only its
    inputs for the backward and runs again there."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def attention(graph: EdgeGraph, q: Tensor, k: Tensor, v: Tensor, heads: int,
              scale: float, keep: Optional[Tensor] = None,
              keep_prob: float = 1.0) -> Tensor:
    """m[r] = sum_e dropout(softmax_row(<q[r], k[c]>_h · scale)) v[c] per
    head, (n, H·dh), a row-aligned block of edges at a time."""
    indptr = torch.zeros(graph.n + 1, dtype=torch.int64,
                         device=graph.rows.device)
    torch.cumsum(graph.row_degree(), 0, out=indptr[1:])
    indptr = indptr.cpu()
    parts = []
    for r0, r1 in row_blocks(indptr, max(q.shape[1], v.shape[1])):
        s, t = int(indptr[r0]), int(indptr[r1])
        rows = graph.rows[s:t].long() - r0
        cols = graph.cols[s:t].long()
        parts.append(_checkpoint(_block, q, k, v,
                                 None if keep is None else keep[s:t], rows,
                                 cols, r0, r1, heads, scale, keep_prob))
    return torch.cat(parts)


def _layer(config: dict, params, i: int, graph: EdgeGraph, h: Tensor,
           gen: torch.Generator, mm) -> Tensor:
    """Layer i from its input ``h``, up to the LayerNorm."""
    H = int(config["heads"])
    _, dh, _, last = _widths(config)[i]
    p = f"layer_{i}."
    q, k, v = (mm(h, params[p + name + ".w"]) + params[p + name + ".b"]
               for name in ("query", "key", "value"))
    keep, keep_prob = None, 1.0 - float(config["attn_dropout"])
    if keep_prob < 1.0:
        keep = torch.rand((graph.rows.shape[0], H), generator=gen,
                          device=h.device) < keep_prob
    m = attention(graph, q, k, v, H, 1.0 / math.sqrt(dh), keep, keep_prob)
    if last:
        m = m.view(-1, H, dh).mean(1)
    x_r = mm(h, params[p + "skip.w"]) + params[p + "skip.b"]
    beta = torch.sigmoid(mm(torch.cat([m, x_r, m - x_r], dim=-1),
                            params[p + "beta.w"]))
    return beta * x_r + (1.0 - beta) * m


def forward(config: dict, params, graph: EdgeGraph, x: torch.Tensor,
            gen: torch.Generator, mm) -> torch.Tensor:
    layers = len(config["dims"]) - 1

    def product(a: Tensor, b: Tensor) -> Tensor:
        # The TF32 control's products would keep rounded copies of their
        # operands through the forward.
        return _checkpoint(mm, a, b)

    h = x
    for i in range(layers):
        h = _layer(config, params, i, graph, h, gen, product)
        if i < layers - 1:
            h = torch.nn.functional.layer_norm(
                h, (h.shape[1],), 1.0 + params[f"norm_{i}.w"],
                params[f"norm_{i}.b"], LAYER_NORM_EPS)
            h = torch.relu(h)
    return h
