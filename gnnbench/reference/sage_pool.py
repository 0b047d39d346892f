"""GraphSAGE with the pooling aggregator (Hamilton et al. 2017, eq. 3) of a
configuration in plain PyTorch.

Layer i of widths d_i -> d_i+1, over the graph's edges e = (r, c):

    p    = relu(h @ W_pool + b_pool)                  (n, d_i)
    a[r] = max over the edges (r, c) of p[c]          per channel; 0 for a
                                                      row without an edge
    h    = h @ W_self + (a @ W_neigh + b_neigh)

with dropout before every layer, the input layer too, and ReLU between
layers, as the program's GraphSAGE does.  Float32 with TF32 off; ``mm`` is
every matrix product.

The max's gradient goes to every edge whose p[c] equals a[r], split evenly
among them: g[r] / #ties, as ``torch.scatter_reduce(reduce="amax",
include_self=False)`` routes it.  The per-edge rows p[c] are (nnz, d_i),
127 GB at ogbn-products' size and d_i = 256, so the aggregate takes the
edges in blocks that end on row boundaries: the forward takes each block's
maximum with ``scatter_reduce``; the backward gathers the block again,
counts each row's ties against the saved maximum (a row's edges lie in one
block) and adds each achieving edge's share into the gradient.  Nothing
here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from gnnbench.reference.common import EdgeGraph, dropout

Tensor = torch.Tensor

# Bytes of the gathered rows p[c] of one block of edges.
BLOCK_BYTES = 1 << 30


def param_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    if config["aggregator"] != "pool":
        raise ValueError(f"no reference for aggregator {config['aggregator']!r}")
    dims = config["dims"]
    shapes = {}
    for i in range(len(dims) - 1):
        shapes[f"layer_{i}.self.w"] = (dims[i], dims[i + 1])
        shapes[f"layer_{i}.neigh.w"] = (dims[i], dims[i + 1])
        shapes[f"layer_{i}.neigh.b"] = (dims[i + 1],)
        shapes[f"layer_{i}.pool.w"] = (dims[i], dims[i])
        shapes[f"layer_{i}.pool.b"] = (dims[i],)
    return shapes


def edge_blocks(graph: EdgeGraph, width: int) -> List[Tuple[int, int, int]]:
    """(r0, s, t): blocks of the edges [s, t), rows r0 on, in row order,
    each ending on a row boundary and holding at most ``BLOCK_BYTES`` of f32
    rows ``width`` wide; a longer row is a block alone.  The edge lists
    must be in row order (a CSR's)."""
    counts = graph.row_degree().cpu()
    indptr = torch.zeros(graph.n + 1, dtype=torch.int64)
    torch.cumsum(counts, 0, out=indptr[1:])
    edges = max(1, BLOCK_BYTES // (4 * max(1, width)))
    blocks, r0 = [], 0
    while r0 < graph.n:
        s = int(indptr[r0])
        r1 = int(torch.searchsorted(indptr, torch.tensor([s + edges]),
                                    right=True)) - 1
        r1 = min(graph.n, max(r1, r0 + 1))
        if int(indptr[r1]) > s:
            blocks.append((r0, s, int(indptr[r1])))
        r0 = r1
    return blocks


class _MaxAggregate(torch.autograd.Function):
    """a[r] = max over the edges (r, c) of p[c], 0 for a row without one;
    the gradient split evenly among the edges that achieve each a[r, k]."""

    @staticmethod
    def forward(ctx, p: Tensor, graph: EdgeGraph) -> Tensor:
        blocks = edge_blocks(graph, p.shape[1])
        a = torch.zeros((graph.n, p.shape[1]), dtype=p.dtype, device=p.device)
        for _, s, t in blocks:
            rows = graph.rows[s:t].long()
            src = p.index_select(0, graph.cols[s:t].long())
            a.scatter_reduce_(0, rows[:, None].expand_as(src), src, "amax",
                              include_self=False)
        ctx.graph, ctx.blocks = graph, blocks
        ctx.save_for_backward(p, a)
        return a

    @staticmethod
    def backward(ctx, g: Tensor):
        p, a = ctx.saved_tensors
        graph = ctx.graph
        grad = torch.zeros_like(p)
        for r0, s, t in ctx.blocks:
            local = graph.rows[s:t].long() - r0
            cols = graph.cols[s:t].long()
            r1 = r0 + int(local[-1]) + 1
            hit = p.index_select(0, cols) == a[r0:r1].index_select(0, local)
            ties = torch.zeros((r1 - r0, p.shape[1]), dtype=p.dtype,
                               device=p.device)
            ties.index_add_(0, local, hit.to(p.dtype))
            share = g[r0:r1] / torch.clamp(ties, min=1.0)
            grad.index_add_(0, cols, torch.where(
                hit, share.index_select(0, local),
                torch.zeros((), dtype=p.dtype, device=p.device)))
        return grad, None


def max_aggregate(graph: EdgeGraph, p: Tensor) -> Tensor:
    return _MaxAggregate.apply(p, graph)


def forward(config: dict, params, graph: EdgeGraph, x: torch.Tensor,
            gen: torch.Generator, mm) -> torch.Tensor:
    layers = len(config["dims"]) - 1
    h = x
    for i in range(layers):
        w = f"layer_{i}."
        h = dropout(h, config["dropout"], gen)
        p = torch.relu(mm(h, params[w + "pool.w"]) + params[w + "pool.b"])
        a = max_aggregate(graph, p)
        h = (mm(h, params[w + "self.w"])
             + (mm(a, params[w + "neigh.w"]) + params[w + "neigh.b"]))
        if i < layers - 1:
            h = torch.relu(h)
    return h
