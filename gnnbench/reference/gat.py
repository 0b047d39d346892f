"""PyG's ogbn-products GAT of a configuration in plain PyTorch.

Layer i of H heads of width dh (``dims[i + 1]``), over the graph's edges
e = (r, c), row r attending over its row (the self-loops the graph holds
included):

    z       = h @ W_i                                  (n, H·dh), head blocks
    s, t    = per head, z · a_src and z · a_dst        (n, H)
    l_e     = LeakyReLU(s[r] + t[c], slope)            per head
    alpha_e = exp(l_e - max_row l) / sum_row exp(l - max_row l)
    out[r]  = sum_e alpha_e z[c]                       per head block
    hidden layers: the heads concatenated, + b; the output layer: their
    mean, + b[:dh]; then + (h @ Ws_i + bs_i), the skip; ELU between layers.

Dropout (inverted, one draw a value) runs before every layer, the input
layer too, as the program's GAT does.  Float32 with TF32 off; ``mm`` is
every matrix product (the projections, the skips, and the scores, as one
product with the block-diagonal matrix of the head vectors), so that the
TF32 control reaches all of them.

The row's maximum is taken by ``scatter_reduce(amax)`` without a gradient:
the softmax does not depend on its shift.  The rest is autograd's: the
messages z[c] are (nnz, H·dh), 258 GB at K = 512 and ogbn-products' size,
so the edges go in blocks that end on row boundaries (a row's softmax
lies in one block), each block under ``torch.utils.checkpoint``, which
keeps only the block's inputs and runs it again in the backward.  Each
matrix product runs under a checkpoint too, for the TF32 control.

Departures from PyG's ``GATConv``, each also under the configuration's
``assumed``:

* the port's ``a_src`` is PyG's ``att_dst`` (the attending row's vector)
  and its ``a_dst`` PyG's ``att_src``;
* the output layer's bias leaf has H·dh entries, of which the first dh
  are added after the mean (PyG: a dh-wide bias), as the program keeps it;
* dropout also on the 100-wide input, before layer 0 (PyG: between
  layers only).

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.utils.checkpoint

from gnnbench.reference.common import EdgeGraph, dropout

Tensor = torch.Tensor

# Bytes of the messages of one block of edges.
BLOCK_BYTES = 1 << 31


def param_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    dims, H = config["dims"], int(config["heads"])
    if H < 2:
        raise ValueError("the GAT reference takes 2 heads or more")
    layers = len(dims) - 1
    ins = [dims[i] * (H if i > 0 else 1) for i in range(layers)]
    shapes = {}
    for i in range(layers):
        shapes[f"layer_{i}.w"] = (ins[i], H * dims[i + 1])
        shapes[f"layer_{i}.a_src"] = (H, dims[i + 1])
        shapes[f"layer_{i}.a_dst"] = (H, dims[i + 1])
        shapes[f"layer_{i}.b"] = (H * dims[i + 1],)
    if config["skip"]:
        for i in range(layers):
            width = dims[i + 1] * (1 if i == layers - 1 else H)
            shapes[f"skip_{i}.w"] = (ins[i], width)
            shapes[f"skip_{i}.b"] = (width,)
    return shapes


def row_blocks(indptr: Tensor, width: int) -> List[Tuple[int, int]]:
    """Row ranges [r0, r1) of the CSR row pointer ``indptr`` (int64, on the
    host) whose edges hold at most ``BLOCK_BYTES`` of f32 messages
    ``width`` wide; a longer row is a block alone."""
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


def _block(src: Tensor, dst: Tensor, z: Tensor, rows: Tensor, cols: Tensor,
           r0: int, r1: int, heads: int, slope: float) -> Tensor:
    """Rows [r0, r1) of the attention's output, from their edges (``rows``
    local to r0, int64)."""
    n_rows, K = r1 - r0, z.shape[1]
    logit = torch.nn.functional.leaky_relu(
        src[r0:r1].index_select(0, rows) + dst.index_select(0, cols), slope)
    with torch.no_grad():
        mx = torch.full((n_rows, heads), float("-inf"), dtype=logit.dtype,
                        device=logit.device)
        mx.scatter_reduce_(0, rows[:, None].expand(-1, heads), logit, "amax")
    e = torch.exp(logit - mx.index_select(0, rows))
    den = torch.zeros((n_rows, heads), dtype=e.dtype, device=e.device)
    den = den.index_add(0, rows, e)
    alpha = e / den.index_select(0, rows)
    msg = (z.index_select(0, cols).view(-1, heads, K // heads)
           * alpha[:, :, None])
    out = torch.zeros((n_rows, K), dtype=z.dtype, device=z.device)
    return out.index_add(0, rows, msg.view(-1, K))


def _checkpoint(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: it keeps only its
    inputs for the backward and runs again there."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def attention(graph: EdgeGraph, src: Tensor, dst: Tensor, z: Tensor,
              heads: int, slope: float) -> Tensor:
    """out[r] = sum_e softmax_row(leaky(src[r] + dst[c])) z[c] per head,
    (n, H·dh), a row-aligned block of edges at a time."""
    indptr = torch.zeros(graph.n + 1, dtype=torch.int64,
                         device=graph.rows.device)
    torch.cumsum(graph.row_degree(), 0, out=indptr[1:])
    indptr = indptr.cpu()
    parts = []
    for r0, r1 in row_blocks(indptr, z.shape[1]):
        s, t = int(indptr[r0]), int(indptr[r1])
        rows = graph.rows[s:t].long() - r0
        cols = graph.cols[s:t].long()
        parts.append(_checkpoint(_block, src, dst, z, rows, cols, r0, r1,
                                 heads, slope))
    return torch.cat(parts)


def _scores(z: Tensor, a_src: Tensor, a_dst: Tensor, mm):
    """Per head, z · a_src and z · a_dst: one product of z with the
    block-diagonal (H·dh, 2H) matrix of the head vectors."""
    heads = a_src.shape[0]
    a = torch.cat([torch.block_diag(*a_src.unbind(0)),
                   torch.block_diag(*a_dst.unbind(0))]).t()
    scores = mm(z, a)
    return scores[:, :heads], scores[:, heads:]


def _layer(config: dict, params, i: int, graph: EdgeGraph, h: Tensor,
           mm) -> Tensor:
    """Layer i from its dropped input ``h``, up to the ELU."""
    dims, H = config["dims"], int(config["heads"])
    p = f"layer_{i}."
    z = mm(h, params[p + "w"])
    src, dst = _scores(z, params[p + "a_src"], params[p + "a_dst"], mm)
    out = attention(graph, src, dst, z, H, float(config["negative_slope"]))
    if i == len(dims) - 2:
        dh = dims[i + 1]
        out = out.view(-1, H, dh).mean(1) + params[p + "b"][:dh]
    else:
        out = out + params[p + "b"]
    if config["skip"]:
        out = out + (mm(h, params[f"skip_{i}.w"]) + params[f"skip_{i}.b"])
    return out


def forward(config: dict, params, graph: EdgeGraph, x: torch.Tensor,
            gen: torch.Generator, mm) -> torch.Tensor:
    layers = len(config["dims"]) - 1

    def product(a: Tensor, b: Tensor) -> Tensor:
        # The TF32 control's products would keep rounded copies of their
        # operands through the forward.
        return _checkpoint(mm, a, b)

    h = x
    for i in range(layers):
        h = dropout(h, config["dropout"], gen)
        h = _layer(config, params, i, graph, h, product)
        if i < layers - 1:
            h = torch.nn.functional.elu(h)
    return h
