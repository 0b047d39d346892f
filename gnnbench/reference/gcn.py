"""The GCN of a configuration in plain PyTorch.

Layer i: h = x @ W_i, scaled by D_in^-1/2, summed over the adjacency (with
the self-loops the graph holds), scaled by D_out^-1/2, plus b_i; ReLU and
dropout between layers.  Degrees are counted from the edge lists, zero
degrees taken as one.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gnnbench.reference.common import EdgeGraph, dropout, spmm


def param_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    dims = config["dims"]
    shapes = {}
    for i in range(len(dims) - 1):
        shapes[f"layer_{i}.w"] = (dims[i], dims[i + 1])
        shapes[f"layer_{i}.b"] = (dims[i + 1],)
    return shapes


def forward(config: dict, params, graph: EdgeGraph, x: torch.Tensor,
            gen: torch.Generator, mm) -> torch.Tensor:
    out_norm = torch.clamp(graph.row_degree().to(torch.float32), min=1.0) ** -0.5
    in_norm = torch.clamp(graph.col_degree().to(torch.float32), min=1.0) ** -0.5
    layers = len(config["dims"]) - 1
    h = x
    for i in range(layers):
        h = mm(h, params[f"layer_{i}.w"])
        h = h * in_norm[:, None]
        h = spmm(graph, h)
        h = h * out_norm[:, None]
        h = h + params[f"layer_{i}.b"]
        if i < layers - 1:
            h = dropout(torch.relu(h), config["dropout"], gen)
    return h
