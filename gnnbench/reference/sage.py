"""GraphSAGE-mean of a configuration in plain PyTorch.

Layer i: h = x @ W_self + (mean_agg(x) @ W_neigh + b), the mean over a
node's row of the adjacency (an empty row gives 0); dropout before every
layer, the input layer too, and ReLU between layers, as the program's
GraphSAGE does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gnnbench.reference.common import EdgeGraph, dropout, spmm


def param_shapes(config: dict) -> Dict[str, Tuple[int, ...]]:
    if config["aggregator"] != "mean":
        raise ValueError(f"no reference for aggregator {config['aggregator']!r}")
    dims = config["dims"]
    shapes = {}
    for i in range(len(dims) - 1):
        shapes[f"layer_{i}.self.w"] = (dims[i], dims[i + 1])
        shapes[f"layer_{i}.neigh.w"] = (dims[i], dims[i + 1])
        shapes[f"layer_{i}.neigh.b"] = (dims[i + 1],)
    return shapes


def forward(config: dict, params, graph: EdgeGraph, x: torch.Tensor,
            gen: torch.Generator, mm) -> torch.Tensor:
    deg = torch.clamp(graph.row_degree().to(torch.float32), min=1.0)
    layers = len(config["dims"]) - 1
    h = x
    for i in range(layers):
        h = dropout(h, config["dropout"], gen)
        agg = spmm(graph, h) / deg[:, None]
        h = (mm(h, params[f"layer_{i}.self.w"])
             + (mm(agg, params[f"layer_{i}.neigh.w"]) + params[f"layer_{i}.neigh.b"]))
        if i < layers - 1:
            h = torch.relu(h)
    return h
