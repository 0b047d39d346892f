"""GraphSAGE (mean) through the program: ``Adjacency.from_csr`` and
``gespmm_tpu_torch.models.sage.GraphSAGE``, whose mean aggregate is the sum
SpMM divided by the row degree (``ops/graph.py::sage_aggregate``).

Work of one full-batch step, layer i of widths (d_i, d_i+1): two products
(self and neighbour) forward, their weights' gradients, and their inputs'
gradients except at layer 0; a sum SpMM at width d_i forward in every layer
and one backward (grad_B) in every layer but the first.
"""

from __future__ import annotations

from typing import List, Tuple

from gnnbench.models.gcn import adjacency  # noqa: F401 (the same Adjacency)
from gnnbench.roofline import matmul_flops

SPMM_SITES = (("gespmm_tpu_torch.ops.graph", "spmm"),)


def model(config: dict, adj, device):
    from gespmm_tpu_torch.models.sage import GraphSAGE

    return GraphSAGE(config["dims"], aggregator=config["aggregator"],
                     dropout_rate=config["dropout"], method="auto",
                     device=device)


def spmm_calls(config: dict, n: int, nnz: int) -> List[Tuple[int, int, int]]:
    """(n, nnz, K) of every SpMM of a step."""
    dims = config["dims"]
    forward = [(n, nnz, k) for k in dims[:-1]]
    backward = [(n, nnz, k) for k in dims[1:-1]]
    return forward + backward


def dense_flops(config: dict, n: int) -> int:
    dims = config["dims"]
    total = 0
    for i in range(len(dims) - 1):
        products = 2 if i == 0 else 3
        total += 2 * products * matmul_flops(n, dims[i], dims[i + 1])
    return total
