"""GCN through the program: ``Adjacency.from_csr`` and
``gespmm_tpu_torch.models.gcn.GCN`` with its degree norms cached.

Work of one full-batch step over n nodes and nnz stored nonzeros (self-loops
included), layer i of widths (d_i, d_i+1): x @ W forward, the weight's
gradient, and the input's gradient except at layer 0 (x needs none); a sum
SpMM at width d_i+1 forward and one backward (grad_B) in every layer.
"""

from __future__ import annotations

from typing import List, Tuple

from gnnbench.roofline import matmul_flops

SPMM_SITES = (("gespmm_tpu_torch.models.gcn", "spmm"),)


def adjacency(graph, device):
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.sparse.formats import CSR

    csr = CSR(graph.indptr, graph.indices, None, (graph.n, graph.n))
    return Adjacency.from_csr(csr, device=device)


def model(config: dict, adj, device):
    from gespmm_tpu_torch.models.gcn import GCN

    return GCN(config["dims"], dropout_rate=config["dropout"], method="auto",
               device=device).with_norms(adj)


def spmm_calls(config: dict, n: int, nnz: int) -> List[Tuple[int, int, int]]:
    """(n, nnz, K) of every SpMM of a step."""
    widths = config["dims"][1:]
    return [(n, nnz, k) for k in widths] * 2


def dense_flops(config: dict, n: int) -> int:
    dims = config["dims"]
    total = 0
    for i in range(len(dims) - 1):
        products = 2 if i == 0 else 3
        total += products * matmul_flops(n, dims[i], dims[i + 1])
    return total
