"""GAT (PyG's ogbn-products example) through the program:
``Adjacency.from_csr`` and ``gespmm_tpu_torch.models.gat.GAT`` with its skip
projections, on ``method="auto"``: one fused attention call a layer
(``kernels/gat_fused.py::gat_attention_aggregate``), every head at once.

Work of one full-batch step over n nodes and nnz stored nonzeros (self-loops
included), layer i with H heads of width dh_i and input width d_i (K_i =
H·dh_i):

* dense: the projection (d_i, K_i) and the skip (d_i, K_i, or dh_i at the
  mean-merged output layer): each forward, its weight's gradient, and its
  input's gradient except at layer 0 (x needs none);
* attention: the fused op's three walks a layer (the forward over the CSR,
  the backward over the CSR to the source scores and over the CSC to B and
  the destination scores), at K_i.  Two of them are SpMM-shaped (the
  forward and grad_B), and ``spmm_calls`` counts those for ``step_mfu``.
"""

from __future__ import annotations

from typing import List, Tuple

from gnnbench.models.gcn import adjacency  # noqa: F401 (the same Adjacency)
from gnnbench.roofline import matmul_flops

# The model calls no ``spmm``: the fused op aggregates.
SPMM_SITES = ()


def model(config: dict, adj, device):
    from gespmm_tpu_torch.models.gat import GAT

    return GAT(config["dims"], dropout_rate=config["dropout"],
               negative_slope=config["negative_slope"], method="auto",
               heads=config["heads"], skip=config["skip"], device=device)


def _layers(config: dict) -> List[Tuple[int, int, int]]:
    """(input width, H·dh, skip width) of each layer."""
    dims, H = config["dims"], config["heads"]
    layers = len(dims) - 1
    return [(dims[i] * (H if i > 0 else 1), H * dims[i + 1],
             dims[i + 1] * (1 if i == layers - 1 else H))
            for i in range(layers)]


def attention_calls(config: dict, n: int,
                    nnz: int) -> List[Tuple[int, int, int, int, int]]:
    """(m, n, nnz, K, H) of every fused attention call of a step, one a
    layer, each walked forward and twice backward."""
    return [(n, n, nnz, k, config["heads"]) for _, k, _ in _layers(config)]


def spmm_calls(config: dict, n: int, nnz: int) -> List[Tuple[int, int, int]]:
    """(n, nnz, K) of the fused calls' SpMM-shaped walks: the forward's
    weighted sum and grad_B, a layer."""
    return [(n, nnz, k) for _, k, _ in _layers(config)] * 2


def dense_flops(config: dict, n: int) -> int:
    total = 0
    for i, (d_in, k, skip) in enumerate(_layers(config)):
        products = 2 if i == 0 else 3
        total += products * matmul_flops(n, d_in, k)
        if config["skip"]:
            total += products * matmul_flops(n, d_in, skip)
    return total
