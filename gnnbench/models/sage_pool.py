"""GraphSAGE with the pooling aggregator through the program:
``Adjacency.from_csr`` and ``gespmm_tpu_torch.models.sage.GraphSAGE`` with
``aggregator="pool"`` on ``method="auto"``, whose aggregate is the max
SpMM (``ops/graph.py::sage_aggregate`` -> ``ops/spmm.py::spmm(reduce=
"max")``): kernel row 2 forward over the CSR with its tie counts, row 3
backward over the CSC.

The model calls ``spmm`` from ``ops/graph.py`` (``SPMM_SITES``): the
harness's trace span and the planted wrong grad_B wrap it there, and the
fault lands on layer 0's max, the first call of a step whose input (the
pooled ``relu(x @ W_pool + b_pool)``) takes a gradient.

Work of one full-batch step over n nodes and nnz stored nonzeros, layer i
of widths (d_i, d_i+1):

* dense: the pool product (d_i, d_i), the self product (d_i, d_i+1) and
  the neighbour product (d_i, d_i+1), each forward and its weight's
  gradient; the input's gradient of the neighbour product in every layer
  (the aggregate takes one through the max to W_pool), of the pool and
  self products in every layer but the first (x needs none);
* max: one max SpMM at width d_i forward and one backward in every layer,
  layer 0 too, since W_pool's gradient passes through the max
  (``minmax_calls``).  ``spmm_calls`` counts them for ``step_mfu`` as a
  sum SpMM of the same shape is counted, 2·nnz·K operations a call: a
  compare and a count update a nonzero and column forward, a compare and
  an add (with the share g/ties) backward.
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


def minmax_calls(config: dict, n: int,
                 nnz: int) -> List[Tuple[int, int, int, str]]:
    """(n, nnz, K, direction) of every max SpMM walk of a step: "fwd" (row
    2, over the CSR) and "bwd" (row 3, over the CSC) at each layer's input
    width."""
    widths = config["dims"][:-1]
    return ([(n, nnz, k, "fwd") for k in widths]
            + [(n, nnz, k, "bwd") for k in widths])


def spmm_calls(config: dict, n: int, nnz: int) -> List[Tuple[int, int, int]]:
    """(n, nnz, K) of the step's max SpMM calls, forward and backward."""
    return [(n, nnz, k) for n, nnz, k, _ in minmax_calls(config, n, nnz)]


def dense_flops(config: dict, n: int) -> int:
    dims = config["dims"]
    total = 0
    for i in range(len(dims) - 1):
        products = 2 if i == 0 else 3
        total += products * (matmul_flops(n, dims[i], dims[i])
                             + matmul_flops(n, dims[i], dims[i + 1]))
        total += 3 * matmul_flops(n, dims[i], dims[i + 1])
    return total
