"""UniMP (PyG's ``examples/unimp_arxiv.py``) through the program:
``Adjacency.from_csr`` and ``gespmm_tpu_torch.models.transformer.UniMP``
on ``method="auto"``: one fused dot-attention call a layer
(``ops/graph.py::dot_attention_aggregate``, kernel row 6), both heads at
once, with the attention dropout's mask inside it.

The program is imported when this module is: a checkout whose program has
no ``models/transformer.py`` fails here, before the graph is built.

Work of one full-batch step over n nodes and nnz stored nonzeros, layer i
with H heads of width dh_i, input width d_i, K_i = H·dh_i and merged width
w_i (K_i in hidden layers, dh_i at the mean-merged output layer):

* dense: the query, key and value projections (d_i, K_i), the skip
  (d_i, w_i) and the gate (3·w_i, 1): each forward, its weight's gradient,
  and its input's gradient except at layer 0 (x needs none);
* attention: the fused op's three walks a layer (the forward over the CSR,
  the backward over the CSR to the queries and over the CSC to the keys and
  values), at K = Ka = K_i (``dot_calls``).  Two of them are SpMM-shaped
  (the forward's weighted sum and grad_B), and ``spmm_calls`` counts those
  for ``step_mfu``.
"""

from __future__ import annotations

from typing import List, Tuple

from gespmm_tpu_torch.models.transformer import UniMP

from gnnbench.models.gcn import adjacency  # noqa: F401 (the same Adjacency)
from gnnbench.roofline import matmul_flops

# The model calls no ``spmm``: the fused op aggregates.
SPMM_SITES = ()


def model(config: dict, adj, device):
    return UniMP(config["dims"], heads=config["heads"],
                 attn_dropout=config["attn_dropout"], method="auto",
                 device=device)


def _layers(config: dict) -> List[Tuple[int, int, int]]:
    """(input width, H·dh, merged width) of each layer."""
    dims, H = config["dims"], config["heads"]
    last = len(dims) - 2
    return [(dims[i], dims[i + 1] * (H if i == last else 1), dims[i + 1])
            for i in range(last + 1)]


def dot_calls(config: dict, n: int,
              nnz: int) -> List[Tuple[int, int, int, int, int, int]]:
    """(m, n, nnz, K, Ka, H) of every fused dot-attention call of a step,
    one a layer, each walked forward and twice backward."""
    return [(n, n, nnz, k, k, config["heads"]) for _, k, _ in _layers(config)]


def spmm_calls(config: dict, n: int, nnz: int) -> List[Tuple[int, int, int]]:
    """(n, nnz, K) of the fused calls' SpMM-shaped walks: the forward's
    weighted sum and grad_B, a layer."""
    return [(n, nnz, k) for _, k, _ in _layers(config)] * 2


def dense_flops(config: dict, n: int) -> int:
    total = 0
    for i, (d_in, k, merged) in enumerate(_layers(config)):
        products = 2 if i == 0 else 3
        total += products * (3 * matmul_flops(n, d_in, k)
                             + matmul_flops(n, d_in, merged))
        total += 3 * matmul_flops(n, 3 * merged, 1)
    return total
