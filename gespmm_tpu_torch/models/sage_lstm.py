"""LSTM neighbourhood aggregator for GraphSAGE — port of ``gespmm_tpu/models/sage_lstm.py``.

LSTM aggregation is order-sensitive and recurrent, not an SpMM.  As in the
JAX package it runs on

  * a padded neighbour table (n, D) built once per graph on the host, with
    a mask of the real neighbours: rows of more than ``max_neighbors``
    edges keep a uniform sample (GraphSAGE's neighbour sampling), drawn with
    the same NumPy generator calls as the JAX package, so the tables are
    equal;
  * D steps of one LSTM cell batched over all n nodes, each step's state
    update masked so that a row holds its state once its neighbours run
    out.

The cell's parameters are ``wi`` (in, 4H), ``wh`` (H, 4H) and ``b`` (4H),
gate order i, f, g, o, as the JAX pytree: ``torch.nn.LSTMCell`` carries a
second bias and transposed weights, so the cell math is written out here
and ``params_from_jax`` carries the JAX parameters across one to one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from gespmm_tpu_torch.models.common import glorot
from gespmm_tpu_torch.sparse.formats import CSR

Tensor = torch.Tensor


def build_neighbor_table(csr: CSR, max_neighbors: int = 32, seed: int = 0,
                         device=None) -> Tuple[Tensor, Tensor]:
    """(neighbors (n, D) int64, mask (n, D) bool) on ``device`` (default:
    the CSR's), built on the host once per graph."""
    indptr = csr.indptr.cpu().numpy()
    indices = csr.indices.cpu().numpy()
    m = csr.shape[0]
    D = max_neighbors
    rng = np.random.default_rng(seed)
    nbrs = np.zeros((m, D), np.int64)
    mask = np.zeros((m, D), bool)
    for r in range(m):
        row = indices[indptr[r]:indptr[r + 1]]
        if row.shape[0] > D:
            row = rng.choice(row, size=D, replace=False)
        nbrs[r, :row.shape[0]] = row
        mask[r, :row.shape[0]] = True
    device = csr.device if device is None else device
    return torch.from_numpy(nbrs).to(device), torch.from_numpy(mask).to(device)


class LSTM(nn.Module):
    """The LSTM cell's parameters: ``wi`` (in, 4H), ``wh`` (H, 4H), ``b``;
    ``LSTM(in_dim, hidden)`` is JAX's ``lstm_cell_init``."""

    def __init__(self, in_dim: int, hidden: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.wi = nn.Parameter(glorot((in_dim, 4 * hidden), **kw))
        self.wh = nn.Parameter(glorot((hidden, 4 * hidden), **kw))
        self.b = nn.Parameter(torch.zeros(4 * hidden, device=device))

    def forward(self, x: Tensor, neighbors: Tensor, mask: Tensor) -> Tensor:
        return lstm_aggregate(self, x, neighbors, mask)


def _lstm_step(p: LSTM, h: Tensor, c: Tensor, x: Tensor):
    gates = x @ p.wi + h @ p.wh + p.b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


def lstm_aggregate(p: LSTM, x: Tensor, neighbors: Tensor,
                   mask: Tensor) -> Tensor:
    """h_agg[v] = the final LSTM state over v's (sampled) neighbour
    features."""
    n, D = neighbors.shape
    hidden = p.wh.shape[0]
    h = x.new_zeros(n, hidden)
    c = x.new_zeros(n, hidden)
    steps = neighbors.t().contiguous()  # (D, n): step t's neighbours
    keep = mask.t().to(x.dtype)[:, :, None]  # (D, n, 1)
    for t in range(D):
        h2, c2 = _lstm_step(p, h, c, x.index_select(0, steps[t]))
        m = keep[t]
        h, c = h2 * m + h * (1 - m), c2 * m + c * (1 - m)
    return h
