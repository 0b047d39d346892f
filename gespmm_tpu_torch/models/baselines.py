"""Stock-PyTorch model baselines for A/B runs — port of ``gespmm_tpu/models/baselines.py``.

The reference compares the same model on the stock framework and on its
kernels (``gcn_pyg.py`` against ``gcn_custom.py``); here the stock framework
is plain PyTorch: ``torch.sparse.mm`` (cuSPARSE on the card) where the
sparse values are constants, gathers, ``index_add`` and ``scatter_reduce``.  No module here calls a kernel of the
port.  ``gcn_bench --impl bcoo`` and ``gat_bench``/``sage_bench --impl
stock`` train them.

Each model's parameters carry the ported model's names (``GCN``'s;
``GATConv``'s with one head; ``SAGEConv``'s for mean/sum/pool) and are drawn
the same way, so ``params_from_jax`` and ``load_state_dict(ours.state_dict())``
both fit and same-seed runs compare.  Each follows the JAX baseline's own
layer order and dropout placement.  ``from_adjacency`` returns the operand
``forward`` takes in place of an ``Adjacency``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gespmm_tpu_torch.models.common import Dense, dropout
from gespmm_tpu_torch.models.gat import GATConv
from gespmm_tpu_torch.models.sage import SAGEConv
from gespmm_tpu_torch.ops.graph import degree_norm
from gespmm_tpu_torch.ops.interop import csr_to_torch_sparse

Tensor = torch.Tensor


class _Stock(nn.Module):
    dims: Sequence[int]

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def log_probs(self, operand, x: Tensor, **kw) -> Tensor:
        return torch.log_softmax(self(operand, x, **kw), dim=-1)


class GCNBcoo(_Stock):
    """The GCN of ``models/gcn.py`` aggregating with ``torch.sparse.mm``;
    dropout only after the hidden ReLU, as in the JAX baseline."""

    def __init__(self, dims: Sequence[int], dropout_rate: float = 0.5,
                 bias: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dims = list(dims)
        self.dropout_rate = dropout_rate
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", Dense(
                dims[i], dims[i + 1], bias=bias, generator=generator,
                device=device))

    def forward(self, operand, x: Tensor, *,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """``operand`` is (sparse CSR tensor, out_norm, in_norm)."""
        A, out_norm, in_norm = operand
        h = x
        for i in range(self.n_layers):
            layer = getattr(self, f"layer_{i}")
            h = h @ layer.w
            h = h * in_norm[:, None].to(h.dtype)
            h = torch.sparse.mm(A, h)
            h = h * out_norm[:, None].to(h.dtype)
            if layer.b is not None:
                h = h + layer.b
            if i < self.n_layers - 1:
                h = torch.relu(h)
                h = dropout(h, self.dropout_rate, self.training, generator)
        return h

    @staticmethod
    def from_adjacency(adj):
        """The (sparse CSR tensor, out_norm, in_norm) this model takes."""
        out_norm, in_norm = degree_norm(adj)
        return csr_to_torch_sparse(adj.csr), out_norm, in_norm


class GATStock(_Stock):
    """The single-head GAT of ``models/gat.py`` from stock ops: gathers, a
    ``scatter_reduce`` row max, an ``index_add`` denominator, and an
    ``index_add`` of ``alpha * h[cols]`` into the rows, as PyG-style code
    aggregates.  Not ``torch.sparse.mm`` over a matrix of alpha: its
    gradient to the values is formed as a dense m x n matrix, O(n^2)
    memory, where this one stays O(nnz K) like the JAX baseline's BCOO
    product.  Dropout runs before every layer, ELU between layers."""

    def __init__(self, dims: Sequence[int], dropout_rate: float = 0.5,
                 negative_slope: float = 0.2, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dims = list(dims)
        self.dropout_rate = dropout_rate
        self.negative_slope = negative_slope
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", GATConv(
                dims[i], dims[i + 1], 1, generator=generator, device=device))

    def forward(self, operand, x: Tensor, *,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """``operand`` is (rows, cols, shape), int64 indices."""
        rows, cols, shape = operand
        m = shape[0]
        h = x
        for i in range(self.n_layers):
            p = getattr(self, f"layer_{i}")
            h = dropout(h, self.dropout_rate, self.training, generator)
            h = h @ p.w
            logits = (h @ p.a_src).index_select(0, rows) \
                + (h @ p.a_dst).index_select(0, cols)
            logits = torch.nn.functional.leaky_relu(logits,
                                                    self.negative_slope)
            # Rows without an edge keep the initial 0; a non-finite max
            # becomes 0, as in the JAX baseline.
            mx = logits.new_zeros(m).scatter_reduce(
                0, rows, logits, reduce="amax", include_self=False)
            mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
            ex = torch.exp(logits - mx.index_select(0, rows))
            den = ex.new_zeros(m).index_add(0, rows, ex)
            alpha = ex / torch.clamp(den.index_select(0, rows), min=1e-20)
            msg = alpha[:, None] * h.index_select(0, cols)
            h = h.new_zeros(m, h.shape[1]).index_add(0, rows, msg) + p.b
            if i < self.n_layers - 1:
                h = torch.nn.functional.elu(h)
        return h

    @staticmethod
    def from_adjacency(adj):
        """The (rows, cols, shape) this model takes."""
        return adj.rows.long(), adj.csr.indices.long(), adj.shape


class SAGEStock(_Stock):
    """GraphSAGE (mean / sum / pool) from stock ops: mean and sum through
    ``torch.sparse.mm`` (the mean's values pre-divided by the row degree),
    pool through a ``scatter_reduce`` row max over ``pre[cols]`` (rows
    without an edge at 0).  Dropout runs before every layer, ReLU between
    layers.  The JAX baseline's ``optimization_barrier`` around the pool's
    gather guards an XLA:TPU miscompile and has no counterpart here."""

    AGGREGATORS = ("mean", "sum", "pool")

    def __init__(self, dims: Sequence[int], aggregator: str = "mean",
                 dropout_rate: float = 0.5, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if aggregator not in self.AGGREGATORS:
            raise ValueError(f"SAGEStock supports {self.AGGREGATORS}, got "
                             f"{aggregator!r}")
        self.dims = list(dims)
        self.aggregator = aggregator
        self.dropout_rate = dropout_rate
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", SAGEConv(
                dims[i], dims[i + 1], aggregator, generator=generator,
                device=device))

    def forward(self, operand, x: Tensor, *,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """``operand`` is (sparse CSR tensor, rows, cols, m)."""
        A, rows, cols, m = operand
        h = x
        for i in range(self.n_layers):
            p = getattr(self, f"layer_{i}")
            h = dropout(h, self.dropout_rate, self.training, generator)
            if self.aggregator == "pool":
                pre = torch.relu(p.pool(h))
                index = rows[:, None].expand(-1, pre.shape[1])
                agg = pre.new_zeros(m, pre.shape[1]).scatter_reduce(
                    0, index, pre.index_select(0, cols), reduce="amax",
                    include_self=False)
            else:
                agg = torch.sparse.mm(A, h)
            h = getattr(p, "self")(h) + p.neigh(agg)
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h

    @staticmethod
    def from_adjacency(adj, aggregator: str = "mean"):
        """The (sparse CSR tensor, rows, cols, m) this model takes: for
        ``"mean"`` the values divided by their row's degree."""
        csr = adj.csr
        data = (torch.ones(csr.nnz, dtype=torch.float32, device=csr.device)
                if csr.data is None else csr.data)
        if aggregator == "mean":
            deg = torch.clamp(csr.row_lengths().to(torch.float32), min=1.0)
            data = data / deg.index_select(0, adj.rows.long())
        return (csr_to_torch_sparse(csr.with_data(data)), adj.rows.long(),
                csr.indices.long(), csr.shape[0])
