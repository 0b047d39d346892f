"""GraphSAGE on the SpMM primitive — port of ``gespmm_tpu/models/sage.py``.

SAGEConv semantics (as in DGL and the JAX package):
  mean:  h = x·W_self + mean_agg(x)·W_neigh + b
  gcn:   h = gcn_agg(x)·W_neigh + b                    (no W_self)
  pool:  h = x·W_self + max_agg(relu(x·W_pool + b_pool))·W_neigh + b
  sum:   h = x·W_self + sum_agg(x)·W_neigh + b

  lstm:  h = x·W_self + lstm_agg(x)·W_neigh + b        (models/sage_lstm.py)

``mean``, ``gcn`` and ``sum`` are linear, so a layer that narrows (in > out)
runs its neighbour path as ``agg(x·W_neigh) + b``: the SpMM gathers out
columns, not in (the bias after the aggregate, where an empty row's mean
must still read b).  ``pool`` and ``lstm`` always aggregate first.
``SAGEConv.aggregate_first`` says which.

``pool`` runs the max-SpMM kernel forward and backward.  ``lstm`` runs an
LSTM cell (hidden size = in) over a padded neighbour table
(``models/sage_lstm.py::build_neighbor_table``), given to ``GraphSAGE`` at
construction or per call.  Parameters are named
``layer_{i}.{self,neigh,pool}.{w,b}`` and ``layer_{i}.lstm.{wi,wh,b}`` after
the JAX pytree, so ``params_from_jax`` carries them across.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gespmm_tpu_torch.models.common import Dense, dropout
from gespmm_tpu_torch.models.sage_lstm import LSTM, lstm_aggregate
from gespmm_tpu_torch.ops.graph import sage_aggregate
from gespmm_tpu_torch.ops.spmm import Adjacency
from gespmm_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

AGGREGATORS = ("mean", "gcn", "pool", "sum", "lstm")
# The aggregators that commute with the neighbour product.
LINEAR = ("mean", "gcn", "sum")


def _check_aggregator(aggregator: str) -> None:
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; expected one of "
                         f"{AGGREGATORS}")


class SAGEConv(nn.Module):
    """One GraphSAGE layer: ``self`` is a Dense without bias, ``neigh`` a
    Dense with bias, ``pool`` (pool only) a Dense in -> in with bias,
    ``lstm`` (lstm only) an LSTM cell in -> in."""

    def __init__(self, in_dim: int, out_dim: int, aggregator: str = "mean",
                 bias: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _check_aggregator(aggregator)
        self.aggregator = aggregator
        kw = dict(generator=generator, device=device)
        if aggregator != "gcn":
            self.add_module("self", Dense(in_dim, out_dim, bias=False, **kw))
        self.neigh = Dense(in_dim, out_dim, bias=bias, **kw)
        if aggregator == "pool":
            self.pool = Dense(in_dim, in_dim, bias=True, **kw)
        if aggregator == "lstm":
            self.lstm = LSTM(in_dim, in_dim, **kw)
        # A linear aggregator commutes with W_neigh: a layer that narrows
        # transforms first, so the SpMM gathers the narrower width.
        self.aggregate_first = aggregator not in LINEAR or in_dim <= out_dim

    def forward(self, adj: Adjacency, x: Tensor, method: str = "auto",
                neighbor_table=None) -> Tensor:
        if self.aggregator == "lstm":
            if neighbor_table is None:
                raise ValueError(
                    "aggregator='lstm' needs a neighbor_table "
                    "(models.sage_lstm.build_neighbor_table)")
            agg = lstm_aggregate(self.lstm, x, *neighbor_table)
            with span("model/dense"):
                return getattr(self, "self")(x) + self.neigh(agg)
        if self.aggregate_first:
            h = x
            if self.aggregator == "pool":
                h = self.pool(x)
                with span("model/relu"):
                    h = torch.relu(h)
            neigh = self.neigh(sage_aggregate(
                adj, h, aggregator=self.aggregator, method=method))
        else:
            with span("model/dense"):
                h = x @ self.neigh.w
            neigh = sage_aggregate(adj, h, aggregator=self.aggregator,
                                   method=method)
            if self.neigh.b is not None:
                with span("model/dense"):
                    neigh = neigh + self.neigh.b
        if self.aggregator == "gcn":
            return neigh
        with span("model/dense"):
            return getattr(self, "self")(x) + neigh


class GraphSAGE(nn.Module):
    """n-layer GraphSAGE, ``dims = [in, hidden..., out]``.

    ``forward`` is the JAX package's ``apply``: it returns logits.  In
    training mode (``model.train()``) dropout runs before every layer, the
    input layer too, drawing from the ``generator`` passed to ``forward``;
    ReLU runs between layers, after the next layer's dropout.  For
    ``aggregator="lstm"`` give a per-graph ``neighbor_table``
    (``models.sage_lstm.build_neighbor_table``) here or per call.
    """

    def __init__(self, dims: Sequence[int], aggregator: str = "mean",
                 dropout_rate: float = 0.5, method: str = "auto", *,
                 neighbor_table=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _check_aggregator(aggregator)
        self.dims = list(dims)
        self.aggregator = aggregator
        self.dropout_rate = dropout_rate
        self.method = method
        self.neighbor_table = neighbor_table
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", SAGEConv(
                dims[i], dims[i + 1], aggregator, generator=generator,
                device=device))

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def forward(self, adj: Adjacency, x: Tensor, *,
                generator: Optional[torch.Generator] = None,
                neighbor_table=None) -> Tensor:
        table = (neighbor_table if neighbor_table is not None
                 else self.neighbor_table)
        h = x
        for i in range(self.n_layers):
            h = dropout(h, self.dropout_rate, self.training, generator)
            if i > 0:
                # The previous layer's ReLU, after this dropout: the two
                # commute, and the ReLU's saved output is then the tensor
                # this layer saves.
                with span("model/relu"):
                    h = torch.relu(h)
            h = getattr(self, f"layer_{i}")(adj, h, self.method, table)
        return h

    def log_probs(self, adj: Adjacency, x: Tensor, **kw) -> Tensor:
        logits = self(adj, x, **kw)
        with span("model/log_softmax"):
            return torch.log_softmax(logits, dim=-1)
