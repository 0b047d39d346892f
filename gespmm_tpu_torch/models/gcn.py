"""GCN on the SpMM primitive — port of ``gespmm_tpu/models/gcn.py``.

Each layer runs, in this order: ``x @ W``, ``* in_norm``, sum-SpMM,
``* out_norm``, ``+ b``, then ReLU and dropout between layers.  Parameters
are named ``layer_{i}.w`` (shaped (in, out)) and ``layer_{i}.b``, so
``params_from_jax`` (``models/common.py``, re-exported here) carries the JAX
package's parameters across unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gespmm_tpu_torch.models.common import Dense, dropout, params_from_jax
from gespmm_tpu_torch.ops.graph import degree_norm
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


class GCN(nn.Module):
    """n-layer GCN, ``dims = [in, hidden..., out]``.

    ``forward`` is the JAX package's ``apply``: it returns logits.  Dropout
    runs in training mode (``model.train()``) and draws from the
    ``generator`` passed to ``forward``.
    """

    def __init__(self, dims: Sequence[int], dropout_rate: float = 0.5,
                 bias: bool = True, method: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dims = list(dims)
        self.dropout_rate = dropout_rate
        self.method = method
        # Per-graph (out_norm, in_norm), cached by with_norms.
        self.norms = None
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", Dense(
                dims[i], dims[i + 1], bias=bias, generator=generator,
                device=device))

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def with_norms(self, adj: Adjacency) -> "GCN":
        """Cache the degree norms of ``adj`` so steps skip the reduction."""
        with span("graph_prep/degree_norm"):
            self.norms = degree_norm(adj)
        return self

    def forward(self, adj: Adjacency, x: Tensor, *, norms=None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if norms is None:
            norms = self.norms if self.norms is not None else degree_norm(adj)
        out_norm, in_norm = norms
        h = x
        for i in range(self.n_layers):
            layer = getattr(self, f"layer_{i}")
            # Dense transform first: it shrinks the width the SpMM gathers.
            with span("model/dense"):
                h = h @ layer.w
            with span("model/norm"):
                h = h * in_norm[:, None].to(h.dtype)
            h = spmm(adj, h, reduce="sum", method=self.method)
            with span("model/norm"):
                h = h * out_norm[:, None].to(h.dtype)
                if layer.b is not None:
                    h = h + layer.b
            if i < self.n_layers - 1:
                with span("model/relu"):
                    h = torch.relu(h)
                h = dropout(h, self.dropout_rate, self.training, generator)
        return h

    def log_probs(self, adj: Adjacency, x: Tensor, **kw) -> Tensor:
        logits = self(adj, x, **kw)
        with span("model/log_softmax"):
            return torch.log_softmax(logits, dim=-1)


__all__ = ["GCN", "params_from_jax"]
