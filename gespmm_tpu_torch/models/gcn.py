"""GCN on the SpMM primitive — port of ``gespmm_tpu/models/gcn.py``.

Each layer runs, in this order: ``x @ W``, ``* in_norm``, sum-SpMM,
``* out_norm``, ``+ b``, then dropout and ReLU between layers.  A layer that
widens, whose input takes no gradient (``GCN.aggregate_input``; layer 0 in
training), takes W's gradient from its input's aggregate, ``* in_norm``,
sum-SpMM, ``* out_norm`` at the input's width, in place of a grad_B SpMM at
W's output width; its forward rounds as the others'.  Parameters
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


class _WeightGradFrom(torch.autograd.Function):
    """``z`` unchanged forward; backward, ``w``'s gradient ``agg.T @ g``.

    ``z`` is ``agg @ w``, computed without autograd from ``w``: a layer's
    aggregate of ``x @ w``, where ``agg`` is the aggregate of ``x``."""

    @staticmethod
    def forward(ctx, z: Tensor, agg: Tensor, w: Tensor) -> Tensor:
        ctx.save_for_backward(agg)
        return z.view_as(z)

    @staticmethod
    def backward(ctx, g: Tensor):
        agg, = ctx.saved_tensors
        return None, None, agg.t() @ g


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
        # Per layer: whether W's gradient comes from the aggregate of the
        # layer's input, narrower than W's output, where that input takes
        # no gradient.
        self.aggregate_input = tuple(dims[i] < dims[i + 1]
                                     for i in range(self.n_layers))

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
            from_input = (self.aggregate_input[i] and not h.requires_grad
                          and layer.w.requires_grad and torch.is_grad_enabled())
            if from_input:
                with span("model/norm"):
                    agg = h * in_norm[:, None].to(h.dtype)
                agg = spmm(adj, agg, reduce="sum", method=self.method)
                with span("model/norm"):
                    agg = agg * out_norm[:, None].to(agg.dtype)
            # One name for the activations, so each is freed as soon as the
            # next is made.
            with span("model/dense"):
                h = h @ (layer.w.detach() if from_input else layer.w)
            with span("model/norm"):
                h = h * in_norm[:, None].to(h.dtype)
            h = spmm(adj, h, reduce="sum", method=self.method)
            with span("model/norm"):
                h = h * out_norm[:, None].to(h.dtype)
            if from_input:
                with span("model/dense"):
                    h = _WeightGradFrom.apply(h, agg, layer.w)
            if layer.b is not None:
                with span("model/norm"):
                    h = h + layer.b
            if i < self.n_layers - 1:
                # Dropout, then ReLU: the two commute, and the ReLU's saved
                # output is then the tensor the next layer saves.
                h = dropout(h, self.dropout_rate, self.training, generator)
                with span("model/relu"):
                    h = torch.relu(h)
        return h

    def log_probs(self, adj: Adjacency, x: Tensor, **kw) -> Tensor:
        logits = self(adj, x, **kw)
        with span("model/log_softmax"):
            return torch.log_softmax(logits, dim=-1)


__all__ = ["GCN", "params_from_jax"]
