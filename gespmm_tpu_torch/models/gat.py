"""GAT on the fused attention op — port of ``gespmm_tpu/models/gat.py``.

GATv1 additive attention, per head:
  e_ij  = LeakyReLU(a_src · (W h_i) + a_dst · (W h_j))
  α_ij  = softmax_j over i's in-edges
  h'_i  = Σ_j α_ij (W h_j)

``method="auto"``/``"tiled"`` runs the whole layer, every head at once, as
``ops/graph.py::gat_attention_aggregate`` (the fused CUDA kernels of row 5
on the card).  Any other sum method of ``spmm`` composes the layer head by
head, as the JAX package does: ``additive_attention_logits``, leaky ReLU,
``edge_softmax``, then ``spmm(adj.with_data(alpha), h, method=method)``.
Under ``"xla"`` every step takes its plain version; under ``"pallas"``,
``"scatter"`` or ``"dense"`` the edge ops take their ``"auto"`` tier (the
edge segment-reduce kernel on the card) and the aggregate that method
(``"pallas"``: the chunk kernel over a ``plan="perrow"`` adjacency, the
grouped kernel over a ``plan="grouped"`` one).

Multi-head layers follow DGL's GATConv, as the JAX package does: one shared
projection ``w`` (in, H·dh), ``a_src``/``a_dst`` shaped (H, dh); hidden
layers concatenate their heads and the output layer averages them and adds
``b[:dh]``.  A single-head layer keeps 1-D ``a_src``/``a_dst``.  Parameters
are named ``layer_{i}.{w,a_src,a_dst,b}`` after the JAX pytree, so
``params_from_jax`` carries them across.

``GAT(..., skip=True)`` adds PyG's ogbn-products skip connections: a
``Dense`` ``skip_{i}`` (with bias) a layer, from the layer's input to its
output width (H·dh in hidden layers, dh in the mean-merged output layer),
added to the attention layer's output before the ELU.  The JAX package has
no skip, so it is off by default.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gespmm_tpu_torch.models.common import Dense, dropout, glorot
from gespmm_tpu_torch.ops.graph import (additive_attention_logits, edge_softmax,
                                        gat_attention_aggregate)
# Every method of spmm takes reduce="sum", so the layer takes each of them.
from gespmm_tpu_torch.ops.spmm import METHODS, Adjacency, spmm
from gespmm_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

FUSED = ("auto", "tiled")


class GATConv(nn.Module):
    """One GAT layer with ``heads`` attention heads of width ``out_dim``."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.heads = heads
        self.w = nn.Parameter(glorot((in_dim, heads * out_dim), **kw))
        if heads == 1:
            self.a_src = nn.Parameter(glorot((out_dim, 1), **kw)[:, 0])
            self.a_dst = nn.Parameter(glorot((out_dim, 1), **kw)[:, 0])
        else:
            self.a_src = nn.Parameter(glorot((heads, out_dim), **kw))
            self.a_dst = nn.Parameter(glorot((heads, out_dim), **kw))
        self.b = nn.Parameter(torch.zeros(heads * out_dim, device=device))

    def forward(self, adj: Adjacency, x: Tensor, *, negative_slope: float = 0.2,
                method: str = "auto", merge: str = "concat") -> Tensor:
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; expected one of "
                             f"{METHODS}")
        with span("model/dense"):
            h = x @ self.w  # (n, H·dh)
        n = h.shape[0]
        H = self.heads
        dh = h.shape[1] // H
        with span("model/attn_scores"):
            if H == 1:
                src, dst = h @ self.a_src, h @ self.a_dst  # (n,)
            else:
                hv = h.view(n, H, dh)
                src = torch.einsum("nhd,hd->nh", hv, self.a_src)
                dst = torch.einsum("nhd,hd->nh", hv, self.a_dst)
        if method in FUSED:
            out = gat_attention_aggregate(adj, src, dst, h,
                                          negative_slope=negative_slope,
                                          heads=H)
        else:
            out = self._composed(adj, h, src, dst, negative_slope, method)
        if H > 1 and merge == "mean":
            return out.view(out.shape[0], H, dh).mean(1) + self.b[:dh]
        return out + self.b

    def _composed(self, adj: Adjacency, h: Tensor, src: Tensor, dst: Tensor,
                  slope: float, method: str) -> Tensor:
        """The attention chain, one head at a time: the edge ops on their
        plain versions under ``"xla"``, else on their ``"auto"`` tier; the
        aggregate on ``method``."""
        edge_method = "xla" if method == "xla" else "auto"
        if self.heads == 1:
            src, dst = src[:, None], dst[:, None]
        dh = h.shape[1] // self.heads
        outs = []
        for hd in range(self.heads):
            logits = additive_attention_logits(adj, src[:, hd], dst[:, hd],
                                               method=edge_method)
            alpha = edge_softmax(
                adj, torch.nn.functional.leaky_relu(logits, slope),
                method=edge_method)
            outs.append(spmm(adj.with_data(alpha), h[:, hd * dh:(hd + 1) * dh],
                             method=method))
        return torch.cat(outs, dim=1)


class GAT(nn.Module):
    """n-layer GAT, ``dims = [in, hidden..., out]``.

    ``heads`` > 1 follows the DGL GAT benchmark architecture: hidden layers
    run ``heads`` heads merged by concatenation (so the next layer's input
    is hidden·heads wide), the output layer averages its heads.
    ``forward`` is the JAX package's ``apply``: it returns logits.  In
    training mode (``model.train()``) dropout runs before every layer, the
    input layer too, drawing from the ``generator`` passed to ``forward``;
    ELU runs between layers.  ``skip`` adds a ``Dense`` ``skip_{i}`` a
    layer, on the layer's (dropped) input, to its output before the ELU;
    the skips draw their weights after every layer's.
    """

    def __init__(self, dims: Sequence[int], dropout_rate: float = 0.5,
                 negative_slope: float = 0.2, method: str = "auto",
                 heads: int = 1, skip: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dims = list(dims)
        self.dropout_rate = dropout_rate
        self.negative_slope = negative_slope
        self.method = method
        self.heads = heads
        self.skip = skip
        in_dims = [self.dims[i] * (heads if i > 0 else 1)
                   for i in range(self.n_layers)]
        for i, in_dim in enumerate(in_dims):
            self.add_module(f"layer_{i}", GATConv(
                in_dim, self.dims[i + 1], heads, generator=generator,
                device=device))
        if skip:
            for i, in_dim in enumerate(in_dims):
                last = i == self.n_layers - 1
                self.add_module(f"skip_{i}", Dense(
                    in_dim, self.dims[i + 1] * (1 if last else heads),
                    generator=generator, device=device))

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def forward(self, adj: Adjacency, x: Tensor, *,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = x
        for i in range(self.n_layers):
            last = i == self.n_layers - 1
            # The skip takes the layer's own (dropped) input.
            h_in = dropout(h, self.dropout_rate, self.training, generator)
            h = getattr(self, f"layer_{i}")(
                adj, h_in, negative_slope=self.negative_slope,
                method=self.method, merge="mean" if last else "concat")
            if self.skip:
                h = h + getattr(self, f"skip_{i}")(h_in)
            del h_in
            if not last:
                with span("model/elu"):
                    h = torch.nn.functional.elu(h)
        return h

    def log_probs(self, adj: Adjacency, x: Tensor, **kw) -> Tensor:
        logits = self(adj, x, **kw)
        with span("model/log_softmax"):
            return torch.log_softmax(logits, dim=-1)
