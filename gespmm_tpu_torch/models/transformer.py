"""Graph transformer layers on the fused dot-product attention op: PyG's
``TransformerConv`` and the UniMP stack of ``examples/unimp_arxiv.py``
(Shi et al., "Masked Label Prediction: Unified Message Passing Model for
Semi-Supervised Classification", IJCAI 2021).

A ``TransformerConv`` layer of H heads of width dh, over the edges
e = (r, c) of row r (no self-loops are added; the root weight stands in for
them, and a row without an edge aggregates 0):

    q, k, v = x·Wq + bq, x·Wk + bk, x·Wv + bv           (n, H·dh), head blocks
    alpha_e = softmax over row r of <q[r], k[c]>_h / sqrt(dh), per head
    m[r]    = Σ_e alpha_e·m~_e·v[c]      heads concatenated, or averaged
    x_r     = x·Ws + bs                                  the root weight
    beta    = sigmoid([m, x_r, m − x_r]·w_beta)          (n, 1), no bias
    out     = beta·x_r + (1 − beta)·m

m~ is attention dropout: in training each (edge, head) weight is kept with
probability 1 − ``attn_dropout`` and divided by it, else dropped, the mask
drawn as ``torch.rand((nnz, H), generator=gen) < keep`` in the CSR's edge
order.  On ``method="auto"``/``"tiled"`` the attention is one
``ops/graph.py::dot_attention_aggregate`` call for every head (kernel row 6
on the card); ``"xla"`` composes it head by head from ``sddmm``,
``edge_softmax`` and ``spmm(adj.with_data(alpha), ·)`` on their plain
versions (``"xla"``).

``UniMP(dims, heads)``: ``dims = [in, hidden..., out]``; hidden layers run
``heads`` heads of ``hidden // heads`` concatenated, then LayerNorm and
ReLU; the output layer runs ``heads`` heads of ``out`` averaged and gives
the logits.  UniMP's label embedding (``MaskLabel``) is not part of it:
the model takes features alone.  Parameters: ``layer_{i}.{query,key,value,
skip}.{w,b}`` and ``layer_{i}.beta.w`` (``Dense``), ``norm_{i}.{w,b}``.
The LayerNorm's gain is kept as its difference from 1 (``norm_{i}.w``, 0
at the start), so that zero-filled leaves start as PyTorch's LayerNorm
(gain 1, bias 0) and every optimizer step moves it as it moves the gain.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from gespmm_tpu_torch.models.common import Dense
from gespmm_tpu_torch.ops.graph import dot_attention_aggregate, edge_softmax
from gespmm_tpu_torch.ops.sddmm import sddmm
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

FUSED = ("auto", "tiled")
METHODS = (*FUSED, "xla")
LAYER_NORM_EPS = 1e-5


class TransformerConv(nn.Module):
    """One graph transformer layer of ``heads`` heads of width ``out_dim``:
    concatenated (``concat=True``) or averaged, with the root weight
    ``skip`` and its gate ``beta``."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1, *,
                 concat: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.heads, self.out_dim, self.concat = heads, out_dim, concat
        width = heads * out_dim
        self.query = Dense(in_dim, width, **kw)
        self.key = Dense(in_dim, width, **kw)
        self.value = Dense(in_dim, width, **kw)
        merged = width if concat else out_dim
        self.skip = Dense(in_dim, merged, **kw)
        self.beta = Dense(3 * merged, 1, bias=False, **kw)

    def forward(self, adj: Adjacency, x: Tensor, *, attn_dropout: float = 0.0,
                generator: Optional[torch.Generator] = None,
                method: str = "auto") -> Tensor:
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; expected one of "
                             f"{METHODS}")
        H, dh = self.heads, self.out_dim
        q, k, v = self.query(x), self.key(x), self.value(x)
        keep, keep_prob = None, None
        if self.training and attn_dropout > 0.0:
            keep_prob = 1.0 - attn_dropout
            with span("model/dropout"):
                keep = torch.rand((adj.nnz, H), generator=generator,
                                  device=x.device) < keep_prob
        scale = 1.0 / math.sqrt(dh)
        if method in FUSED:
            m = dot_attention_aggregate(adj, q, k, v, heads=H, scale=scale,
                                        edge_keep=keep, keep_prob=keep_prob)
        else:
            m = self._composed(adj, q, k, v, scale, keep, keep_prob)
        if not self.concat:
            m = m.view(m.shape[0], H, dh).mean(1)
        x_r = self.skip(x)
        with span("model/gate"):
            gate = torch.cat([m, x_r, m - x_r], dim=-1)
            b = torch.sigmoid(self.beta(gate))
            return b * x_r + (1.0 - b) * m

    def _composed(self, adj: Adjacency, q: Tensor, k: Tensor, v: Tensor,
                  scale: float, keep: Optional[Tensor],
                  keep_prob: Optional[float]) -> Tensor:
        """The attention head by head on the plain versions of the edge ops
        and the SpMM."""
        dh, outs = self.out_dim, []
        for hd in range(self.heads):
            cut = slice(hd * dh, (hd + 1) * dh)
            logits = sddmm(adj, q[:, cut], k[:, cut], method="xla") * scale
            alpha = edge_softmax(adj, logits, method="xla")
            if keep is not None:
                alpha = torch.where(keep[:, hd], alpha / keep_prob,
                                    torch.zeros((), dtype=alpha.dtype,
                                                device=alpha.device))
            outs.append(spmm(adj.with_data(alpha), v[:, cut], method="xla"))
        return torch.cat(outs, dim=1)


class LayerNorm(nn.Module):
    """LayerNorm over the last dimension with gain ``1 + w`` and bias
    ``b`` (both zero at the start)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(dim, device=device))
        self.b = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: Tensor) -> Tensor:
        with span("model/layer_norm"):
            return torch.nn.functional.layer_norm(
                x, (x.shape[-1],), 1.0 + self.w, self.b, LAYER_NORM_EPS)


class UniMP(nn.Module):
    """The UniMP stack, ``dims = [in, hidden..., out]``: hidden layers of
    ``heads`` heads of ``hidden // heads`` concatenated, each followed by
    LayerNorm and ReLU; the output layer of ``heads`` heads of ``out``
    averaged.  ``forward`` returns the logits; in training mode
    (``model.train()``) each layer's attention drops out at
    ``attn_dropout``, its mask drawn from the ``generator`` passed to
    ``forward``, one draw a layer in layer order."""

    def __init__(self, dims: Sequence[int], heads: int = 1,
                 attn_dropout: float = 0.3, method: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dims = list(dims)
        self.heads = heads
        self.attn_dropout = attn_dropout
        self.method = method
        for i in range(self.n_layers):
            last = i == self.n_layers - 1
            if not last and self.dims[i + 1] % heads:
                raise ValueError(f"hidden width {self.dims[i + 1]} is not a "
                                 f"multiple of heads={heads}")
            out_dim = self.dims[i + 1] if last else self.dims[i + 1] // heads
            self.add_module(f"layer_{i}", TransformerConv(
                self.dims[i], out_dim, heads, concat=not last,
                generator=generator, device=device))
        for i in range(self.n_layers - 1):
            self.add_module(f"norm_{i}", LayerNorm(self.dims[i + 1],
                                                   device=device))

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def forward(self, adj: Adjacency, x: Tensor, *,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = x
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(
                adj, h, attn_dropout=self.attn_dropout, generator=generator,
                method=self.method)
            if i < self.n_layers - 1:
                h = getattr(self, f"norm_{i}")(h)
                with span("model/relu"):
                    h = torch.relu(h)
        return h

    def log_probs(self, adj: Adjacency, x: Tensor, **kw) -> Tensor:
        logits = self(adj, x, **kw)
        with span("model/log_softmax"):
            return torch.log_softmax(logits, dim=-1)
