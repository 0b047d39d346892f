"""Sharded GNN training over a (data, model) mesh — port of ``gespmm_tpu/parallel/train_step.py``.

  * "data" axis: graph rows are partitioned into the mesh's shards;
    activations, labels and masks are row-sharded, and every aggregation is
    ``halo_spmm`` (kernel row 7 on the card), which exchanges only the halo
    rows each shard needs.  With a ``torch.distributed`` group the loss is
    the global masked mean and the parameter gradients are summed over the
    rank's data group (data-parallel).
  * "model" axis (the GCN): the hidden dimension is cut into the mesh's
    model slices.  ``l1.w`` and ``l1.b`` are split by columns, ``l2.w`` by
    rows, ``l2.b`` is replicated (``shard_gcn_params``); the hidden
    aggregation runs once a slice, and the output layer's contraction sums
    the slices' partial products (``parallel/mesh.py::model_sum``: an
    ``all_reduce`` over the model group under a group, whose backward passes
    the replicated cotangent through).  GraphSAGE and GAT replicate their
    features over the model axis, as in the JAX package.

Each builder returns ``(train_step, (model, optimizer), prepare_inputs,
hp)``: ``train_step(model, optimizer, x, labels, mask)`` takes one AdamW step
and returns ``(model, optimizer, loss)``; ``prepare_inputs`` pads
node-indexed arrays to num_parts*rpp rows and puts the local shards' rows on
the mesh's device.  The modules name their parameters as the JAX params
(``l1.w``, ``att.src``, ``pool1.b``, ...), so ``models/common.py::
params_from_jax`` loads a JAX init state into them (through
``shard_gcn_params`` for the GCN under a group).  The optimizer is
``optax.adamw(lr)``'s: weight decay 1e-4, eps 1e-8, betas (0.9, 0.999).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from gespmm_tpu_torch.models.common import Dense
from gespmm_tpu_torch.parallel.edge_ops import (halo_additive_logits,
                                                halo_edge_softmax)
from gespmm_tpu_torch.parallel.halo import build_halo_partition, halo_spmm
from gespmm_tpu_torch.parallel.mesh import Mesh, model_sum

Tensor = torch.Tensor

# optax.adamw's defaults (the JAX builders pass only the learning rate).
ADAMW_WEIGHT_DECAY = 1e-4
ADAMW_EPS = 1e-8


def shard_gcn_params(state: Dict[str, Tensor], mesh: Mesh) -> Dict[str, Tensor]:
    """A whole 2-layer GCN state dict (``l1.w``, ``l1.b``, ``l2.w``,
    ``l2.b``, as ``params_from_jax`` gives it) cut to this process's share
    of the model axis: the local slices' columns of ``l1.w`` and ``l1.b``
    and rows of ``l2.w``; ``l2.b`` (and any other entry) whole.  Without a
    group the share is every slice, so the state comes back whole."""
    S = mesh.local_slices
    w = mesh.slice_width(int(state["l1.w"].shape[1]), "hidden")
    cols = slice(S[0] * w, (S[-1] + 1) * w)
    out = dict(state)
    out["l1.w"] = state["l1.w"][:, cols]
    out["l1.b"] = state["l1.b"][cols]
    out["l2.w"] = state["l2.w"][cols]
    return out


class ShardedGCN(nn.Module):
    """Two dense layers, each followed by a ``mean`` halo aggregation (no
    symmetric normalisation), ReLU between them: the JAX forward.  On a
    mesh of model > 1 the hidden aggregation runs once a local slice and
    the output layer sums the slices' partial products (``model_sum``)."""

    def __init__(self, hp, mesh: Mesh, feat_dim: int, hidden: int,
                 classes: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hp, self.mesh = hp, mesh
        mesh.slice_width(hidden, "hidden")
        self.l1 = Dense(feat_dim, hidden, generator=generator)
        self.l2 = Dense(hidden, classes, generator=generator)
        if mesh.group is not None and mesh.model > 1:
            # The whole init, then this rank's share: model=1 and model>1
            # start from equal parameters.
            local = shard_gcn_params(dict(self.named_parameters()), mesh)
            for name, value in local.items():
                layer, attr = name.split(".")
                setattr(getattr(self, layer), attr,
                        nn.Parameter(value.detach().clone()))

    def forward(self, x: Tensor) -> Tensor:
        hp, mesh = self.hp, self.mesh
        h = torch.relu(halo_spmm(hp, self.l1(x), mesh, reduce="mean"))
        if mesh.model == 1:
            logits = self.l2(h)
        else:
            S = len(mesh.local_slices)
            w = h.shape[1] // S
            partials = torch.stack([
                h[:, i * w:(i + 1) * w] @ self.l2.w[i * w:(i + 1) * w]
                for i in range(S)])
            logits = model_sum(partials, mesh) + self.l2.b
        return halo_spmm(hp, logits, mesh, reduce="mean", model_axis=None)


class _SAGELayer(nn.Module):
    """W_self · h + W_neigh · agg(h_N); its children are named "self" and
    "neigh", as the JAX params."""

    def __init__(self, in_dim: int, out_dim: int, generator):
        super().__init__()
        self.add_module("self", Dense(in_dim, out_dim, generator=generator))
        self.neigh = Dense(in_dim, out_dim, generator=generator)

    def forward(self, h: Tensor, agg: Tensor) -> Tensor:
        return self._modules["self"](h) + self.neigh(agg)


class ShardedSAGE(nn.Module):
    """Two SAGEConv layers with ReLU between; ``pool`` applies ReLU of the
    pre-pool layer (``pool1``/``pool2``) before a ``max`` aggregation."""

    def __init__(self, hp, mesh: Mesh, feat_dim: int, hidden: int,
                 classes: int, aggregator: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hp, self.mesh, self.aggregator = hp, mesh, aggregator
        self.l1 = _SAGELayer(feat_dim, hidden, generator)
        self.l2 = _SAGELayer(hidden, classes, generator)
        if aggregator == "pool":
            self.pool1 = Dense(feat_dim, feat_dim, generator=generator)
            self.pool2 = Dense(hidden, hidden, generator=generator)

    def _layer(self, layer: _SAGELayer, h: Tensor, pool: Optional[Dense]):
        if pool is None:
            agg = halo_spmm(self.hp, h, self.mesh, reduce=self.aggregator,
                            model_axis=None)
        else:
            agg = halo_spmm(self.hp, torch.relu(pool(h)), self.mesh,
                            reduce="max", model_axis=None)
        return layer(h, agg)

    def forward(self, x: Tensor) -> Tensor:
        pool = self.aggregator == "pool"
        h = torch.relu(self._layer(self.l1, x, self.pool1 if pool else None))
        return self._layer(self.l2, h, self.pool2 if pool else None)


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int, generator):
        super().__init__()
        self.src = nn.Parameter(0.1 * torch.randn(width, heads,
                                                  generator=generator))
        self.dst = nn.Parameter(0.1 * torch.randn(width, heads,
                                                  generator=generator))


class ShardedGAT(nn.Module):
    """Dense layer, additive attention (logits, leaky ReLU 0.2, softmax)
    with every head aggregated by one ``halo_spmm`` over per-head runtime
    values, ELU, the output layer and a ``mean`` aggregation."""

    def __init__(self, hp, mesh: Mesh, feat_dim: int, hidden: int,
                 classes: int, heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hp, self.mesh, self.heads = hp, mesh, heads
        self.l1 = Dense(feat_dim, hidden * heads, generator=generator)
        self.att = _Attention(hidden * heads, heads, generator)
        self.l2 = Dense(hidden * heads, classes, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        hp, mesh = self.hp, self.mesh
        h = self.l1(x)
        dl, hl = halo_additive_logits(hp, h @ self.att.src, h @ self.att.dst,
                                      mesh)
        ad, ah = halo_edge_softmax(
            hp, torch.nn.functional.leaky_relu(dl, 0.2),
            torch.nn.functional.leaky_relu(hl, 0.2), mesh)
        if self.heads == 1:
            ad, ah = ad[..., 0], ah[..., 0]
        h = torch.nn.functional.elu(
            halo_spmm(hp, h, mesh, diag_vals=ad, halo_vals=ah,
                      model_axis=None))
        return halo_spmm(hp, self.l2(h), mesh, reduce="mean", model_axis=None)


def _global_loss(logits: Tensor, labels: Tensor, mask: Tensor,
                 mesh: Mesh) -> Tensor:
    """The masked mean NLL over every shard's nodes (this rank's share of
    it with a group: the local masked sum over the count of the data
    group, which the model axis replicates)."""
    lp = torch.log_softmax(logits, dim=-1)
    ll = lp.gather(-1, labels[:, None].long())[:, 0]
    maskf = mask.to(lp.dtype)
    count = maskf.sum()
    if mesh.group is not None:
        count = count.detach().clone()
        dist.all_reduce(count, group=mesh.data_group)
    return -(ll * maskf).sum() / torch.clamp(count, min=1.0)


def _make_step(mesh: Mesh):
    def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                   x: Tensor, labels: Tensor, mask: Tensor):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = _global_loss(model(x), labels, mask, mesh)
        loss.backward()
        loss = loss.detach()
        if mesh.group is not None:
            # Over the data group only: a model slice's gradient is its own,
            # and a replicated parameter's is equal on every slice.
            for p in model.parameters():
                dist.all_reduce(p.grad, group=mesh.data_group)
            dist.all_reduce(loss, group=mesh.data_group)
        optimizer.step()
        return model, optimizer, loss

    return train_step


def _make_prepare(hp, mesh: Mesh):
    """Each cell gets its shards' rows with every feature column: the first
    layer's ``x @ l1.w[:, slice]`` needs them (the JAX package feeds x in
    as P("data", "model") and XLA inserts that all-gather itself)."""
    m_pad = hp.num_parts * hp.rpp
    shards = mesh.local_shards
    local = slice(shards[0] * hp.rpp, (shards[-1] + 1) * hp.rpp)

    def prepare_inputs(x, labels, mask):
        def pad_rows(a):
            if not isinstance(a, Tensor):
                a = torch.from_numpy(np.array(a))  # a writable copy
            pad = a.new_zeros((m_pad - a.shape[0],) + tuple(a.shape[1:]))
            return torch.cat([a, pad])[local].to(mesh.device)

        return (pad_rows(x).to(torch.float32), pad_rows(labels).long(),
                pad_rows(mask).bool())

    return prepare_inputs


def _square_partition(csr, mesh: Mesh, name: str):
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"{name} needs a square adjacency")
    return build_halo_partition(csr, mesh.data, tiled=True, device=mesh.device)


def _finish(model: nn.Module, hp, mesh: Mesh, lr: float):
    model = model.to(mesh.device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  weight_decay=ADAMW_WEIGHT_DECAY,
                                  eps=ADAMW_EPS)
    return _make_step(mesh), (model, optimizer), _make_prepare(hp, mesh), hp


def build_sharded_gcn(csr, feat_dim: int, hidden: int, classes: int,
                      mesh: Mesh, lr: float = 1e-2, seed: int = 0):
    """The sharded 2-layer GCN: ``(train_step, (model, optimizer),
    prepare_inputs, hp)``; its aggregations ride kernel row 7 (``mean``)."""
    hp = _square_partition(csr, mesh, "build_sharded_gcn")
    if hp.rpp != hp.cpp:
        raise ValueError("square adjacency must slab rows and columns alike")
    gen = torch.Generator().manual_seed(seed)
    return _finish(ShardedGCN(hp, mesh, feat_dim, hidden, classes, gen), hp,
                   mesh, lr)


def build_sharded_sage(csr, feat_dim: int, hidden: int, classes: int,
                       mesh: Mesh, aggregator: str = "mean", lr: float = 1e-2,
                       seed: int = 0):
    """The sharded 2-layer GraphSAGE (aggregator mean / sum / pool; pool
    aggregates with ``max``, joint diag+halo ties on kernel row 7)."""
    if aggregator not in ("mean", "sum", "pool"):
        raise ValueError(f"unknown aggregator {aggregator!r}")
    hp = _square_partition(csr, mesh, "build_sharded_sage")
    gen = torch.Generator().manual_seed(seed)
    return _finish(ShardedSAGE(hp, mesh, feat_dim, hidden, classes, aggregator,
                               gen), hp, mesh, lr)


def build_sharded_gat(csr, feat_dim: int, hidden: int, classes: int,
                      mesh: Mesh, heads: int = 1, lr: float = 5e-3,
                      seed: int = 0):
    """The sharded 2-layer GAT: attention through the shards
    (``parallel/edge_ops.py``), every head aggregated in one ``halo_spmm``
    with per-head runtime values on kernel row 7."""
    hp = _square_partition(csr, mesh, "build_sharded_gat")
    gen = torch.Generator().manual_seed(seed)
    return _finish(ShardedGAT(hp, mesh, feat_dim, hidden, classes, heads, gen),
                   hp, mesh, lr)
