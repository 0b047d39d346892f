"""The one generator of every traffic mix: a graph and its inputs, made on
the device from the seed.

A traffic file (``traffic/<name>.json``) gives the graph's size and degree
law, and how many nodes train.  The configuration gives the widths (input
features, classes) and whether its model adds self-loops.  The same seed
gives the same graph and inputs on the same kind of device.

Degree law ``chung_lu``: each undirected edge joins two endpoints drawn
independently with probability proportional to ``w_i = (i + hub_offset) **
(-1 / (gamma - 1))``, a power law of exponent ``gamma`` whose largest weights
``hub_offset`` caps; self-pairs and repeats are dropped and draws continue
until ``undirected_edges`` distinct pairs exist, of which exactly that many
are kept (a seeded subset).  Node ids are then a seeded random order, so the
hubs lie anywhere.  The graph is stored in both directions, so it is
symmetric with exactly ``2 * undirected_edges`` off-diagonal nonzeros, plus
one self-loop a node when the model asks for them.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

Tensor = torch.Tensor

# Draws a pass, as a share of the edges still missing; a pass that falls
# short draws again.
_OVERSAMPLE = 1.15


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``seed``, so that the
    graph, the inputs, the weights and the dropout draw independent
    streams and any whole number is a valid ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


@dataclasses.dataclass
class Graph:
    """A square CSR on the device: int32 ``indptr`` (n + 1) and ``indices``
    (nnz), sorted within each row; every value is 1."""

    n: int
    indptr: Tensor
    indices: Tensor

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])


@dataclasses.dataclass
class Inputs:
    """Features N(0, 1), labels uniform over the classes, and the train
    mask (exactly ``train_nodes`` nodes, a seeded subset)."""

    x: Tensor
    labels: Tensor
    train_mask: Tensor


def _chung_lu_pairs(n: int, edges: int, gamma: float, hub_offset: float,
                    gen: torch.Generator, device) -> Tensor:
    """``edges`` distinct keys ``a * n + b`` (a < b) of undirected pairs."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    w = (i + hub_offset) ** (-1.0 / (gamma - 1.0))
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.shape[0] < edges:
        draws = int((edges - keys.shape[0]) * _OVERSAMPLE) + 16
        ends = torch.searchsorted(
            cdf, torch.rand(2, draws, generator=gen, dtype=torch.float64,
                            device=device))
        ends.clamp_(max=n - 1)
        a, b = torch.minimum(ends[0], ends[1]), torch.maximum(ends[0], ends[1])
        new = (a * n + b)[a != b]
        keys = torch.unique(torch.cat([keys, new]))
    if keys.shape[0] > edges:
        pick = torch.randperm(keys.shape[0], generator=gen, device=device)
        keys = torch.sort(keys[pick[:edges]]).values
    return keys


def make_graph(traffic: dict, seed: int, device, self_loops: bool) -> Graph:
    """The traffic's graph for ``seed`` on ``device``."""
    law = traffic["degree_law"]
    if law["kind"] != "chung_lu":
        raise ValueError(f"unknown degree law {law['kind']!r}")
    n, edges = int(traffic["nodes"]), int(traffic["undirected_edges"])
    gen = generator(seed, "graph", device)
    keys = _chung_lu_pairs(n, edges, float(law["gamma"]),
                           float(law["hub_offset"]), gen, device)
    order = torch.randperm(n, generator=gen, device=device)
    a, b = order[keys // n], order[keys % n]
    del keys
    parts = [a * n + b, b * n + a]
    if self_loops:
        ids = torch.arange(n, dtype=torch.int64, device=device)
        parts.append(ids * (n + 1))
    keys = torch.sort(torch.cat(parts)).values
    del parts, a, b
    rows = keys // n
    indices = (keys - rows * n).to(torch.int32)
    counts = torch.bincount(rows, minlength=n)
    del keys, rows
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return Graph(n=n, indptr=indptr.to(torch.int32), indices=indices)


def make_inputs(traffic: dict, config: dict, n: int, seed: int,
                device) -> Inputs:
    """Features, labels and train mask of width and class count from the
    configuration, for the traffic's ``train_nodes``."""
    gen = generator(seed, "inputs", device)
    x = torch.randn(n, int(config["in_features"]), generator=gen,
                    device=device)
    labels = torch.randint(0, int(config["num_classes"]), (n,),
                           generator=gen, device=device)
    train = torch.randperm(n, generator=gen, device=device)
    train_mask = torch.zeros(n, dtype=torch.bool, device=device)
    train_mask[train[:int(traffic["train_nodes"])]] = True
    return Inputs(x=x, labels=labels, train_mask=train_mask)
