"""Benchmark graphs and node-classification fixtures.

Counterpart of ``gespmm_tpu/utils/datasets.py``.  The generators draw from
NumPy with the same ``seed`` and the same sequence of calls, so every array
they return is identical to the JAX package's.  Everything is built on the
host; ``GraphDataset.to(device)`` moves a dataset to the card.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from gespmm_tpu_torch.sparse.formats import COO, CSR, csr_from_coo
from gespmm_tpu_torch.sparse.io import default_dataset_dir, read_mtx_csr


@dataclass
class GraphDataset:
    """A node-classification problem: graph + features + labels + splits."""

    csr: CSR
    features: torch.Tensor
    labels: torch.Tensor
    masks: Dict[str, torch.Tensor]
    num_classes: int
    name: str = ""

    def to(self, device) -> "GraphDataset":
        return GraphDataset(
            csr=self.csr.to(device),
            features=self.features.to(device),
            labels=self.labels.to(device),
            masks={k: v.to(device) for k, v in self.masks.items()},
            num_classes=self.num_classes,
            name=self.name,
        )


def find_graph(name: str, data_dir: Optional[str] = None) -> Optional[str]:
    """Locate ``<name>.mtx`` in the dataset dir (or GESPMM_TPU_DATA)."""
    d = data_dir or default_dataset_dir()
    if not d:
        return None
    path = os.path.join(d, f"{name}.mtx")
    return path if os.path.isfile(path) else None


def load_mtx_graph(name_or_path: str, binary: bool = True) -> CSR:
    path = name_or_path if os.path.isfile(name_or_path) else find_graph(name_or_path)
    if path is None:
        raise FileNotFoundError(
            f"graph {name_or_path!r} not found; set GESPMM_TPU_DATA or pass a path"
        )
    return read_mtx_csr(path, binary=binary)


def _csr_from_sorted(rows: np.ndarray, cols: np.ndarray, shape) -> CSR:
    coo = COO(row=torch.from_numpy(rows.astype(np.int32)),
              col=torch.from_numpy(cols.astype(np.int32)),
              data=None, shape=shape)
    return csr_from_coo(coo)


def rmat_graph(scale: int, edge_factor: int = 16, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               symmetrize: bool = True) -> CSR:
    """R-MAT power-law random graph (Graph500-style), 2^scale nodes."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    ne = n * edge_factor
    rows = np.zeros(ne, np.int64)
    cols = np.zeros(ne, np.int64)
    for bit in range(scale):
        r = rng.random(ne)
        go_right = r > (a + b)
        go_down = ((r > a) & (r <= a + b)) | (r > (a + b + c))
        rows |= go_right.astype(np.int64) << bit
        cols |= go_down.astype(np.int64) << bit
    if symmetrize:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    # Dedup + remove self loops + sort row-major.
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    _, uniq = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    return _csr_from_sorted(rows[order], cols[order], (n, n))


def banded_graph(n: int, bandwidth: int = 8, seed: int = 0) -> CSR:
    """Banded sparse matrix: each row links to its ±bandwidth neighbours (no
    diagonal) — the locality extreme of the corpus, no degree skew."""
    offs = [o for o in range(-bandwidth, bandwidth + 1) if o != 0]
    rows = np.concatenate(
        [np.arange(max(0, -o), min(n, n - o), dtype=np.int64) for o in offs])
    cols = np.concatenate(
        [np.arange(max(0, -o), min(n, n - o), dtype=np.int64) + o
         for o in offs])
    order = np.lexsort((cols, rows))
    return _csr_from_sorted(rows[order], cols[order], (n, n))


def bipartite_graph(m: int, n: int, row_degree: int = 16, seed: int = 0,
                    skew: float = 1.2) -> CSR:
    """Rectangular (m x n) matrix with Zipf-skewed column popularity — the
    corpus' non-square case (user x item)."""
    rng = np.random.default_rng(seed)
    ne = m * row_degree
    rows = np.repeat(np.arange(m, dtype=np.int64), row_degree)
    u = rng.random(ne)
    cols = np.minimum((n * u ** skew).astype(np.int64), n - 1)
    _, uniq = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    return _csr_from_sorted(rows[order], cols[order], (m, n))


def _coo_to_csr(rows: np.ndarray, cols: np.ndarray, shape) -> CSR:
    """Dedup + sort row-major + build the CSR (the generators' shared tail)."""
    m, n = shape
    _, uniq = np.unique(rows.astype(np.int64) * n + cols, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    return _csr_from_sorted(rows[order], cols[order], (m, n))


def chung_lu_graph(n: int, avg_degree: int = 16, gamma: float = 2.3,
                   seed: int = 0) -> CSR:
    """Chung-Lu power-law graph: edge (i, j) drawn ∝ w_i·w_j with weights
    w_i ∝ (i+1)^(-1/(γ-1)), by inverse CDF; symmetric, no self-loops."""
    rng = np.random.default_rng(seed)
    w = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (gamma - 1.0))
    cdf = np.cumsum(w / w.sum())
    ne = n * avg_degree // 2
    rows = np.searchsorted(cdf, rng.random(ne)).astype(np.int64)
    cols = np.searchsorted(cdf, rng.random(ne)).astype(np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    return _coo_to_csr(rows, cols, (n, n))


def grid2d_graph(side: int, stencil: int = 5) -> CSR:
    """2-D grid stencil (side x side nodes, 5- or 9-point, no diagonal):
    uniform degree, neighbours ±side apart in the row order."""
    if stencil not in (5, 9):
        raise ValueError("stencil must be 5 or 9")
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if stencil == 9:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    n = side * side
    ii = np.arange(n, dtype=np.int64)
    x, y = ii // side, ii % side
    rows_l, cols_l = [], []
    for dx, dy in offs:
        ok = (x + dx >= 0) & (x + dx < side) & (y + dy >= 0) & (y + dy < side)
        rows_l.append(ii[ok])
        cols_l.append((x[ok] + dx) * side + (y[ok] + dy))
    return _coo_to_csr(np.concatenate(rows_l), np.concatenate(cols_l), (n, n))


def hub_graph(n: int, n_hubs: int = 4, hub_frac: float = 0.25,
              base_degree: int = 4, seed: int = 0) -> CSR:
    """Extreme hubs: a uniform background of degree ``base_degree`` plus
    ``n_hubs`` nodes each joined to a random ``hub_frac`` of all nodes."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=n * base_degree).astype(np.int64)
    cols = rng.integers(0, n, size=n * base_degree).astype(np.int64)
    hub_ids = rng.choice(n, size=n_hubs, replace=False).astype(np.int64)
    per_hub = int(n * hub_frac)
    for h in hub_ids:
        nbrs = rng.choice(n, size=per_hub, replace=False).astype(np.int64)
        rows = np.concatenate([rows, np.full(per_hub, h, np.int64)])
        cols = np.concatenate([cols, nbrs])
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    return _coo_to_csr(rows, cols, (n, n))


def split_boundary_graph(seg_len: int, hub: int = 10_000, n: int = 12_000,
                         seed: int = 0) -> CSR:
    """A binary n x n graph whose rows 0-4, and columns 0-4, have exactly
    seg_len - 1, seg_len, seg_len + 1, 2·seg_len + 1 and ``hub`` edges (the
    boundaries of ``sparse/partition.py::build_row_split`` at L = seg_len),
    among short rows of 0-4 random edges (many of them empty).  The long
    rows take their columns past row 4 and are mirrored, so row i and column
    i have the same degree.  Not a counterpart of a JAX generator: it tests
    the port's split kernels."""
    if hub > n - 5:
        raise ValueError(f"hub={hub} needs n > hub + 5, got n={n}")
    rng = np.random.default_rng(seed)
    deg = np.array([seg_len - 1, seg_len, seg_len + 1, 2 * seg_len + 1, hub])
    h = deg.shape[0]
    long_r = np.repeat(np.arange(h), deg)
    long_c = np.concatenate([rng.choice(np.arange(h, n), d, replace=False)
                             for d in deg])
    short_r = np.repeat(np.arange(h, n), rng.integers(0, 5, n - h))
    short_c = rng.integers(h, n, short_r.shape[0])
    return _coo_to_csr(np.concatenate([long_r, long_c, short_r]),
                       np.concatenate([long_c, long_r, short_c]), (n, n))


def synth_graph(name: str, seed: int = 0) -> Optional[CSR]:
    """Resolve a synthetic-corpus name to its generator, as the JAX package:

    ``rmat<scale>`` (edge factor 16) | ``banded<n>[-<bw>]`` |
    ``rect<m>x<n>[-<deg>]`` | ``cl<n>[-<deg>]`` (Chung-Lu) |
    ``grid<side>[-<stencil>]`` | ``hub<n>[-<nhubs>]`` | ``sbm<n_per_class>``.
    Returns None for an unknown name.
    """
    if m := re.fullmatch(r"rmat(\d+)", name):
        return rmat_graph(scale=int(m.group(1)), edge_factor=16, seed=seed)
    if m := re.fullmatch(r"banded(\d+)(?:-(\d+))?", name):
        return banded_graph(int(m.group(1)), int(m.group(2) or 8), seed=seed)
    if m := re.fullmatch(r"rect(\d+)x(\d+)(?:-(\d+))?", name):
        return bipartite_graph(int(m.group(1)), int(m.group(2)),
                               int(m.group(3) or 16), seed=seed)
    if m := re.fullmatch(r"cl(\d+)(?:-(\d+))?", name):
        return chung_lu_graph(int(m.group(1)), int(m.group(2) or 16),
                              seed=seed)
    if m := re.fullmatch(r"grid(\d+)(?:-(\d+))?", name):
        return grid2d_graph(int(m.group(1)), int(m.group(2) or 5))
    if m := re.fullmatch(r"hub(\d+)(?:-(\d+))?", name):
        return hub_graph(int(m.group(1)), int(m.group(2) or 4), seed=seed)
    if m := re.fullmatch(r"sbm(\d+)", name):
        return sbm_graph(n_per_class=int(m.group(1)), seed=seed).csr
    return None


def sbm_graph(n_per_class: int = 300, num_classes: int = 4,
              p_in: float = 0.05, p_out: float = 0.002, feat_dim: int = 64,
              signal: float = 1.0, seed: int = 0) -> GraphDataset:
    """Stochastic block model with class-correlated Gaussian features.

    A GCN reaches high accuracy here (homophilous communities), so a broken
    kernel shows up as a collapsed score.
    """
    rng = np.random.default_rng(seed)
    n = n_per_class * num_classes
    labels = np.repeat(np.arange(num_classes), n_per_class)
    rows_l, cols_l = [], []
    for ci in range(num_classes):
        for cj in range(ci, num_classes):
            p = p_in if ci == cj else p_out
            mask = rng.random((n_per_class, n_per_class)) < p
            if ci == cj:
                mask = np.triu(mask, 1)
            r, c = np.nonzero(mask)
            rows_l.append(r + ci * n_per_class)
            cols_l.append(c + cj * n_per_class)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    order = np.lexsort((cols, rows))
    csr = _csr_from_sorted(rows[order], cols[order], (n, n))

    centers = rng.standard_normal((num_classes, feat_dim)) * signal
    feats = centers[labels] + rng.standard_normal((n, feat_dim))
    masks = _split_masks(rng.permutation(n), n, train_frac=0.3)
    return GraphDataset(
        csr=csr,
        features=torch.from_numpy(feats.astype(np.float32)),
        labels=torch.from_numpy(labels.astype(np.int64)),
        masks=masks,
        num_classes=num_classes,
        name=f"sbm_{n}",
    )


def _split_masks(perm: np.ndarray, n: int, train_frac: float):
    n_train, n_val = int(train_frac * n), int(0.2 * n)
    masks = {k: np.zeros(n, bool) for k in ("train", "val", "test")}
    masks["train"][perm[:n_train]] = True
    masks["val"][perm[n_train: n_train + n_val]] = True
    masks["test"][perm[n_train + n_val:]] = True
    return {k: torch.from_numpy(v) for k, v in masks.items()}


def planetoid_style_dataset(name: str = "pubmed", feat_dim: int = 128,
                            num_classes: int = 3, seed: int = 0) -> GraphDataset:
    """Citation graph from ``<name>.mtx`` + synthetic features/labels.

    Labels propagate from random seeds along edges (so they correlate with
    the graph); features are class-correlated Gaussians.
    """
    import scipy.sparse as sp

    csr = load_mtx_graph(name, binary=True)
    n = csr.shape[0]
    rng = np.random.default_rng(seed)
    A = sp.csr_matrix(
        (np.ones(csr.nnz, np.float32), csr.indices.numpy(), csr.indptr.numpy()),
        shape=csr.shape,
    )
    scores = rng.standard_normal((n, num_classes)).astype(np.float32) * 0.1
    seeds = rng.choice(n, size=num_classes * 20, replace=False)
    for i, s in enumerate(seeds):
        scores[s, i % num_classes] += 10.0
    deg = np.maximum(np.asarray(A.sum(1)).ravel(), 1)
    for _ in range(10):
        scores = 0.5 * scores + 0.5 * (A @ scores) / deg[:, None]
    labels = scores.argmax(1)

    centers = rng.standard_normal((num_classes, feat_dim)) * 0.8
    feats = centers[labels] + rng.standard_normal((n, feat_dim))
    masks = _split_masks(rng.permutation(n), n, train_frac=0.1)
    return GraphDataset(
        csr=csr,
        features=torch.from_numpy(feats.astype(np.float32)),
        labels=torch.from_numpy(labels.astype(np.int64)),
        masks=masks,
        num_classes=num_classes,
        name=name,
    )
