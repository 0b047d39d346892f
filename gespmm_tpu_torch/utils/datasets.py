"""Benchmark graphs and node-classification fixtures.

Counterpart of ``gespmm_tpu/utils/datasets.py``.  The generators draw from
NumPy with the same ``seed`` and the same sequence of calls, so every array
they return is identical to the JAX package's.  Everything is built on the
host; ``GraphDataset.to(device)`` moves a dataset to the card.
"""

from __future__ import annotations

import os
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
