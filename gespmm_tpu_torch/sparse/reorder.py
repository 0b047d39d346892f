"""Graph reordering: locality-creating node permutations — port of
``gespmm_tpu/sparse/reorder.py`` (``reorder_permutation``,
``apply_permutation``, ``reorder``, ``inverse_permutation``).

Renumbering nodes so that neighbours get nearby ids narrows each row
block's column window, and is what lets the grouped plan
(``sparse/partition.py::build_grouped_plan``) find the same aligned group of
B rows again and again within a chunk.  A reordering is a symmetric
permutation A' = P·A·Pᵀ computed once, on the host (NumPy and scipy), at
ingest; a model then uses the permuted node order end to end (features,
labels and masks permuted alongside), so results are identical up to the
permutation.

Methods:
  rcm     — reverse Cuthill-McKee (bandwidth minimising; scipy.csgraph)
  degree  — descending degree, a stable sort (hub clustering)
  bfs     — BFS order, each component seeded from its max-degree node
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gespmm_tpu_torch.sparse.formats import CSR

METHODS = ("rcm", "degree", "bfs")


def _to_scipy(csr: CSR):
    import scipy.sparse as sp

    data = (np.ones(csr.nnz, np.float32) if csr.data is None
            else csr.data.cpu().numpy())
    return sp.csr_matrix(
        (data, csr.indices.cpu().numpy(), csr.indptr.cpu().numpy()),
        shape=csr.shape)


def reorder_permutation(csr: CSR, method: str = "rcm") -> np.ndarray:
    """The permutation ``perm`` (new position -> old id) of ``method``."""
    m, n = csr.shape
    if m != n:
        raise ValueError("reordering needs a square adjacency")
    if method == "degree":
        deg = np.diff(csr.indptr.cpu().numpy())
        return np.argsort(-deg, kind="stable")
    A = _to_scipy(csr)
    if method == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        # scipy returns a reversed view; torch.from_numpy needs a copy.
        return np.ascontiguousarray(
            reverse_cuthill_mckee(A, symmetric_mode=True))
    if method == "bfs":
        from scipy.sparse.csgraph import breadth_first_order

        deg = np.diff(A.indptr)
        seen = np.zeros(m, bool)
        order = []
        # Cover all components, seeding each from its max-degree node.
        while len(order) < m:
            remaining = np.flatnonzero(~seen)
            seed = remaining[np.argmax(deg[remaining])]
            nodes = breadth_first_order(A, seed, directed=False,
                                        return_predecessors=False)
            nodes = [v for v in np.asarray(nodes) if not seen[v]]
            seen[np.asarray(nodes)] = True
            order.extend(nodes)
        return np.asarray(order)
    raise ValueError(f"unknown reordering {method!r}; expected one of {METHODS}")


def apply_permutation(csr: CSR, perm: np.ndarray) -> CSR:
    """A' = P·A·Pᵀ with rows and columns renumbered by ``perm`` (new -> old),
    columns sorted within each row; on the host, as a CPU ``CSR``."""
    A = _to_scipy(csr)
    perm = np.asarray(perm)
    Ap = A[perm][:, perm].tocsr()
    Ap.sort_indices()
    return CSR(indptr=torch.from_numpy(Ap.indptr.astype(np.int32)),
               indices=torch.from_numpy(Ap.indices.astype(np.int32)),
               data=None if csr.data is None else torch.from_numpy(Ap.data),
               shape=csr.shape)


def reorder(csr: CSR, method: str = "rcm") -> Tuple[CSR, np.ndarray]:
    """(reordered CSR, perm).  Node data follows as ``x[perm]``; the old
    order comes back with ``inverse_permutation(perm)``."""
    perm = reorder_permutation(csr, method)
    return apply_permutation(csr, perm), perm


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return inv
