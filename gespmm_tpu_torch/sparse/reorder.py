"""Graph reordering and partitioning: locality-creating node permutations —
port of ``gespmm_tpu/sparse/reorder.py``.

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

The sharded tier's pre-pass: ``fennel_partition`` (streaming cut-reducing
shard labels; the native C++ loop of ``utils/native.py`` when available,
else the NumPy loop, which is the oracle), ``partition_order`` (the
permutation that makes equal row slabs coincide with the shards, with the
exact balancing pass), and the diagnostics ``halo_need_stats`` (the halo
exchange's footprint for the current order) and ``bandwidth_stats``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gespmm_tpu_torch.sparse.formats import CSR
from gespmm_tpu_torch.utils import native

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


PARTITION_METHODS = ("auto", "fennel", "random", "none")


def _host(csr: CSR):
    return (csr.indptr.cpu().numpy().astype(np.int64),
            csr.indices.cpu().numpy())


def fennel_partition(csr: CSR, num_parts: int, *, gamma: float = 1.5,
                     passes: int = 3, seed: int = 0, slack: float = 0.1,
                     use_native: Optional[bool] = None) -> np.ndarray:
    """Streaming cut-reducing node partition (Fennel, restreamed).

    Assigns each node to one of ``num_parts`` shards, greedily maximising
    neighbours already in the shard minus the Fennel load penalty
    α·γ·|S|^(γ-1) (α = √P·nnz/m^1.5), in degree-descending stream order
    (hubs first).  ``passes`` restreams: later passes reconsider every node
    against the previous assignment.  The streaming cap is
    ceil(m/P)·(1+slack), with slack so that a restream can move nodes at
    all (at a hard cap of ceil(m/P) every shard is full after pass one);
    ``partition_order``'s balancing pass restores equal slabs.

    ``use_native``: None runs the native loop when the library is available
    (``utils/native.py``), True demands it, False runs the NumPy loop.  The
    two break score ties differently: the NumPy loop adds a tiny jitter
    drawn from ``np.random.default_rng(seed)``, the native loop takes the
    lowest shard and ignores ``seed``.  Each gives exactly the JAX
    package's labels on the same path.

    Returns labels: (m,) int32 shard id per node (old node id order).
    """
    m, n = csr.shape
    if m != n:
        raise ValueError("partitioning needs a square adjacency")
    P = int(num_parts)
    if P <= 1:
        return np.zeros(m, np.int32)
    indptr, indices = _host(csr)
    if native.wanted(use_native):
        return native.fennel_partition_native(
            np.asarray(indptr, np.int32), np.asarray(indices, np.int32), P,
            gamma=gamma, passes=passes, slack=slack)
    nnz = int(indices.shape[0])
    cap = int(-(-m // P) * (1.0 + max(slack, 0.0))) + 1
    alpha = np.sqrt(P) * nnz / max(m**1.5, 1.0)

    rng = np.random.default_rng(seed)
    deg = np.diff(indptr)
    order = np.argsort(-deg, kind="stable")
    labels = np.full(m, -1, np.int32)
    sizes = np.zeros(P, np.int64)
    jitter = rng.standard_normal(P) * 1e-9  # deterministic tie-breaks
    for _ in range(max(passes, 1)):
        for v in order:
            nbr_labels = labels[indices[indptr[v]:indptr[v + 1]]]
            nbr_labels = nbr_labels[nbr_labels >= 0]
            counts = np.bincount(nbr_labels, minlength=P).astype(np.float64)
            old = labels[v]
            if old >= 0:
                sizes[old] -= 1
            score = counts - alpha * gamma * np.power(
                np.maximum(sizes, 0), gamma - 1.0) + jitter
            score[sizes >= cap] = -np.inf
            p = int(np.argmax(score))
            labels[v] = p
            sizes[p] += 1
    return labels


def _attachment(indptr: np.ndarray, indices: np.ndarray, labels: np.ndarray,
                cand: np.ndarray, p: int) -> np.ndarray:
    """For each node of ``cand``, how many of its neighbours carry label
    ``p`` (the JAX package's per-node generator, in one vectorised pass)."""
    starts = indptr[cand]
    lens = indptr[cand + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(cand.size, np.int64)
    first = np.cumsum(lens) - lens
    pos = np.arange(total) + np.repeat(starts - first, lens)
    owner = np.repeat(np.arange(cand.size), lens)
    hit = labels[indices[pos]] == p
    return np.bincount(owner[hit], minlength=cand.size).astype(np.int64)


def partition_order(csr: CSR, num_parts: int, *, method: str = "auto",
                    seed: int = 0, **kwargs) -> np.ndarray:
    """Permutation (new position -> old node id) grouping nodes by shard.

    Apply with ``apply_permutation``: the permuted matrix's equal row slabs
    of ceil(m/P) rows then coincide with the computed shards, so
    ``parallel/halo.py::build_halo_partition(num_parts)`` inherits the cut
    reduction.  Node data follows as ``x[perm]``.

    method:
      "fennel" — streaming cut minimisation (``fennel_partition``, with
        ``kwargs``), then the exact balancing pass;
      "random" — uniform hashed placement from ``default_rng(seed)``: on
        structureless power-law graphs (R-MAT) it evens out the pair needs
        of the padded exchange although it maximises the edge cut;
      "auto" — score the identity, both Fennel variants (``slack`` 0.1 and
        0, unless ``kwargs`` fixes it) and "random" with
        ``halo_need_stats`` and return the smallest padded footprint
        (ragged footprint breaking near-ties), so never worse than "none";
      "none" — the identity (the naive slab split).
    """
    m = csr.shape[0]
    P = int(num_parts)
    if method == "auto":
        cands = {"none": np.arange(m)}
        cands["fennel"] = partition_order(csr, P, method="fennel", seed=seed,
                                          **kwargs)
        if "slack" not in kwargs:
            cands["fennel0"] = partition_order(csr, P, method="fennel",
                                               seed=seed, slack=0.0, **kwargs)
        rng = np.random.default_rng(seed)
        cands["random"] = np.argsort(rng.permutation(m) % P, kind="stable")
        best, best_fp = None, np.inf
        for perm in cands.values():
            st = halo_need_stats(apply_permutation(csr, perm), P)
            fp = st["footprint_frac"] + 1e-3 * st["ragged_frac"]
            if fp < best_fp:
                best, best_fp = perm, fp
        return best
    if method == "fennel":
        labels = fennel_partition(csr, P, seed=seed, **kwargs)
    elif method == "random":
        rng = np.random.default_rng(seed)
        return np.argsort(rng.permutation(m) % P, kind="stable")
    elif method == "none":
        return np.arange(m)
    else:
        raise ValueError(f"unknown partition method {method!r}")
    cap = -(-m // P)
    indptr, indices = _host(csr)

    # Exact balancing: shards 0..P-2 must hold exactly cap nodes for the
    # slab boundaries to land on multiples of cap.  Oversize: evict the
    # least-p-attached nodes to the next shard (cascading right).
    # Undersize: steal the most-p-attached nodes from the next shards.
    sizes = np.bincount(labels, minlength=P)
    for p in range(P - 1):
        excess = int(sizes[p]) - cap
        if excess > 0:
            cand = np.flatnonzero(labels == p)
            att = _attachment(indptr, indices, labels, cand, p)
            move = cand[np.argsort(att, kind="stable")[:excess]]
            labels[move] = p + 1
            sizes[p] -= move.size
            sizes[p + 1] += move.size
        deficit = cap - int(sizes[p])
        q = p + 1
        while deficit > 0 and q < P:
            cand = np.flatnonzero(labels == q)
            if cand.size == 0:
                q += 1
                continue
            att = _attachment(indptr, indices, labels, cand, p)
            take = cand[np.argsort(-att, kind="stable")[:deficit]]
            labels[take] = p
            sizes[p] += take.size
            sizes[q] -= take.size
            deficit -= take.size
            if sizes[q] == 0:
                q += 1
    return np.argsort(labels, kind="stable")


def halo_need_stats(csr: CSR, num_parts: int) -> dict:
    """Per-pair halo need-set sizes for equal row slabs of the current node
    order (what ``build_halo_partition`` would see).

    Returns {"need": (P, P) array of the unique remote columns shard p needs
    from owner q, "H": the largest pair, "footprint_frac": (cpp + P·H8)/n
    with H8 the 8-aligned largest pair (the padded exchange's footprint),
    "ragged_frac": (cpp + max over p of Σ_q need[p, q])/n (the footprint of
    an exchange sized pair by pair)}.
    """
    indptr, indices = _host(csr)
    m, n = csr.shape
    P = int(num_parts)
    rpp = -(-m // P)
    cpp = -(-n // P)
    need = np.zeros((P, P), np.int64)
    for p in range(P):
        s, e = indptr[min(p * rpp, m)], indptr[min((p + 1) * rpp, m)]
        cols = indices[s:e]
        owner = cols // cpp
        for q in np.unique(owner):
            if q == p:
                continue
            need[p, q] = np.unique(cols[owner == q]).size
    H = int(need.max())
    H8 = -(-max(H, 1) // 8) * 8
    ragged_rows = int(need.sum(axis=1).max())
    return {
        "need": need,
        "H": H,
        "footprint_frac": (cpp + P * H8) / max(n, 1),
        "ragged_frac": (cpp + ragged_rows) / max(n, 1),
    }


def bandwidth_stats(csr: CSR, rows_per_block: int = 64) -> dict:
    """Locality diagnostics: the matrix bandwidth and the column span of
    each block of ``rows_per_block`` rows."""
    indptr, indices = _host(csr)
    m = csr.shape[0]
    rows = np.repeat(np.arange(m), np.diff(indptr))
    bw = int(np.abs(rows - indices).max()) if indices.size else 0
    spans = []
    for b in range(0, m, rows_per_block):
        s, e = indptr[b], indptr[min(b + rows_per_block, m)]
        if e > s:
            spans.append(int(indices[s:e].max() - indices[s:e].min() + 1))
    spans = np.asarray(spans) if spans else np.zeros(1, int)
    return {
        "bandwidth": bw,
        "block_span_mean": float(spans.mean()),
        "block_span_p90": float(np.percentile(spans, 90)),
        "block_span_max": int(spans.max()),
    }
