"""Graph-level ops on the SpMM primitive — port of part of ``gespmm_tpu/ops/graph.py``.

Ported so far: degree normalisation, the symmetric-normalised GCN
aggregation, the GraphSAGE aggregates and self-loop insertion.  Edge
softmax and attention wait for their ROADMAP item (A6).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.sparse.formats import CSR, in_degrees, out_degrees

Tensor = torch.Tensor


def degree_norm(adj, power: float = -0.5, eps: float = 0.0):
    """(out_norm, in_norm): per-node degree**power with 0-degree clamped to 1."""
    csr = adj.csr if isinstance(adj, Adjacency) else adj
    dout = torch.clamp(out_degrees(csr).to(torch.float32), min=1.0) + eps
    din = torch.clamp(in_degrees(csr).to(torch.float32), min=1.0) + eps
    return dout ** power, din ** power


def gcn_aggregate(adj: Adjacency, x: Tensor, *, out_norm: Optional[Tensor] = None,
                  in_norm: Optional[Tensor] = None, method: str = "auto") -> Tensor:
    """Symmetric-normalised GCN aggregation: D_out^-1/2 · A · D_in^-1/2 · x.

    Pre-scale by the source-side norm, SpMM, post-scale by the
    destination-side norm; pass precomputed norms to amortise them.
    """
    if out_norm is None or in_norm is None:
        o, i = degree_norm(adj)
        out_norm = o if out_norm is None else out_norm
        in_norm = i if in_norm is None else in_norm
    x = x * in_norm[:, None].to(x.dtype)
    agg = spmm(adj, x, reduce="sum", method=method)
    return agg * out_norm[:, None].to(agg.dtype)


def sage_aggregate(adj: Adjacency, x: Tensor, *, aggregator: str = "mean",
                   method: str = "auto") -> Tensor:
    """Neighbourhood aggregation for GraphSAGE.

    aggregator:
      "mean": mean of neighbour features (SpMM mean-reduce).
      "gcn":  symmetric-norm aggregation including self (caller adds loops).
      "pool": elementwise max of neighbour features (SpMM max-reduce) — the
              caller applies the pre-pool MLP, per SAGEConv semantics.
      "sum":  plain sum.
    """
    if aggregator == "mean":
        return spmm(adj, x, reduce="mean", method=method)
    if aggregator == "sum":
        return spmm(adj, x, reduce="sum", method=method)
    if aggregator == "pool":
        return spmm(adj, x, reduce="max", method=method)
    if aggregator == "gcn":
        return gcn_aggregate(adj, x, method=method)
    raise ValueError(f"unknown aggregator {aggregator!r}")


def add_self_loops(csr: CSR, weight: float = 1.0) -> CSR:
    """Host-side A + weight·I (existing diagonal entries are replaced).

    The result always carries explicit values (1.0 for a binary input), so
    the SpMM downstream runs its valued path.  The tensors come back on the
    device ``csr`` lives on.
    """
    m, n = csr.shape
    if m != n:
        raise ValueError("self-loops need a square matrix")
    indptr = csr.indptr.cpu().numpy()
    indices = csr.indices.cpu().numpy()
    data = (np.ones(indices.shape[0], np.float32) if csr.data is None
            else csr.data.cpu().numpy())
    rows = np.repeat(np.arange(m), np.diff(indptr))
    keep = rows != indices
    rows = np.concatenate([rows[keep], np.arange(m)])
    cols = np.concatenate([indices[keep], np.arange(m)])
    vals = np.concatenate([data[keep], np.full(m, weight, data.dtype)])
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=m)
    new_indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return CSR(
        indptr=torch.from_numpy(new_indptr),
        indices=torch.from_numpy(cols.astype(np.int32)),
        data=torch.from_numpy(np.ascontiguousarray(vals)),
        shape=(m, n),
    ).to(csr.device)
