"""Sharded edge-space ops — port of ``gespmm_tpu/parallel/edge_ops.py``.

SDDMM, additive attention logits and edge softmax over the same row-slab
``HaloPartition`` as ``halo_spmm``, with the column-side rows arriving
through the same exchange (``halo.make_exchange``).  Per-edge values live in
the stacked per-shard layout that ``halo_spmm``'s runtime values take, a
(L, d_nnz[, H]) diag block and a (L, h_nnz[, H]) halo block for the L local
shards, padded slots exactly 0, so an attention layer composes as

    logits = halo_additive_logits(...)      # or halo_sddmm(...)
    alpha  = halo_edge_softmax(hp, leaky_relu(logits_d), ..., mesh)
    out    = halo_spmm(hp, x, mesh, diag_vals=alpha_d, halo_vals=alpha_h)

In the JAX package these are XLA ops, not Pallas kernels, so plain torch per
shard is their port; autograd derives their backward, the exchange's
included.  Edge softmax needs no exchange: every edge lives on the shard
that owns its destination row.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gespmm_tpu_torch.parallel.halo import HaloPartition, make_exchange
from gespmm_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def _check_rows(hp: HaloPartition, mesh: Mesh, what: str, rows_got,
                per_rows: int, label: str) -> None:
    want = len(mesh.local_shards) * per_rows
    if rows_got != want:
        raise ValueError(f"{what} must be padded to {want} rows ({label}), "
                         f"got {rows_got}; use pad_for_halo()")


def _per_shard(hp: HaloPartition, mesh: Mesh, fn):
    """Stack ``fn(i, p)`` -> (diag, halo) slot values over the local shards,
    each padded to the partition's stack widths."""
    dn, hn = hp.diag_indices.shape[1], hp.halo_indices.shape[1]
    ds, hs = [], []
    for i, p in enumerate(mesh.local_shards):
        d, h = fn(i, p)
        ds.append(_pad_slots(d, dn))
        hs.append(_pad_slots(h, hn))
    return torch.stack(ds), torch.stack(hs)


def _pad_slots(v: Tensor, width: int) -> Tensor:
    pad = width - v.shape[0]
    return v if pad == 0 else torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])


def halo_sddmm(hp: HaloPartition, D1: Tensor, D2: Tensor,
               mesh: Mesh) -> Tuple[Tensor, Tensor]:
    """Sharded SDDMM: out[e] = D1[row_e] · D2[col_e] for every edge.

    D1: the local shards' (L·rpp, K) destination-side rows; D2: their
    (L·cpp, K) source-side rows (``pad_for_halo`` layout).  Returns
    ``(diag_vals, halo_vals)``, (L, d_nnz) / (L, h_nnz), padded slots 0.
    """
    if D1.dim() != 2 or D2.dim() != 2 or D1.shape[1] != D2.shape[1]:
        raise ValueError(f"D1 {tuple(D1.shape)} / D2 {tuple(D2.shape)} must "
                         "be (m,K)/(n,K)")
    _check_rows(hp, mesh, "D1", D1.shape[0], hp.rpp, "num_parts*rpp")
    _check_rows(hp, mesh, "D2", D2.shape[0], hp.cpp, "num_parts*cpp")
    halo = make_exchange(hp, mesh)(D2)
    rpp, cpp = hp.rpp, hp.cpp

    def shard(i, p):
        blk = hp.blocks(p)
        d1 = D1[i * rpp: (i + 1) * rpp]
        d2 = D2[i * cpp: (i + 1) * cpp]
        dv = (d1.index_select(0, blk.d_rows.long())
              * d2.index_select(0, blk.d_indices.long())).sum(-1)
        hv = (d1.index_select(0, blk.h_rows.long())
              * halo[i].index_select(0, blk.h_indices.long())).sum(-1)
        return dv, hv

    return _per_shard(hp, mesh, shard)


def halo_additive_logits(hp: HaloPartition, src_score: Tensor,
                         dst_score: Tensor, mesh: Mesh) -> Tuple[Tensor, Tensor]:
    """Sharded GATv1 additive logits: e = src[row_e] + dst[col_e].

    ``src_score``: (L·rpp,) or (L·rpp, H); ``dst_score``: (L·cpp,) or
    (L·cpp, H) (``pad_for_halo`` layout).  Only the H-wide ``dst_score``
    crosses the exchange.  Returns (L, d_nnz[, H]) / (L, h_nnz[, H]),
    padded slots 0.
    """
    squeeze = src_score.dim() == 1
    s2 = src_score[:, None] if squeeze else src_score
    t2 = dst_score[:, None] if squeeze else dst_score
    _check_rows(hp, mesh, "src scores", s2.shape[0], hp.rpp, "num_parts*rpp")
    _check_rows(hp, mesh, "dst scores", t2.shape[0], hp.cpp, "num_parts*cpp")
    halo = make_exchange(hp, mesh)(t2)
    rpp, cpp = hp.rpp, hp.cpp

    def shard(i, p):
        blk = hp.blocks(p)
        s = s2[i * rpp: (i + 1) * rpp]
        t = t2[i * cpp: (i + 1) * cpp]
        dv = (s.index_select(0, blk.d_rows.long())
              + t.index_select(0, blk.d_indices.long()))
        hv = (s.index_select(0, blk.h_rows.long())
              + halo[i].index_select(0, blk.h_indices.long()))
        return dv, hv

    dv, hv = _per_shard(hp, mesh, shard)
    if squeeze:
        dv, hv = dv[..., 0], hv[..., 0]
    return dv, hv


def halo_edge_softmax(hp: HaloPartition, diag_logits: Tensor,
                      halo_logits: Tensor, mesh: Mesh) -> Tuple[Tensor, Tensor]:
    """Per-destination-row softmax over sharded edge logits, joining each
    row's diag and halo edges; shard-local (no exchange).  Inputs and
    outputs in the stacked layout of ``halo_sddmm`` (with or without a
    trailing head dim); padded slots come back exactly 0, and a row without
    edges gives no value.  Differentiable (the row-max shift is detached).
    """
    squeeze = diag_logits.dim() == 2
    dl = diag_logits[..., None] if squeeze else diag_logits
    hl = halo_logits[..., None] if squeeze else halo_logits
    rpp = hp.rpp

    def shard(i, p):
        blk = hp.blocks(p)
        dn, hn = hp.diag_nnz[p], hp.halo_nnz[p]
        ld, lh = dl[i, :dn], hl[i, :hn]
        rd, rh = blk.d_rows.long(), blk.h_rows.long()
        H = ld.shape[1]
        mx = ld.new_full((rpp, H), float("-inf"))
        with torch.no_grad():
            mx.scatter_reduce_(0, rd[:, None].expand(-1, H), ld, "amax")
            mx.scatter_reduce_(0, rh[:, None].expand(-1, H), lh, "amax")
            mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        exd = torch.exp(ld - mx.index_select(0, rd))
        exh = torch.exp(lh - mx.index_select(0, rh))
        den = ld.new_zeros((rpp, H)).index_add(0, rd, exd).index_add(0, rh, exh)
        # A normal f32 guard, as in the JAX package: only a row whose every
        # logit is -inf reaches it (its weights come back 0).
        den = torch.clamp(den, min=1e-20)
        return (exd / den.index_select(0, rd), exh / den.index_select(0, rh))

    ad, ah = _per_shard(hp, mesh, shard)
    if squeeze:
        ad, ah = ad[..., 0], ah[..., 0]
    return ad, ah


def merge_edge_values(hp: HaloPartition, diag_vals: Tensor,
                      halo_vals: Tensor) -> Tensor:
    """The stacked (P, ...) per-shard edge values back in global CSR edge
    order (the inverse of ``halo.split_edge_values``); differentiable.
    Needs every shard's values (one process, or gathered)."""
    trail = tuple(diag_vals.shape[2:])
    flat = torch.cat([diag_vals.reshape((-1,) + trail),
                      halo_vals.reshape((-1,) + trail)])
    return flat.index_select(0, hp.merge_index)


def halo_gat_attention(hp: HaloPartition, feat: Tensor, a_src: Tensor,
                       a_dst: Tensor, mesh: Mesh, *,
                       negative_slope: float = 0.2) -> Tuple[Tensor, Tensor]:
    """Sharded GAT attention weights from projected features.

    ``feat``: the local shards' (L·cpp, F) projected features (square
    graphs: rpp == cpp, one tensor serves both sides); ``a_src``/``a_dst``:
    (F,) or (F, H).  Returns softmaxed ``(diag_alpha, halo_alpha)``, ready
    for ``halo_spmm``'s runtime edge values: logits, leaky ReLU, softmax, as
    the single-device chain composes them.
    """
    if hp.rpp != hp.cpp:
        raise ValueError("halo_gat_attention needs a square partition "
                         f"(rpp={hp.rpp} != cpp={hp.cpp})")
    dl, hl = halo_additive_logits(hp, feat @ a_src, feat @ a_dst, mesh)
    dl = torch.nn.functional.leaky_relu(dl, negative_slope)
    hl = torch.nn.functional.leaky_relu(hl, negative_slope)
    return halo_edge_softmax(hp, dl, hl, mesh)
