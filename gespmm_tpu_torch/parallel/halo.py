"""Halo-exchange sharded SpMM — port of ``gespmm_tpu/parallel/halo.py``.

Rows are cut into P equal slabs.  Shard p owns output rows [p·rpp, (p+1)·rpp)
and B rows [p·cpp, (p+1)·cpp), and needs from the other shards only the B
rows its edges touch.  A host pre-pass (``build_halo_partition``) computes,
per pair (q → p), the sorted unique set of those rows, a ragged schedule of
rounds (round r ships shard q's rows to shard (q+r) % P, padded to that
round's own largest set, 8-aligned), and each shard's two blocks:

  A_p = [A_diag | A_halo]
  * A_diag: the columns p owns, remapped to the local B shard [0, cpp);
  * A_halo: the other columns, remapped into the received halo table
    [0, Σ_r H_r) at (round offset + rank in the need set).
  out_p = A_diag @ B_p  (joined with)  A_halo @ halo_p

The arrays equal the JAX package's.  The TPU's per-shard stream plans (their
sizes came from VMEM) are not ported: on Hopper the blocks are stacked CSRs
that kernel row 7 (``kernels/halo_spmm.py``) walks directly, one launch over
all the shards a process holds.  The host pre-pass also builds each block's
transpose (a colptr, the row ids and the map from CSC order to the block's
edge order), which the backward walks, and the row 7 split of the joint
blocks and of each transposed block (rows longer than L edges cut into
segments, ``sparse/partition.py::build_shard_split``).

``halo_spmm`` takes every reduction: sum/mean, and max/min with JOINT tie
counts across the two blocks (the gradient splits evenly among all the
edges of a row that achieve its extremum, as ``jnp.max``'s VJP does).
Runtime edge values, one per edge or one per head, are differentiable.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gespmm_tpu_torch.kernels import halo_spmm as khalo
from gespmm_tpu_torch.kernels.spmm_minmax import spmm_minmax_vjp_stacked
from gespmm_tpu_torch.ops import reference as ref
from gespmm_tpu_torch.parallel.mesh import Mesh, model_replicated
from gespmm_tpu_torch.sparse.formats import CSR
from gespmm_tpu_torch.sparse.partition import (SPLIT_LEN, ShardSplit,
                                                build_shard_split)

Tensor = torch.Tensor

REDUCES = ("sum", "mean", "max", "min")
METHODS = ("auto", "tiled", "xla")


class ShardBlocks(NamedTuple):
    """One shard's two blocks and their transposes, cut to their nonzeros
    (views of the stacked arrays of a ``HaloPartition``)."""

    d_indptr: Tensor
    d_indices: Tensor
    d_rows: Tensor  # the local output row of each diag edge
    d_t_indptr: Tensor  # (cpp + 1,) colptr of A_diag
    d_t_rows: Tensor  # CSC order: the output row of each edge
    d_t_map: Tensor  # CSC order -> the block's edge order
    h_indptr: Tensor
    h_indices: Tensor
    h_rows: Tensor
    h_t_indptr: Tensor  # (halo_rows + 1,)
    h_t_rows: Tensor
    h_t_map: Tensor


@dataclasses.dataclass(frozen=True)
class HaloPartition:
    """Row-slab partition with per-shard diag/halo splits and the ragged
    exchange schedule.

    The fields of the JAX ``HaloPartition`` (P shards):
      send_idx:  (P, ΣH_r) int32 — shard q's B-shard-local rows to send,
                 concatenated per round (pad -> 0); round r's slice goes to
                 shard (q+r) % P.
      diag_*:    per-shard CSR over local columns [0, cpp): indptr (P, rpp+1),
                 indices, data (f32 or None), mask, src (P, max_nnz).
      halo_*:    per-shard CSR over the received halo table [0, ΣH_r).
      diag_src / halo_src: the global CSR edge id of each local edge
                 (sentinel -1).
      deg:       (P, rpp) f32 — the TOTAL row degree (for mean).
      shape, rpp, cpp, rounds ((r, H_r) per nonzero round).
    ``tiled``: whether ``method="auto"`` takes the kernel tier (the TPU
    package built its stream plans then; the port builds none).
    The port's own, built on the host too: ``diag_nnz``/``halo_nnz`` (each
    shard's edge counts), ``diag_row_ids``/``halo_row_ids`` (the local row
    of each edge), each block's transpose (``*_t_indptr``, ``*_t_rows``,
    ``*_t_map``: CSC order -> edge order), ``halo_gather`` ((P, halo_rows)
    int64: the global B row of each halo-table row, the one-process
    exchange), ``merge_index`` (the position of each global edge in the
    flattened [diag | halo] stacks) and row 7's work lists: ``joint_split``
    (the rows of [A_diag | A_halo], diag edges first), ``diag_t_split`` and
    ``halo_t_split`` (the rows of each transpose), split at L = ``seg_len``.
    """

    send_idx: Tensor
    diag_indptr: Tensor
    diag_indices: Tensor
    diag_data: Optional[Tensor]
    diag_mask: Tensor
    diag_src: Tensor
    halo_indptr: Tensor
    halo_indices: Tensor
    halo_data: Optional[Tensor]
    halo_mask: Tensor
    halo_src: Tensor
    deg: Tensor
    shape: Tuple[int, int]
    rpp: int
    cpp: int
    rounds: Tuple[Tuple[int, int], ...]
    tiled: bool
    diag_nnz: Tuple[int, ...]
    halo_nnz: Tuple[int, ...]
    diag_row_ids: Tensor
    halo_row_ids: Tensor
    diag_t_indptr: Tensor
    diag_t_rows: Tensor
    diag_t_map: Tensor
    halo_t_indptr: Tensor
    halo_t_rows: Tensor
    halo_t_map: Tensor
    halo_gather: Tensor
    merge_index: Tensor
    joint_split: ShardSplit
    diag_t_split: ShardSplit
    halo_t_split: ShardSplit

    @property
    def num_parts(self) -> int:
        return int(self.send_idx.shape[0])

    @property
    def H(self) -> int:
        """Largest per-round (= per-pair, 8-aligned) halo block."""
        return max((h for _, h in self.rounds), default=0)

    @property
    def halo_rows(self) -> int:
        """Halo-table rows per shard — the communicated footprint,
        Σ_r H_r (at least 8)."""
        return max(sum(h for _, h in self.rounds), 8)

    @property
    def footprint_fraction(self) -> float:
        """(local + halo) rows / total rows — 1/P + halo share."""
        return (self.cpp + self.halo_rows) / max(self.shape[1], 1)

    @property
    def nnz(self) -> int:
        return sum(self.diag_nnz) + sum(self.halo_nnz)

    def blocks(self, p: int) -> ShardBlocks:
        """Shard p's blocks and transposes, cut to its nonzeros."""
        dn, hn = self.diag_nnz[p], self.halo_nnz[p]
        return ShardBlocks(
            self.diag_indptr[p], self.diag_indices[p, :dn],
            self.diag_row_ids[p, :dn], self.diag_t_indptr[p],
            self.diag_t_rows[p, :dn], self.diag_t_map[p, :dn],
            self.halo_indptr[p], self.halo_indices[p, :hn],
            self.halo_row_ids[p, :hn], self.halo_t_indptr[p],
            self.halo_t_rows[p, :hn], self.halo_t_map[p, :hn])


def _transpose_local(indices, rows_out, rows_of_edge):
    """CSC ordering of a local block (host): (colptr, row ids, map) with
    ``rows_out`` columns; the map takes CSC order to the block's edge order
    (``gespmm_tpu/parallel/halo.py::_transpose_local``)."""
    order = np.argsort(indices, kind="stable")
    ptr_t = np.zeros(rows_out + 1, np.int64)
    np.add.at(ptr_t, indices + 1, 1)
    return (np.cumsum(ptr_t).astype(np.int32),
            rows_of_edge[order].astype(np.int32), order.astype(np.int32))


def build_halo_partition(csr: CSR, num_parts: int, *, tiled: bool = True,
                         device=None,
                         seg_len: int = SPLIT_LEN) -> HaloPartition:
    """Host pre-pass: slab rows, split columns by ownership, compute the
    ragged per-round halo schedule, remap, transpose each block, and cut
    the rows of more than ``seg_len`` edges of the joint blocks and of the
    transposes into row 7's segments; the result lives on ``device``
    (default: the device ``csr`` lives on).

    ``tiled=True`` makes ``halo_spmm(method="auto")`` take the kernel tier
    (kernel row 7 on the card), as the JAX package's tiled partitions do;
    ``tiled=False`` makes it take the plain "xla" tier.
    """
    device = csr.device if device is None else torch.device(device)
    indptr = csr.indptr.cpu().numpy()
    indices = csr.indices.cpu().numpy()
    data = None if csr.data is None else csr.data.cpu().numpy()
    m, n = csr.shape
    Pn = num_parts
    rpp = -(-m // Pn)
    cpp = -(-n // Pn)
    rows_all = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr))

    # Pass 1: per shard, split edges and collect need-sets.
    shard_edges = []  # (lrows, cols, vals, owner, gids) for each shard
    need = [[None] * Pn for _ in range(Pn)]  # need[p][q] sorted unique cols
    for p in range(Pn):
        r0, r1 = p * rpp, min((p + 1) * rpp, m)
        s, e = int(indptr[min(r0, m)]), int(indptr[min(r1, m)])
        cols = indices[s:e]
        owner = cols // cpp
        shard_edges.append((rows_all[s:e] - r0, cols,
                            None if data is None else data[s:e], owner,
                            np.arange(s, e, dtype=np.int32)))
        for q in range(Pn):
            if q != p:
                need[p][q] = np.unique(cols[owner == q])

    # Ragged round schedule: round r ships q -> (q+r)%P; its size is the
    # max need over the P pairs IN THAT ROUND only (8-aligned).
    rounds: List[Tuple[int, int]] = []
    for r in range(1, Pn):
        Hr = max((len(need[(q + r) % Pn][q]) for q in range(Pn)), default=0)
        if Hr > 0:
            rounds.append((r, -(-Hr // 8) * 8))
    round_off, off = {}, 0
    for r, h in rounds:
        round_off[r] = off
        off += h
    halo_tbl_rows = max(off, 8)

    send_idx = np.zeros((Pn, max(off, 1)), np.int32)
    for q in range(Pn):
        for r, h in rounds:
            cq = need[(q + r) % Pn][q]
            send_idx[q, round_off[r]: round_off[r] + len(cq)] = cq - q * cpp

    # The one-process exchange: shard p's round-r rows come from shard
    # q = (p - r) % P, in round order (the halo CSR's column layout).
    halo_gather = np.zeros((Pn, halo_tbl_rows), np.int64)
    for p in range(Pn):
        for r, h in rounds:
            q = (p - r) % Pn
            o = round_off[r]
            halo_gather[p, o: o + h] = q * cpp + send_idx[q, o: o + h]

    # Pass 2: the local diag/halo CSRs and their transposes.
    def local_block(lrows, lcols, lvals, lgids, cols_out):
        counts = np.bincount(lrows, minlength=rpp)
        lp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        lcols = lcols.astype(np.int32)
        return (lp, lcols, lvals, lgids, lrows.astype(np.int32),
                _transpose_local(lcols, cols_out, lrows))

    deg = np.zeros((Pn, rpp), np.float32)
    diag_blocks, halo_blocks = [], []
    for p in range(Pn):
        lrows, cols, vals, owner, gids = shard_edges[p]
        np.add.at(deg[p], lrows, 1.0)
        is_diag = owner == p
        order = np.argsort(lrows[is_diag], kind="stable")  # rows sorted
        diag_blocks.append(local_block(
            lrows[is_diag][order], (cols - p * cpp)[is_diag][order],
            None if vals is None else vals[is_diag][order],
            gids[is_diag][order], cpp))
        # halo block: remap remote cols to round_offset + rank
        hr, hc_g, ho = lrows[~is_diag], cols[~is_diag], owner[~is_diag]
        hc = np.zeros_like(hc_g)
        for q in range(Pn):
            sel = ho == q
            if q != p and sel.any():
                hc[sel] = round_off[(p - q) % Pn] + np.searchsorted(
                    need[p][q], hc_g[sel])
        order = np.argsort(hr, kind="stable")
        halo_blocks.append(local_block(
            hr[order], hc[order],
            None if vals is None else vals[~is_diag][order],
            gids[~is_diag][order], halo_tbl_rows))

    def stack(blocks, has_data):
        """The padded (P, max_nnz) stacks of the JAX package, plus the
        port's row ids and transposes."""
        max_nnz = max(max(b[1].shape[0] for b in blocks), 1)
        t_rows = blocks[0][5][0].shape[0]
        ip = np.zeros((Pn, rpp + 1), np.int32)
        ii = np.zeros((Pn, max_nnz), np.int32)
        msk = np.zeros((Pn, max_nnz), bool)
        gsr = np.full((Pn, max_nnz), -1, np.int32)
        dd = np.zeros((Pn, max_nnz), np.float32) if has_data else None
        rid = np.zeros((Pn, max_nnz), np.int32)
        tp = np.zeros((Pn, t_rows), np.int32)
        tr = np.zeros((Pn, max_nnz), np.int32)
        tm = np.zeros((Pn, max_nnz), np.int32)
        for p, (lp, li, ld, lg, lr, (ptr_t, rows_t, map_t)) in enumerate(blocks):
            k = li.shape[0]
            ip[p] = lp
            ii[p, :k], msk[p, :k], gsr[p, :k], rid[p, :k] = li, True, lg, lr
            if dd is not None:
                dd[p, :k] = ld
            tp[p], tr[p, :k], tm[p, :k] = ptr_t, rows_t, map_t
        nnz = tuple(int(b[1].shape[0]) for b in blocks)
        return ip, ii, dd, msk, gsr, rid, tp, tr, tm, nnz

    has_data = data is not None
    (dip, dii, did, dim_, dsr, drid, dtp, dtr, dtm,
     d_nnz) = stack(diag_blocks, has_data)
    (hip, hii, hid, him, hsr, hrid, htp, htr, htm,
     h_nnz) = stack(halo_blocks, has_data)
    # merge_edge_values: global edge e sits at merge_index[e] of the
    # flattened [diag | halo] stacks.
    nnz = int(indptr[-1])
    merge_index = np.zeros(nnz, np.int64)
    for stack_src, base in ((dsr, 0), (hsr, dsr.size)):
        flat = stack_src.reshape(-1)
        valid = np.nonzero(flat >= 0)[0]
        merge_index[flat[valid]] = base + valid

    def dev(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)

    return HaloPartition(
        send_idx=dev(send_idx), diag_indptr=dev(dip), diag_indices=dev(dii),
        diag_data=dev(did), diag_mask=dev(dim_), diag_src=dev(dsr),
        halo_indptr=dev(hip), halo_indices=dev(hii), halo_data=dev(hid),
        halo_mask=dev(him), halo_src=dev(hsr), deg=dev(deg), shape=(m, n),
        rpp=rpp, cpp=cpp, rounds=tuple(rounds), tiled=tiled,
        diag_nnz=d_nnz, halo_nnz=h_nnz, diag_row_ids=dev(drid),
        halo_row_ids=dev(hrid), diag_t_indptr=dev(dtp),
        diag_t_rows=dev(dtr), diag_t_map=dev(dtm), halo_t_indptr=dev(htp),
        halo_t_rows=dev(htr), halo_t_map=dev(htm),
        halo_gather=dev(halo_gather), merge_index=dev(merge_index),
        joint_split=build_shard_split(dip, hip, seg_len).to(device),
        diag_t_split=build_shard_split(dtp, None, seg_len).to(device),
        halo_t_split=build_shard_split(htp, None, seg_len).to(device))


def split_edge_values(hp: HaloPartition, vals: Tensor):
    """Split global CSR-ordered edge values, (nnz,) or per-head (nnz, H),
    into the stacked (diag_vals, halo_vals) the halo op takes, padded slots
    0.  Differentiable (a gather)."""
    out = []
    for src in (hp.diag_src, hp.halo_src):
        valid = src >= 0
        v = vals.index_select(0, torch.clamp(src, min=0).reshape(-1).long())
        v = v.reshape(src.shape + vals.shape[1:])
        mask = valid if vals.dim() == 1 else valid[..., None]
        out.append(v * mask.to(v.dtype))
    return tuple(out)


def pad_for_halo(hp: HaloPartition, X: Tensor) -> Tensor:
    """Pad a node-indexed tensor to num_parts*cpp rows (B-side layout)."""
    pad = hp.num_parts * hp.cpp - X.shape[0]
    if pad < 0:
        raise ValueError(f"array has {X.shape[0]} rows > {hp.num_parts * hp.cpp}")
    if pad == 0:
        return X
    return torch.cat([X, X.new_zeros((pad,) + tuple(X.shape[1:]))])


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------


def _round_offsets(hp: HaloPartition):
    offsets, off = [], 0
    for r, h in hp.rounds:
        offsets.append((r, off, h))
        off += h
    return offsets


class _Rounds(torch.autograd.Function):
    """The ragged rounds between ranks: forward ships each round's rows of
    ``B_shard[send_idx]`` to (rank + r) % P and receives from (rank − r) % P;
    backward runs the rounds reversed and scatter-adds into grad_B_shard.
    Every rank posts the rounds in the same order."""

    @staticmethod
    def forward(ctx, B_shard, hp, mesh):
        send = hp.send_idx[mesh.local_shards[0]].long()
        ctx.hp, ctx.mesh, ctx.rows = hp, mesh, B_shard.shape[0]
        ctx.save_for_backward(send)
        req = B_shard.index_select(0, send)
        out = B_shard.new_zeros((hp.halo_rows, B_shard.shape[1]))
        _post(mesh, hp, req, out, reverse=False)
        return out

    @staticmethod
    def backward(ctx, g):
        (send,) = ctx.saved_tensors
        g = g.contiguous()
        grad_req = g.new_zeros((send.shape[0], g.shape[1]))
        _post(ctx.mesh, ctx.hp, g, grad_req, reverse=True)
        grad = g.new_zeros((ctx.rows, g.shape[1]))
        return grad.index_add_(0, send, grad_req), None, None


def _post(mesh: Mesh, hp: HaloPartition, src: Tensor, dst: Tensor,
          reverse: bool) -> None:
    """One isend and one irecv a round over the data group (the rank's
    model column), batched; the backward sends each round's rows back
    whence they came."""
    P, shard = mesh.data, mesh.local_shards[0]
    ops = []
    for r, o, h in _round_offsets(hp):
        to, frm = (shard + r) % P, (shard - r) % P
        if reverse:
            to, frm = frm, to
        ops.append(dist.P2POp(dist.isend, src[o: o + h], mesh.global_rank(to),
                              mesh.data_group))
        ops.append(dist.P2POp(dist.irecv, dst[o: o + h],
                              mesh.global_rank(frm), mesh.data_group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def make_exchange(hp: HaloPartition, mesh: Mesh):
    """The halo exchange: ``exchange(B_local)`` returns the halo tables of
    the local shards, (len(mesh.local_shards), halo_rows, K), in round
    order — exactly the halo CSR's column layout.  Without a group, one
    ``index_select`` over the whole padded B (autograd transposes it); with
    a group, the point-to-point rounds of ``_Rounds``.  Shared by
    ``halo_spmm`` and the sharded edge ops (``parallel/edge_ops.py``), so
    that every op rides the same schedule.  Differentiable."""

    def exchange(B_local: Tensor) -> Tensor:
        L, K = len(mesh.local_shards), B_local.shape[1]
        if not hp.rounds:
            return B_local.new_zeros((L, hp.halo_rows, K))
        if mesh.group is None:
            return B_local.index_select(0, hp.halo_gather.reshape(-1)).reshape(
                L, hp.halo_rows, K)
        return _Rounds.apply(B_local, hp, mesh)[None]

    return exchange


# ---------------------------------------------------------------------------
# The runtime op
# ---------------------------------------------------------------------------


def _gather_dot(rows: Tensor, cols: Tensor, g: Tensor, table: Tensor,
                heads: int) -> Tensor:
    """grad_val[e] = Σ_k g[rows_e, k]·table[cols_e, k], per head block (the
    per-slot SDDMM of ``_local_tiled_bwd``), in f32."""
    prod = (g.index_select(0, rows.long()).float()
            * table.index_select(0, cols.long()).float())
    if heads == 1:
        return prod.sum(-1)
    return prod.view(prod.shape[0], heads, -1).sum(-1)


def _csc_vals(vals: Optional[Tensor], t_map: Tensor) -> Optional[Tensor]:
    """Stacked (n, stride[, H]) values in each shard's CSC order."""
    if vals is None:
        return None
    idx = t_map.long()
    if vals.dim() == 3:
        idx = idx[..., None].expand(-1, -1, vals.shape[2])
    return torch.gather(vals, 1, idx)


def _from_csc(grad_csc: Tensor, t_map: Tensor, mask: Tensor) -> Tensor:
    """Stacked (n, stride) values in each shard's CSC order back to its
    edge order.  A shard's edges are a prefix in both orders (``mask``);
    its padded slots land in a sink slot that is dropped."""
    n, stride = grad_csc.shape
    shard = torch.arange(n, device=grad_csc.device)[:, None] * stride
    dst = torch.where(mask, shard + t_map.long(),
                      torch.full((), n * stride, device=grad_csc.device))
    flat = grad_csc.new_zeros(n * stride + 1)
    flat.index_copy_(0, dst.reshape(-1), grad_csc.reshape(-1))
    return flat[:-1].view(n, stride)


def _stacked_gather_dot(row_ids: Tensor, indices: Tensor, mask: Tensor,
                        g: Tensor, table: Tensor, heads: int) -> Tensor:
    """``_gather_dot`` over stacked (n, stride) blocks: shard i's edges take
    its slabs of ``g`` and ``table``; padded slots give 0."""
    n, stride = row_ids.shape
    shard = torch.arange(n, device=g.device)[:, None]
    table = table.reshape(-1, table.shape[-1])
    rows = row_ids.long() + shard * (g.shape[0] // n)
    cols = indices.long() + shard * (table.shape[0] // n)
    gv = _gather_dot(rows.reshape(-1), cols.reshape(-1), g, table, heads)
    gv = gv.view(n, stride, heads) if heads > 1 else gv.view(n, stride)
    return gv * (mask[..., None] if heads > 1 else mask).to(gv.dtype)


class _HaloShards(torch.autograd.Function):
    """The kernel tier over the local shards [lo, hi): row 7 forward, one
    launch over all of them (and its carry where the joint split has a
    segment).  The sum backward is row 7 over the stacked diag^T blocks and
    over the stacked halo^T blocks (two launches, each with its split's
    carry); the max/min backward row 3 over the same stacked blocks with
    the joint out and ties (two launches, each with its split's carry)."""

    @staticmethod
    def forward(ctx, hp: HaloPartition, lo: int, hi: int, reduce: str, dv,
                hv, B_local, halo):
        loc = slice(lo, hi)
        out, ties = khalo.halo_spmm_stacked(
            hp.diag_indptr[loc], hp.diag_indices[loc], dv, B_local,
            hp.halo_indptr[loc], hp.halo_indices[loc], hv, halo, reduce,
            split=hp.joint_split, first=lo)
        ctx.hp, ctx.lo, ctx.hi, ctx.reduce = hp, lo, hi, reduce
        ctx.save_for_backward(dv, hv, B_local, halo, out, ties)
        return out

    @staticmethod
    def backward(ctx, g):
        hp, lo, hi, reduce = ctx.hp, ctx.lo, ctx.hi, ctx.reduce
        dv, hv, B_local, halo, out, ties = ctx.saved_tensors
        g = g.contiguous()
        loc = slice(lo, hi)
        want_vals = ctx.needs_input_grad[4] or ctx.needs_input_grad[5]
        grads = []
        for blk, vals, table, split in (
                ("diag", dv, B_local, hp.diag_t_split),
                ("halo", hv, halo, hp.halo_t_split)):
            t_indptr = getattr(hp, f"{blk}_t_indptr")[loc]
            t_rows = getattr(hp, f"{blk}_t_rows")[loc]
            t_map = getattr(hp, f"{blk}_t_map")[loc]
            tvals = _csc_vals(vals, t_map)
            grad_v = None
            if reduce == "sum":
                grad_t, _ = khalo.halo_spmm_stacked(t_indptr, t_rows, tvals,
                                                    g, split=split, first=lo)
                if want_vals and vals is not None:
                    grad_v = _stacked_gather_dot(
                        getattr(hp, f"{blk}_row_ids")[loc],
                        getattr(hp, f"{blk}_indices")[loc],
                        getattr(hp, f"{blk}_mask")[loc], g, table,
                        1 if vals.dim() == 2 else vals.shape[2])
            else:
                # Row 3, one launch over the shards' stacked transposes.
                grad_t, gv_csc = spmm_minmax_vjp_stacked(
                    t_indptr, t_rows, tvals,
                    table.reshape(-1, table.shape[-1]), out, g, ties,
                    want_values=want_vals, split=split, first=lo)
                if gv_csc is not None:
                    grad_v = _from_csc(gv_csc, t_map,
                                       getattr(hp, f"{blk}_mask")[loc])
            grads.append((grad_t.to(table.dtype).view(table.shape),
                          None if grad_v is None else grad_v.to(vals.dtype)))
        (grad_B, grad_dv), (grad_halo, grad_hv) = grads
        return None, None, None, None, grad_dv, grad_hv, grad_B, grad_halo


def _xla_shard(blk: ShardBlocks, base: str, dv, hv, B_shard, halo_tbl,
               rows: int) -> Tensor:
    """One shard of the plain tier (``body_xla`` and ``_local_block_spmm``):
    each block reduced on its own, then the identity-aware fold of max/min
    (a block without edges in a row is left out of that row's fold)."""
    od = ref.spmm_rows(blk.d_rows, blk.d_indices, dv, B_shard, rows, base)
    oh = ref.spmm_rows(blk.h_rows, blk.h_indices, hv, halo_tbl, rows, base)
    if base == "sum":
        return od + oh
    ident = float("-inf") if base == "max" else float("inf")
    fold = torch.maximum if base == "max" else torch.minimum
    ddeg = (blk.d_indptr[1:] - blk.d_indptr[:-1])[:, None] > 0
    hdeg = (blk.h_indptr[1:] - blk.h_indptr[:-1])[:, None] > 0
    ident_t = od.new_full((), ident, dtype=torch.float32)
    out = fold(torch.where(ddeg, od.float(), ident_t),
               torch.where(hdeg, oh.float(), ident_t))
    return torch.where(torch.isfinite(out), out,
                       torch.zeros_like(out)).to(B_shard.dtype)


def model_slices(B: Tensor, mesh: Mesh, model_axis: Optional[str]):
    """The column blocks of ``B`` that are the local model slices, or None
    when ``B`` is not sharded over the model axis (``model_axis`` is not
    "model", or the mesh has one slice)."""
    if model_axis != "model" or mesh.model == 1:
        return None
    S = len(mesh.local_slices)
    if B.shape[-1] % S:
        raise ValueError(f"B width {B.shape[-1]} must hold {S} local slices "
                         f"of equal width (model={mesh.model})")
    w = B.shape[-1] // S
    return [slice(i * w, (i + 1) * w) for i in range(S)]


def halo_spmm(hp: HaloPartition, B: Tensor, mesh: Mesh, *,
              reduce: str = "sum", method: str = "auto",
              model_axis: Optional[str] = "model",
              diag_vals: Optional[Tensor] = None,
              halo_vals: Optional[Tensor] = None) -> Tensor:
    """C = A @ B with A row-partitioned and B row-sharded, exchanging ONLY
    the halo rows each shard needs.

    B holds the local shards' rows: without a group, the whole padded
    (num_parts*cpp, K) B (``pad_for_halo``) and the result is
    (num_parts*rpp, K); with a group, the rank's (cpp, K) rows and the
    result its (rpp, K).  Differentiable in B and in runtime edge values.

    model_axis: "model" (the default, as in the JAX package) shards B's
    columns over the mesh's model axis: B holds the local slices' columns
    (all K without a group, the rank's K/model with one), and the op runs
    once a local slice (one row-7 launch a slice on "tiled"), each slice
    with its own exchange.  None, or a mesh with model = 1, means the
    columns are replicated over that axis: one call over all of B.  Runtime
    edge values are replicated over the model axis: on sliced columns their
    gradient is summed over every slice (under a group, an ``all_reduce``
    over ``mesh.model_group``).

    diag_vals / halo_vals: optional runtime edge values of the local shards,
    stacked as ``split_edge_values`` gives them, (L, max_nnz) or, on
    "tiled" with sum/mean, per-head (L, max_nnz, H) over a head-blocked B;
    both or neither.  Without them the values built into the partition
    (or 1.0) are used.

    method: "auto" ("tiled" when the partition was built with
    ``tiled=True``, else "xla") | "tiled" (kernel row 7 on the card, its
    plain version on the CPU) | "xla" (plain torch on any device).
    ``reduce="mean"`` divides by the TOTAL row degree.
    """
    if reduce not in REDUCES:
        raise ValueError(f"unknown reduce {reduce!r}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    blocks = model_slices(B, mesh, model_axis)
    if blocks is not None:
        if diag_vals is not None and diag_vals.dim() == 3:
            raise ValueError("per-head (3-D) edge values need model_axis=None")
        if diag_vals is not None and halo_vals is not None:
            diag_vals = model_replicated(diag_vals, mesh)
            halo_vals = model_replicated(halo_vals, mesh)
        outs = [halo_spmm(hp, B[:, cols], mesh, reduce=reduce, method=method,
                          model_axis=None, diag_vals=diag_vals,
                          halo_vals=halo_vals) for cols in blocks]
        return outs[0] if len(outs) == 1 else torch.cat(outs, 1)
    Pn, rpp, cpp = hp.num_parts, hp.rpp, hp.cpp
    shards = mesh.local_shards
    if mesh.data != Pn:
        raise ValueError(f"the mesh has {mesh.data} shards, the partition {Pn}")
    if B.dim() != 2 or B.shape[0] != len(shards) * cpp:
        want = (f"num_parts*cpp = {Pn * cpp}" if mesh.group is None
                else f"cpp = {cpp} (this rank's shard)")
        raise ValueError(f"B must be padded to {want} rows (got "
                         f"{tuple(B.shape)}); pad with pad_for_halo()")
    if (diag_vals is None) != (halo_vals is None):
        raise ValueError("pass diag_vals and halo_vals together")
    if method == "auto":
        method = "tiled" if hp.tiled else "xla"
    if method == "tiled" and not hp.tiled:
        raise ValueError("method='tiled' needs build_halo_partition(tiled=True)")
    base = reduce if reduce in ("max", "min") else "sum"
    rt_vals = diag_vals is not None
    if rt_vals and diag_vals.dim() == 3:
        # Per-head runtime edge values over head-blocked B (the kernel tier
        # only, as in the JAX package).
        heads = int(diag_vals.shape[2])
        if method != "tiled":
            raise ValueError("per-head (3-D) edge values need method='tiled'")
        if B.shape[1] % heads:
            raise ValueError(f"B width {B.shape[1]} must be heads={heads} blocks")
        if base in ("max", "min"):
            raise ValueError("per-head edge values are not supported with "
                             "reduce=max/min on the tiled tier")
    if rt_vals:
        dvals, hvals = diag_vals, halo_vals
    else:  # the local shards' rows of the stacks (contiguous shard ids)
        local = slice(shards[0], shards[-1] + 1)
        dvals = None if hp.diag_data is None else hp.diag_data[local]
        hvals = None if hp.halo_data is None else hp.halo_data[local]
    halo = make_exchange(hp, mesh)(B)
    lo, hi = shards[0], shards[-1] + 1
    if method == "tiled":
        out = _HaloShards.apply(hp, lo, hi, base, dvals, hvals,
                                B.contiguous(), halo)
    else:
        outs = []
        for i, p in enumerate(shards):
            dv = None if dvals is None else dvals[i, :hp.diag_nnz[p]]
            hv = None if hvals is None else hvals[i, :hp.halo_nnz[p]]
            outs.append(_xla_shard(hp.blocks(p), base, dv, hv,
                                   B[i * cpp: (i + 1) * cpp], halo[i], rpp))
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
    if reduce == "mean":
        deg = hp.deg[lo:hi].reshape(-1)
        out = out / torch.clamp(deg, min=1.0)[:, None].to(out.dtype)
    return out
