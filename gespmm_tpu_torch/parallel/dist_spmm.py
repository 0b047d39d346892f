"""All-gather sharded SpMM — port of ``gespmm_tpu/parallel/dist_spmm.py``.

The simple formulation, kept as the reference tier: every shard sees the
whole B and multiplies its own row slab,

  forward:  all-gather B            -> local CSR slab x full B -> local C slab
  backward: reduce-scatter grad_B   (the transpose of the all-gather)

Per-shard memory is O(n·K) whatever the shard count; ``parallel/halo.py`` is
the scalable design.  Each slab goes through the port's ``ops/spmm.py::spmm``
(kernel rows 1-3 on the card), over an ``Adjacency`` built once per slab by
``partition_adjacency``.  The "model" axis shards K: the op is
embarrassingly parallel over it, one ``spmm`` a slab and local slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.parallel.halo import model_slices
from gespmm_tpu_torch.parallel.mesh import Mesh
from gespmm_tpu_torch.sparse.formats import CSR

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PartitionedAdjacency:
    """Row-slab partitioned CSR, stacked with a leading parts axis.

    indptr:  (parts, rows_per_part + 1) int32 — local row offsets
    indices: (parts, nnz_pad) int32 — GLOBAL column ids (pad -> 0)
    data:    (parts, nnz_pad) values or None (pad -> 0)
    mask:    (parts, nnz_pad) bool — False on padded slots
    shape:   global (m, n); rows_per_part.
    slabs:   the port's own: each slab's ``Adjacency`` (rows_per_part, n),
             its CSR/CSC pairing built once on the host.
    """

    indptr: Tensor
    indices: Tensor
    data: Optional[Tensor]
    mask: Tensor
    shape: Tuple[int, int]
    rows_per_part: int
    slabs: Tuple[Adjacency, ...]

    @property
    def num_parts(self) -> int:
        return int(self.indptr.shape[0])


def partition_adjacency(csr: CSR, num_parts: int,
                        device=None) -> PartitionedAdjacency:
    """Host-side equal-row-slab partitioner with per-slab nnz padding; the
    result lives on ``device`` (default: the device ``csr`` lives on)."""
    device = csr.device if device is None else torch.device(device)
    indptr = csr.indptr.cpu().numpy()
    indices = csr.indices.cpu().numpy()
    data = None if csr.data is None else csr.data.cpu().numpy()
    m, n = csr.shape
    rpp = (m + num_parts - 1) // num_parts

    slabs = []
    max_nnz = 1
    for p in range(num_parts):
        r0, r1 = p * rpp, min((p + 1) * rpp, m)
        s, e = int(indptr[min(r0, m)]), int(indptr[min(r1, m)])
        local_ptr = (indptr[r0: r1 + 1] - s if r1 > r0
                     else np.zeros(1, np.int64))
        if r1 - r0 < rpp:  # pad the short final slab's rows
            local_ptr = np.concatenate(
                [local_ptr, np.full(rpp - max(r1 - r0, 0), local_ptr[-1])])
        slabs.append((local_ptr, indices[s:e],
                      None if data is None else data[s:e]))
        max_nnz = max(max_nnz, e - s)

    out_ptr = np.zeros((num_parts, rpp + 1), np.int32)
    out_idx = np.zeros((num_parts, max_nnz), np.int32)
    out_mask = np.zeros((num_parts, max_nnz), bool)
    out_data = (None if data is None
                else np.zeros((num_parts, max_nnz), data.dtype))
    adjs = []
    for p, (lp, li, ld) in enumerate(slabs):
        out_ptr[p] = lp
        out_idx[p, : li.shape[0]] = li
        out_mask[p, : li.shape[0]] = True
        if out_data is not None:
            out_data[p, : li.shape[0]] = ld
        adjs.append(Adjacency.from_csr(CSR(
            torch.from_numpy(lp.astype(np.int32)),
            torch.from_numpy(li.astype(np.int32)),
            None if ld is None else torch.from_numpy(np.ascontiguousarray(ld)),
            (rpp, n)), device=device))

    def dev(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return PartitionedAdjacency(
        indptr=dev(out_ptr), indices=dev(out_idx), data=dev(out_data),
        mask=dev(out_mask), shape=(m, n), rows_per_part=rpp,
        slabs=tuple(adjs))


class _AllGather(torch.autograd.Function):
    """all_gather_into_tensor forward; reduce_scatter_tensor (sum) of the
    gradient backward."""

    @staticmethod
    def forward(ctx, B_shard, group):
        ctx.group = group
        world = dist.get_world_size(group)
        full = B_shard.new_empty((world * B_shard.shape[0],) + B_shard.shape[1:])
        dist.all_gather_into_tensor(full, B_shard.contiguous(), group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        world = dist.get_world_size(ctx.group)
        grad = g.new_empty((g.shape[0] // world,) + g.shape[1:])
        dist.reduce_scatter_tensor(grad, g.contiguous(), group=ctx.group)
        return grad, None


def dist_spmm(padj: PartitionedAdjacency, B: Tensor, mesh: Mesh, *,
              reduce: str = "sum", method: str = "auto",
              model_axis: Optional[str] = "model") -> Tensor:
    """C = A @ B with A row-partitioned and B row-sharded.

    Without a group, B is the whole (n, K) and the result (parts*rpp, K);
    with a group, B is the rank's (n / parts, K) rows (n a multiple of the
    parts, as the JAX package's sharding requires) and the result its
    (rpp, K) rows, all-gathered over the rank's data group.
    ``model_axis="model"`` shards K over the mesh's model axis (B holds the
    local slices' columns: all of K without a group, K/model with one), and
    each slab is multiplied once a local slice; None replicates K.
    ``reduce`` and ``method`` are ``spmm``'s.  Differentiable.
    """
    if mesh.data != padj.num_parts:
        raise ValueError(f"the mesh has {mesh.data} shards, the partition "
                         f"{padj.num_parts}")
    n = padj.shape[1]
    if mesh.group is None:
        B_full = B
    else:
        if n % mesh.data or B.shape[0] != n // mesh.data:
            raise ValueError(f"B must hold n/parts = {n}/{mesh.data} rows on "
                             f"each rank, got {B.shape[0]}")
        B_full = _AllGather.apply(B, mesh.data_group)
    blocks = model_slices(B_full, mesh, model_axis)

    def slab(p):
        if blocks is None:
            return spmm(padj.slabs[p], B_full, reduce=reduce, method=method)
        return torch.cat([spmm(padj.slabs[p], B_full[:, cols], reduce=reduce,
                               method=method) for cols in blocks], 1)

    outs = [slab(p) for p in mesh.local_shards]
    return outs[0] if len(outs) == 1 else torch.cat(outs)
