"""The shard layout of the sharded tier — port of ``gespmm_tpu/parallel/mesh.py``.

The JAX package lays shards on a ("data", "model") ``jax.sharding.Mesh``:

  * "data": graph rows partitioned into ``data`` shards (each owns a slab
    of output rows and the matching slab of B rows); the halo exchange and
    the data-parallel gradient sum run along it;
  * "model": the feature dimension K cut into ``model`` contiguous column
    slices of K/model; an SpMM runs slice by slice, and a contraction over
    K (a dense layer's rows, an SDDMM's dot) sums over the slices.

The port holds the data × model cells in two modes:

  * one process holds every cell on one device (the card runs the mesh
    this way, since NCCL cannot put two ranks on one card): the exchange
    between shards is an ``index_select``, and the per-slice code runs once
    for each of the ``local_slices``;
  * one process per cell, joined by a ``torch.distributed`` group of world
    size data × model: rank r holds cell (d, m) = divmod(r, model), JAX's
    ``reshape(data, model)`` order.  The halo exchange's point-to-point
    rounds (``parallel/halo.py::make_exchange``) and the gradient sum run
    over the rank's data group (its model column), the contractions'
    ``all_reduce`` over its model group (its data row).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` × ``model`` cells on ``device``.  ``group`` is None (one
    process holds them all) or the ``torch.distributed`` group whose rank r
    holds cell divmod(r, model); then ``data_group`` is the rank's model
    column (``group`` itself when model is 1) and ``model_group`` its data
    row (None when model is 1)."""

    data: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    model: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def rank(self) -> Optional[int]:
        return None if self.group is None else dist.get_rank(self.group)

    @property
    def cell(self) -> Optional[Tuple[int, int]]:
        """This rank's (data shard, model slice); None without a group."""
        return None if self.group is None else divmod(self.rank, self.model)

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The shards this process holds, in the order of its local rows."""
        return (tuple(range(self.data)) if self.group is None
                else (self.cell[0],))

    @property
    def local_slices(self) -> Tuple[int, ...]:
        """The model slices this process holds, in the order of its local
        columns: contiguous column blocks of K/model."""
        return (tuple(range(self.model)) if self.group is None
                else (self.cell[1],))

    def global_rank(self, shard: int) -> int:
        """The global rank of the process that holds ``shard`` in this
        rank's model column."""
        return dist.get_global_rank(self.data_group, shard)

    def slice_width(self, K: int, what: str = "K") -> int:
        """K/model, the width of one model slice (``K`` is the full
        width); raises unless ``model`` divides K."""
        if K % self.model:
            raise ValueError(f"{what}={K} must split into model={self.model} "
                             "equal column slices")
        return K // self.model


class _ModelSum(torch.autograd.Function):
    """Forward: the sum of the local slices' partials over dim 0, then an
    ``all_reduce`` over the model group under a group.  Backward: the
    cotangent, which is replicated over the model axis, passes to every
    slice's partial unchanged (an ``all_reduce`` there would multiply the
    gradients by ``model``)."""

    @staticmethod
    def forward(ctx, partials, group):
        ctx.slices = partials.shape[0]
        out = partials.sum(0)
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(0).expand((ctx.slices,) + tuple(g.shape)), None


def model_sum(partials: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The contraction over the "model" axis (the ``psum`` that XLA inserts
    after a K-sharded product): ``partials`` stacks one partial result a
    local slice, (len(mesh.local_slices), ...); returns their sum over every
    slice of the mesh, replicated.  Differentiable."""
    if partials.shape[0] != len(mesh.local_slices):
        raise ValueError(f"{partials.shape[0]} partials for "
                         f"{len(mesh.local_slices)} local model slices")
    return _ModelSum.apply(partials, mesh.model_group)


class _ModelReplicated(torch.autograd.Function):
    """The mirror of ``_ModelSum``: forward, the input unchanged; backward,
    an ``all_reduce`` over the model group of the gradient, whose rank holds
    only its slices' share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def model_replicated(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``, replicated over the "model" axis, as input to per-slice work:
    under a group of model > 1 its gradient is summed over the model group
    (the transpose of the replication); otherwise ``x`` itself, whose local
    slices' gradients autograd sums.  Differentiable."""
    if mesh.model_group is None:
        return x
    return _ModelReplicated.apply(x, mesh.model_group)


def maybe_distributed_init(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None):
    """Join the process group at ``init_method`` (e.g.
    ``"tcp://localhost:29500"``) with ``backend`` ("nccl" on the card,
    "gloo" on the CPU) and return the world group; a no-op returning None
    without ``init_method``.  The backend is never chosen for the caller."""
    if init_method is None:
        return None
    if backend is None:
        raise ValueError("pass the backend ('nccl' or 'gloo') explicitly")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.group.WORLD


def make_mesh(data: int = 0, model: int = 1, *, group=None,
              device=None) -> Mesh:
    """A mesh of ``data`` shards × ``model`` column slices.

    Without ``group``, one process holds every cell (``data=0`` means 1) on
    ``device`` (default: the current CUDA card).  With a ``torch.distributed``
    group, its world size must equal data × model (``data=0`` takes world /
    model); rank r holds cell divmod(r, model).  For model > 1 every rank of
    the group builds every data and model subgroup with ``dist.new_group``,
    in the same order (a rank that skipped one would hang the others).
    """
    if model < 1:
        raise ValueError(f"model must be >= 1, got {model}")
    data_group = model_group = None
    if group is None:
        data = data or 1
    else:
        world = dist.get_world_size(group)
        if data == 0:
            if world % model:
                raise ValueError(f"{world} ranks not divisible by "
                                 f"model={model}")
            data = world // model
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != group world size "
                             f"{world}")
        data_group = group
        if model > 1:
            ranks = [dist.get_global_rank(group, r) for r in range(world)]
            d, m = divmod(dist.get_rank(group), model)
            for col in range(model):  # the data groups: one a model column
                sub = dist.new_group([ranks[i * model + col]
                                      for i in range(data)])
                if col == m:
                    data_group = sub
            for row in range(data):  # the model groups: one a data row
                sub = dist.new_group(ranks[row * model: (row + 1) * model])
                if row == d:
                    model_group = sub
    if data < 1:
        raise ValueError(f"data must be >= 1, got {data}")
    device = torch.device("cuda" if device is None else device)
    return Mesh(data=data, device=device, group=group, model=model,
                data_group=data_group, model_group=model_group)
