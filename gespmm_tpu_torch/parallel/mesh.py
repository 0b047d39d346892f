"""The shard layout of the sharded tier — port of ``gespmm_tpu/parallel/mesh.py``.

The JAX package lays shards on a ("data", "model") ``jax.sharding.Mesh``.
The port has the "data" axis (graph rows partitioned into P shards) in two
modes:

  * one process holds all P shards, on one device: the exchange between
    shards is an ``index_select`` on that device (the card runs P shards
    this way, since NCCL cannot put two ranks on one card);
  * one process per shard, joined by a ``torch.distributed`` group of world
    size P: the rank is the shard, and the exchange runs point-to-point
    rounds (``parallel/halo.py::make_exchange``).

The "model" axis (feature sharding) is not ported (ROADMAP A1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` shards on ``device``; ``group`` is None (one process holds
    them all) or the ``torch.distributed`` group whose rank is the shard."""

    data: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def rank(self) -> Optional[int]:
        return None if self.group is None else dist.get_rank(self.group)

    @property
    def local_shards(self) -> Tuple[int, ...]:
        """The shards this process holds, in the order of its local rows."""
        return tuple(range(self.data)) if self.group is None else (self.rank,)

    def global_rank(self, shard: int) -> int:
        """The global rank of the process that holds ``shard``."""
        return dist.get_global_rank(self.group, shard)


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
    """A mesh of ``data`` shards.

    Without ``group``, one process holds all ``data`` shards (``data=0``
    means 1) on ``device`` (default: the current CUDA card).  With a
    ``torch.distributed`` group, its world size must equal ``data``
    (``data=0`` takes it) and each rank holds the shard of its rank number.
    """
    if model != 1:
        raise NotImplementedError(
            "the 'model' mesh axis (feature sharding) is not ported; "
            "ROADMAP A1 does the data axis first")
    if group is None:
        data = data or 1
    else:
        world = dist.get_world_size(group)
        data = data or world
        if data != world:
            raise ValueError(f"mesh data={data} != group world size {world}")
    if data < 1:
        raise ValueError(f"data must be >= 1, got {data}")
    device = torch.device("cuda" if device is None else device)
    return Mesh(data=data, device=device, group=group)
