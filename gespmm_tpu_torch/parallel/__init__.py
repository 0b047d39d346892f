"""The sharded tier — port of ``gespmm_tpu/parallel/`` on a (data, model) mesh.

``halo.py`` (the halo-exchange SpMM over kernel row 7), ``dist_spmm.py``
(the all-gather tier), ``edge_ops.py`` (sharded SDDMM, attention logits and
edge softmax), ``train_step.py`` (the sharded GCN, GraphSAGE and GAT train
steps; the GCN shards its hidden dimension over the "model" axis),
``mesh.py`` (one process holding every data × model cell, or one
``torch.distributed`` rank a cell, with its data and model subgroups) and
``dryrun.py``.
"""

from gespmm_tpu_torch.parallel.mesh import make_mesh
from gespmm_tpu_torch.parallel.dist_spmm import (
    PartitionedAdjacency,
    partition_adjacency,
    dist_spmm,
)
from gespmm_tpu_torch.parallel.halo import (
    HaloPartition,
    build_halo_partition,
    halo_spmm,
    pad_for_halo,
)

__all__ = [
    "make_mesh",
    "PartitionedAdjacency",
    "partition_adjacency",
    "dist_spmm",
    "HaloPartition",
    "build_halo_partition",
    "halo_spmm",
    "pad_for_halo",
]
