"""The sharded tier's dry run — the data-axis counterpart of
``__graft_entry__.py::dryrun_multichip``.

One GCN training step and one 2-head GAT step over ``n_shards`` shards held
by one process, on a small SBM graph with self-loops sized so that every
shard has rows (``n_per_class = 32 * n_shards``); each loss must be finite.
"""

from __future__ import annotations

import math

from gespmm_tpu_torch.ops.graph import add_self_loops
from gespmm_tpu_torch.parallel.mesh import make_mesh
from gespmm_tpu_torch.parallel.train_step import (build_sharded_gat,
                                                  build_sharded_gcn)
from gespmm_tpu_torch.utils.datasets import sbm_graph


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """Run one sharded GCN step and one 2-head GAT step on ``device``
    (default: the CUDA card); returns their losses."""
    mesh = make_mesh(data=n_shards, device=device)
    feat, hidden, classes = 32, 16, 4
    ds = sbm_graph(n_per_class=32 * n_shards, num_classes=classes,
                   feat_dim=feat, seed=0)
    csr = add_self_loops(ds.csr)
    losses = {}
    for name, build, kw in (("gcn", build_sharded_gcn, {}),
                            ("gat", build_sharded_gat, {"heads": 2})):
        step, (model, opt), prepare, _ = build(csr, feat, hidden, classes,
                                               mesh, **kw)
        x, labels, mask = prepare(ds.features, ds.labels, ds.masks["train"])
        _, _, loss = step(model, opt, x, labels, mask)
        losses[name] = float(loss)
        assert math.isfinite(losses[name]), f"non-finite {name} loss {loss}"
        print(f"dryrun_multichip {name.upper()} OK: {n_shards} shards on "
              f"{mesh.device}, loss={losses[name]:.4f}")
    return losses
