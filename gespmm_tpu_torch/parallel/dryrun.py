"""The sharded tier's dry run — the counterpart of
``__graft_entry__.py::dryrun_multichip``.

One GCN training step and one 2-head GAT step over an n-cell mesh held by
one process, with the JAX package's layout: ``model = 2`` when n is even
and above 1 (the GCN's hidden dimension cut into two column slices; the GAT
replicates its features over that axis), else 1, and ``data = n // model``
shards of a small SBM graph with self-loops sized so that every shard has
rows (``n_per_class = 32 * data``); each loss must be finite.
"""

from __future__ import annotations

import math

from gespmm_tpu_torch.ops.graph import add_self_loops
from gespmm_tpu_torch.parallel.mesh import make_mesh
from gespmm_tpu_torch.parallel.train_step import (build_sharded_gat,
                                                  build_sharded_gcn)
from gespmm_tpu_torch.utils.datasets import sbm_graph


def mesh_layout(n_devices: int):
    """(data, model) of the dry run's mesh of ``n_devices`` cells."""
    model_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return n_devices // model_axis, model_axis


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run one sharded GCN step and one 2-head GAT step on ``device``
    (default: the CUDA card) over ``mesh_layout(n_devices)``; returns their
    losses."""
    data_axis, model_axis = mesh_layout(n_devices)
    mesh = make_mesh(data=data_axis, model=model_axis, device=device)
    feat, hidden, classes = 32, 16, 4
    ds = sbm_graph(n_per_class=32 * data_axis, num_classes=classes,
                   feat_dim=feat, seed=0)
    csr = add_self_loops(ds.csr)
    out = {}
    for name, build, kw in (("gcn", build_sharded_gcn, {}),
                            ("gat", build_sharded_gat, {"heads": 2})):
        step, (model, opt), prepare, _ = build(csr, feat, hidden, classes,
                                               mesh, **kw)
        x, labels, mask = prepare(ds.features, ds.labels, ds.masks["train"])
        _, _, loss = step(model, opt, x, labels, mask)
        out[name] = float(loss)
        assert math.isfinite(out[name]), f"non-finite {name} loss {loss}"
        print(f"dryrun_multichip {name.upper()} OK: mesh data={data_axis} "
              f"model={model_axis} on {mesh.device}, loss={out[name]:.4f}")
    return out
