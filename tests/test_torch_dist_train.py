"""The sharded train steps of the port against the JAX package's, on the CPU.

The three sharded builders (GCN; SAGE mean and pool; GAT with 1 and 2 heads)
at P = 4, started from the same parameters (the JAX init state through
``models/common.py::params_from_jax``), on the same SBM graph with
self-loops: the first loss and the parameters after 3 AdamW steps within
1e-4 * max(|ref|, 1) of the JAX ``train_step`` (its tiled tier runs the
Pallas stream kernel in interpret mode; the port's runs kernel row 7's plain
version).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gespmm_tpu.ops.graph import add_self_loops as jax_add_self_loops
from gespmm_tpu.parallel import train_step as jtrain
from gespmm_tpu.parallel.mesh import make_mesh as jax_mesh
from gespmm_tpu.utils.datasets import sbm_graph as jax_sbm
from gespmm_tpu_torch.models.common import params_from_jax
from gespmm_tpu_torch.parallel import make_mesh
from gespmm_tpu_torch.parallel import train_step as ttrain
from gespmm_tpu_torch.sparse.formats import CSR

STEPS = 3


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= bound


@functools.lru_cache(maxsize=None)
def _dataset():
    ds = jax_sbm(n_per_class=24, num_classes=3, feat_dim=16, seed=0)
    csr = jax_add_self_loops(ds.csr)
    port_csr = CSR(*(torch.from_numpy(np.array(a)) for a in (
        csr.indptr, csr.indices, csr.data)), tuple(csr.shape))
    host = tuple(np.asarray(a) for a in (ds.features, ds.labels,
                                         ds.masks["train"]))
    return csr, port_csr, host


BUILDERS = {
    "gcn": ("build_sharded_gcn", {}),
    "sage-mean": ("build_sharded_sage", {"aggregator": "mean"}),
    "sage-pool": ("build_sharded_sage", {"aggregator": "pool"}),
    "gat-1": ("build_sharded_gat", {"heads": 1}),
    "gat-2": ("build_sharded_gat", {"heads": 2}),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_sharded_train_steps_match_jax(name):
    parts = 4
    builder, kw = BUILDERS[name]
    csr, port_csr, (x, labels, mask) = _dataset()
    jm = jax_mesh(data=parts, model=1, devices=jax.devices()[:parts])
    tm = make_mesh(parts, device="cpu")
    jstep, (params, opt_state), jprep, _ = getattr(jtrain, builder)(
        csr, 16, 8, 3, jm, **kw)
    tstep, (model, opt), tprep, _ = getattr(ttrain, builder)(
        port_csr, 16, 8, 3, tm, **kw)
    model.load_state_dict(params_from_jax((params, opt_state)))
    jx, jl, jmask = jprep(jnp.asarray(x), jnp.asarray(labels),
                          jnp.asarray(mask))
    tx, tl, tmask = tprep(x, labels, mask)
    for step in range(STEPS):
        params, opt_state, jloss = jstep(params, opt_state, jx, jl, jmask)
        model, opt, tloss = tstep(model, opt, tx, tl, tmask)
        if step == 0:
            _close(float(tloss), float(jloss))
    want = params_from_jax(params)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        _close(got[key], value)
