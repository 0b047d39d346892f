"""The "model" mesh axis of the port against the JAX package's, on the CPU.

One process holds every cell of a (data, model) mesh: ``halo_spmm`` and
``dist_spmm`` run once a model slice (contiguous column blocks of K/model),
``halo_sddmm`` sums its slices' partial dots, and the sharded GCN cuts its
hidden dimension into the slices (``shard_gcn_params``) and sums the output
layer's partial products (``parallel/mesh.py::model_sum``).  The setups are
the JAX package's own model-axis tests (``tests/test_dist.py::
test_halo_spmm_with_model_axis`` and ``test_dist_spmm_2d_mesh``,
``tests/test_dist_edge.py::test_halo_sddmm_model_axis_psum``) on its
virtual 8-device mesh.  Tolerances: values 1e-5 * max(|ref|, 1); the GCN's
first loss and its parameters after 3 AdamW steps 1e-4 * max(|ref|, 1); the
forward against the same mesh with model = 1 exactly (a slice's columns
meet the same sums).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gespmm_tpu.ops.graph import add_self_loops as jax_add_self_loops
from gespmm_tpu.parallel import edge_ops as jedge
from gespmm_tpu.parallel import train_step as jtrain
from gespmm_tpu.parallel.dist_spmm import dist_spmm as jax_dist_spmm
from gespmm_tpu.parallel.dist_spmm import partition_adjacency as jax_padj
from gespmm_tpu.parallel.halo import build_halo_partition as jax_build
from gespmm_tpu.parallel.halo import halo_spmm as jax_halo_spmm
from gespmm_tpu.parallel.halo import pad_for_halo as jax_pad
from gespmm_tpu.parallel.mesh import make_mesh as jax_mesh
from gespmm_tpu.utils.datasets import sbm_graph as jax_sbm
from gespmm_tpu_torch.models.common import params_from_jax
from gespmm_tpu_torch.parallel import (build_halo_partition, dist_spmm,
                                       halo_spmm, make_mesh, pad_for_halo,
                                       partition_adjacency)
from gespmm_tpu_torch.parallel import edge_ops as tedge
from gespmm_tpu_torch.parallel import train_step as ttrain
from gespmm_tpu_torch.parallel.dryrun import dryrun_multichip, mesh_layout
from gespmm_tpu_torch.parallel.mesh import model_sum
from gespmm_tpu_torch.sparse.formats import CSR, csr_from_scipy
from tests.conftest import random_csr

STEPS = 3


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def _place(mesh, a, spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))


def _pad(a, rows):
    return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


@pytest.mark.parametrize("data,model", [(2, 2), (4, 2)])
@pytest.mark.parametrize("method", ["tiled", "xla"])
def test_halo_spmm_model_axis_matches_jax(data, model, method):
    """JAX's ``test_halo_spmm_with_model_axis`` setup, at (2, 2) and (4, 2)."""
    csr, mat = random_csr(64, 64, density=0.1, seed=13)
    jm = jax_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    jhp = jax_build(csr, data, tiled=True, chunk_nnz=16, rows_per_block=16)
    B = np.random.default_rng(13).standard_normal((64, 16)).astype(np.float32)
    Bd = _place(jm, jax_pad(jhp, jnp.asarray(B)), P("data", "model"))
    want = np.asarray(jax.jit(lambda b: jax_halo_spmm(
        jhp, b, jm, method=method))(Bd))
    hp = build_halo_partition(csr_from_scipy(mat), data, device="cpu")
    Bt = pad_for_halo(hp, torch.from_numpy(B))
    got = halo_spmm(hp, Bt, make_mesh(data, model, device="cpu"),
                    method=method)
    _close(got.numpy(), want)
    _close(got.numpy()[:64], mat @ B)
    one = halo_spmm(hp, Bt, make_mesh(data, device="cpu"), method=method)
    np.testing.assert_array_equal(got.numpy(), one.numpy())
    # model_axis=None: the columns are replicated, one call over all of B.
    np.testing.assert_array_equal(
        halo_spmm(hp, Bt, make_mesh(data, model, device="cpu"),
                  method=method, model_axis=None).numpy(), one.numpy())


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_halo_spmm_model_axis_grads_match_one_slice(reduce):
    """Forward and backward on (4, 2) against (4, 1), with runtime values."""
    from gespmm_tpu_torch.parallel.halo import split_edge_values

    _, mat = random_csr(96, 96, density=0.08, seed=21)
    hp = build_halo_partition(csr_from_scipy(mat), 4, device="cpu")
    rng = np.random.default_rng(21)
    B = (np.round(rng.standard_normal((4 * hp.cpp, 16)) * 2) / 2).astype(
        np.float32)
    g = rng.standard_normal((4 * hp.rpp, 16)).astype(np.float32)
    res = []
    for model in (1, 2):
        Bt = torch.from_numpy(B).requires_grad_(True)
        v = torch.from_numpy(mat.data.astype(np.float32)).requires_grad_(True)
        dv, hv = split_edge_values(hp, v)
        out = halo_spmm(hp, Bt, make_mesh(4, model, device="cpu"),
                        reduce=reduce, diag_vals=dv, halo_vals=hv)
        out.backward(torch.from_numpy(g))
        res.append((out.detach().numpy(), Bt.grad.numpy(), v.grad.numpy()))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    for got, want in zip(res[1][1:], res[0][1:]):
        _close(got, want)


def test_dist_spmm_2d_mesh_matches_jax():
    """JAX's ``test_dist_spmm_2d_mesh`` setup, and its gradient test's."""
    csr, mat = random_csr(64, 64, density=0.12, seed=3)
    jm = jax_mesh(data=4, model=2)
    B = np.random.default_rng(3).standard_normal((64, 32)).astype(np.float32)
    want = np.asarray(jax_dist_spmm(jax_padj(csr, 4),
                                    _place(jm, B, P("data", "model")), jm))
    padj = partition_adjacency(csr_from_scipy(mat), 4, device="cpu")
    Bt = torch.from_numpy(B).requires_grad_(True)
    got = dist_spmm(padj, Bt, make_mesh(4, 2, device="cpu"))
    _close(got.detach().numpy(), want)
    np.testing.assert_array_equal(
        got.detach().numpy(),
        dist_spmm(padj, torch.from_numpy(B), make_mesh(4, device="cpu")).numpy())
    g = np.random.default_rng(1).standard_normal(tuple(got.shape)).astype(
        np.float32)
    got.backward(torch.from_numpy(g))
    _close(Bt.grad.numpy(), mat.T @ g[:64], 1e-4)


def test_halo_sddmm_model_axis_matches_jax():
    """JAX's ``test_halo_sddmm_model_axis_psum`` setup: K sharded over the
    model axis, the contraction summed over the slices."""
    csr, mat = random_csr(48, 48, density=0.12, seed=7)
    jm = jax_mesh(data=4, model=2)
    jhp = jax_build(csr, 4, tiled=False)
    rng = np.random.default_rng(7)
    D1 = rng.standard_normal((48, 32)).astype(np.float32)
    D2 = rng.standard_normal((48, 32)).astype(np.float32)
    jdv, jhv = jedge.halo_sddmm(
        jhp, _place(jm, _pad(D1, 4 * jhp.rpp), P("data", "model")),
        _place(jm, _pad(D2, 4 * jhp.cpp), P("data", "model")), jm)
    want = np.asarray(jedge.merge_edge_values(jhp, jdv, jhv))
    hp = build_halo_partition(csr_from_scipy(mat), 4, tiled=False,
                              device="cpu")
    d1 = torch.from_numpy(_pad(D1, 4 * hp.rpp)).requires_grad_(True)
    d2 = torch.from_numpy(_pad(D2, 4 * hp.cpp)).requires_grad_(True)
    dv, hv = tedge.halo_sddmm(hp, d1, d2, make_mesh(4, 2, device="cpu"))
    got = tedge.merge_edge_values(hp, dv, hv)
    _close(got.detach().numpy(), want)
    # The gradient through the slices' sum equals the unsliced one: the
    # backward passes the replicated cotangent through, once.
    gv = torch.from_numpy(np.random.default_rng(8).standard_normal(
        got.shape[0]).astype(np.float32))
    got.backward(gv)
    d1u, d2u = (d1.detach().clone().requires_grad_(True),
                d2.detach().clone().requires_grad_(True))
    one = tedge.merge_edge_values(hp, *tedge.halo_sddmm(
        hp, d1u, d2u, make_mesh(4, 2, device="cpu"), model_axis=None))
    one.backward(gv)
    _close(d1.grad.numpy(), d1u.grad.numpy())
    _close(d2.grad.numpy(), d2u.grad.numpy())


def test_model_sum_backward_passes_the_cotangent_once():
    mesh = make_mesh(2, 2, device="cpu")
    parts = torch.randn(2, 5, 3, requires_grad=True)
    out = model_sum(parts, mesh)
    torch.testing.assert_close(out, parts.detach().sum(0), rtol=0, atol=0)
    g = torch.randn(5, 3)
    out.backward(g)
    torch.testing.assert_close(parts.grad, torch.stack([g, g]), rtol=0, atol=0)
    with pytest.raises(ValueError, match="local model slices"):
        model_sum(torch.zeros(3, 2), mesh)


@functools.lru_cache(maxsize=None)
def _dataset():
    ds = jax_sbm(n_per_class=24, num_classes=3, feat_dim=16, seed=0)
    csr = jax_add_self_loops(ds.csr)
    port_csr = CSR(*(torch.from_numpy(np.array(a)) for a in (
        csr.indptr, csr.indices, csr.data)), tuple(csr.shape))
    host = tuple(np.asarray(a) for a in (ds.features, ds.labels,
                                         ds.masks["train"]))
    return csr, port_csr, host


def test_sharded_gcn_model_axis_matches_jax():
    """The sharded GCN on (4, 2) against JAX's ``build_sharded_gcn`` on
    ``make_mesh(data=4, model=2)``, both from the JAX init."""
    csr, port_csr, (x, labels, mask) = _dataset()
    jm = jax_mesh(data=4, model=2)
    tm = make_mesh(4, 2, device="cpu")
    jstep, (params, opt_state), jprep, _ = jtrain.build_sharded_gcn(
        csr, 16, 8, 3, jm)
    tstep, (model, opt), tprep, _ = ttrain.build_sharded_gcn(
        port_csr, 16, 8, 3, tm)
    model.load_state_dict(ttrain.shard_gcn_params(
        params_from_jax((params, opt_state)), tm))
    jx, jl, jmask = jprep(jnp.asarray(x), jnp.asarray(labels),
                          jnp.asarray(mask))
    tx, tl, tmask = tprep(x, labels, mask)
    for step in range(STEPS):
        params, opt_state, jloss = jstep(params, opt_state, jx, jl, jmask)
        model, opt, tloss = tstep(model, opt, tx, tl, tmask)
        if step == 0:
            _close(float(tloss), float(jloss), 1e-4)
    want = params_from_jax(params)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        _close(got[key], value, 1e-4)


def test_sharded_gcn_model_axis_equals_data_only():
    """(4, 2) and (4, 1) start equal from the same seed; their logits and
    gradients agree (a doubled contraction gradient would not)."""
    _, port_csr, (x, labels, mask) = _dataset()
    runs = []
    for model_axis in (1, 2):
        step, (model, opt), prep, _ = ttrain.build_sharded_gcn(
            port_csr, 16, 8, 3, make_mesh(4, model_axis, device="cpu"))
        tx, tl, tmask = prep(x, labels, mask)
        logits = model(tx)
        ttrain._global_loss(logits, tl, tmask, model.mesh).backward()
        runs.append((model.state_dict(), logits.detach(),
                     {k: p.grad.clone() for k, p in model.named_parameters()}))
    for k in runs[0][0]:
        torch.testing.assert_close(runs[1][0][k], runs[0][0][k], rtol=0,
                                   atol=0)
    _close(runs[1][1].numpy(), runs[0][1].numpy())
    for k in runs[0][2]:
        _close(runs[1][2][k].numpy(), runs[0][2][k].numpy())


def test_shard_gcn_params_cuts_the_local_share():
    state = {"l1.w": torch.arange(24.).view(4, 6), "l1.b": torch.arange(6.),
             "l2.w": torch.arange(18.).view(6, 3), "l2.b": torch.arange(3.)}
    whole = ttrain.shard_gcn_params(state, make_mesh(2, 2, device="cpu"))
    for k in state:
        torch.testing.assert_close(whole[k], state[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="hidden=6"):
        ttrain.shard_gcn_params(state, make_mesh(1, 4, device="cpu"))


def test_dryrun_layout_matches_jax(capsys):
    """JAX's dry run builds its mesh over all 8 virtual devices, so it runs
    at n = 8 here; at n = 4 its rule (model 2 for an even n above 1, data
    n // model) gives (2, 2)."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)
    assert "mesh data=4 model=2" in capsys.readouterr().out
    assert [mesh_layout(n) for n in (1, 2, 3, 4, 8)] == [
        (1, 1), (1, 2), (3, 1), (2, 2), (4, 2)]
    losses = dryrun_multichip(4, device="cpu")
    assert "mesh data=2 model=2" in capsys.readouterr().out
    assert sorted(losses) == ["gat", "gcn"]
    assert all(np.isfinite(v) for v in losses.values())
