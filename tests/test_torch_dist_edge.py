"""The sharded edge ops of the port against the JAX package's.

The edge ops (``halo_sddmm``, ``halo_additive_logits``, ``halo_edge_softmax``,
``merge_edge_values``, ``halo_gat_attention``) and the attention chain's
gradients, at P in {2, 4} (``tests/test_dist_edge.py`` is the model): values
within 1e-5 * max |ref| + 1e-6, gradients within 1e-4 * max(|ref|, 1).  Also
the port's dry run on the CPU, and that importing ``gespmm_tpu_torch.parallel``
pulls in neither JAX nor the JAX package.  The sharded train steps against
JAX's are in ``tests/test_torch_dist_train.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gespmm_tpu.parallel import edge_ops as jedge
from gespmm_tpu.parallel.halo import build_halo_partition as jax_build
from gespmm_tpu.parallel.halo import halo_spmm as jax_halo_spmm
from gespmm_tpu.parallel.mesh import make_mesh as jax_mesh
from gespmm_tpu.sparse.formats import csr_from_scipy as jax_csr
from gespmm_tpu_torch.parallel import edge_ops as tedge
from gespmm_tpu_torch.parallel import build_halo_partition, halo_spmm, make_mesh
from gespmm_tpu_torch.parallel.dryrun import dryrun_multichip
from gespmm_tpu_torch.sparse.formats import csr_from_scipy
from tests.conftest import random_csr

def _close(got, want, tol=1e-5, grad=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    bound = tol * max(scale, 1.0) if grad else tol * scale + 1e-6
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= bound, (err, bound)


def _meshes(parts):
    return (jax_mesh(data=parts, model=1, devices=jax.devices()[:parts]),
            make_mesh(parts, device="cpu"))


def _place(mesh, a):
    return jax.device_put(jnp.asarray(a), NamedSharding(
        mesh, P("data", *([None] * (np.ndim(a) - 1)))))


def _pad(a, rows):
    return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


@pytest.mark.parametrize("parts", (2, 4))
def test_halo_sddmm_matches_jax(parts):
    _, mat = random_csr(60, 44, density=0.12, seed=parts)
    jh = jax_build(jax_csr(mat), parts, tiled=False)
    th = build_halo_partition(csr_from_scipy(mat), parts, device="cpu")
    jm, tm = _meshes(parts)
    rng = np.random.default_rng(parts)
    D1 = _pad(rng.standard_normal((60, 16)).astype(np.float32), parts * th.rpp)
    D2 = _pad(rng.standard_normal((44, 16)).astype(np.float32), parts * th.cpp)
    jdv, jhv = jax.jit(lambda a, b: jedge.halo_sddmm(
        jh, a, b, jm, model_axis=None))(_place(jm, D1), _place(jm, D2))
    tdv, thv = tedge.halo_sddmm(th, torch.from_numpy(D1), torch.from_numpy(D2),
                                tm)
    _close(tdv, jdv)
    _close(thv, jhv)
    _close(tedge.merge_edge_values(th, tdv, thv),
           jedge.merge_edge_values(jh, jdv, jhv))
    with pytest.raises(ValueError, match="pad"):
        tedge.halo_sddmm(th, torch.from_numpy(D1[:59]), torch.from_numpy(D2), tm)


@pytest.mark.parametrize("heads", (1, 2))
@pytest.mark.parametrize("parts", (2, 4))
def test_halo_logits_and_softmax_match_jax(parts, heads):
    """Additive logits, then the joint diag+halo softmax; padded slots are
    exactly 0, empty rows give nothing."""
    _, mat = random_csr(48, 48, density=0.1, seed=5 + parts)
    mat.data[mat.indptr[3]: mat.indptr[4]] = 0  # an empty row
    mat.eliminate_zeros()
    jh = jax_build(jax_csr(mat), parts, tiled=False)
    th = build_halo_partition(csr_from_scipy(mat), parts, device="cpu")
    jm, tm = _meshes(parts)
    rng = np.random.default_rng(heads)
    shape = (48,) if heads == 1 else (48, heads)
    src = _pad(rng.standard_normal(shape).astype(np.float32), parts * th.rpp)
    dst = _pad(rng.standard_normal(shape).astype(np.float32), parts * th.cpp)
    jl = jax.jit(lambda s, d: jedge.halo_additive_logits(jh, s, d, jm))(
        _place(jm, src), _place(jm, dst))
    tl = tedge.halo_additive_logits(th, torch.from_numpy(src),
                                    torch.from_numpy(dst), tm)
    for a, b in zip(tl, jl):
        _close(a, b)
    ja = jax.jit(lambda d, h: jedge.halo_edge_softmax(jh, d, h, jm))(*jl)
    ta = tedge.halo_edge_softmax(th, *tl, tm)
    for a, b, mask in zip(ta, ja, (th.diag_mask, th.halo_mask)):
        _close(a, b)
        pad = ~mask.numpy() if heads == 1 else ~mask.numpy()[..., None]
        assert (a.numpy()[np.broadcast_to(pad, a.shape)] == 0).all()


@pytest.mark.parametrize("parts", (2, 4))
def test_attention_chain_grads_match_jax(parts):
    """halo_gat_attention -> halo_spmm with the alphas as runtime values:
    the output and the gradients of feat, a_src and a_dst."""
    _, mat = random_csr(40, 40, density=0.15, seed=11)
    jh = jax_build(jax_csr(mat), parts, tiled=True, chunk_nnz=16,
                   rows_per_block=16)
    th = build_halo_partition(csr_from_scipy(mat), parts, device="cpu")
    jm, tm = _meshes(parts)
    rng = np.random.default_rng(parts)
    feat = _pad(rng.standard_normal((40, 8)).astype(np.float32), parts * th.cpp)
    a_src = rng.standard_normal(8).astype(np.float32)
    a_dst = rng.standard_normal(8).astype(np.float32)
    g = rng.standard_normal((parts * th.rpp, 8)).astype(np.float32)

    def jloss(f, s, d):
        ad, ah = jedge.halo_gat_attention(jh, f, s, d, jm)
        out = jax_halo_spmm(jh, f, jm, diag_vals=ad, halo_vals=ah,
                            model_axis=None)
        return jnp.vdot(out, jnp.asarray(g)), out

    (_, jout), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        _place(jm, feat), jnp.asarray(a_src), jnp.asarray(a_dst))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (feat, a_src, a_dst)]
    ad, ah = tedge.halo_gat_attention(th, *leaves, tm)
    tout = halo_spmm(th, leaves[0], tm, diag_vals=ad, halo_vals=ah)
    (tout * torch.from_numpy(g)).sum().backward()
    _close(tout.detach(), jout)
    for leaf, want in zip(leaves, jg):
        _close(leaf.grad, want, 1e-4, grad=True)


def test_dryrun_multichip_on_the_cpu():
    losses = dryrun_multichip(4, device="cpu")
    assert set(losses) == {"gcn", "gat"}
    assert all(np.isfinite(v) for v in losses.values())


def test_import_parallel_does_not_pull_in_jax():
    code = ("import sys, gespmm_tpu_torch.parallel, "
            "gespmm_tpu_torch.parallel.edge_ops, "
            "gespmm_tpu_torch.parallel.train_step, "
            "gespmm_tpu_torch.parallel.dryrun; "
            "print('jax' in sys.modules, 'gespmm_tpu' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root).stdout.split()
    assert out == ["False", "False"]
