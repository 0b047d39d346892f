"""Port parity: spmm(reduce="max"|"min"), its tie counts and its gradients, against the JAX package.

Inputs are built with numpy from a seed and fed to both packages.  The JAX
side runs through a plain ``Adjacency`` (the XLA tier) and through a tiled
plan with ``minmax_aligned=False``, which runs the Pallas scan kernel
(``_reduce_kernel``'s max/min branch) in interpret mode, as
``tests/test_stream.py`` does.  The port runs on the CPU here, i.e. through
the kernels' plain versions.  Tolerances: max/min select one contribution,
formed as the same f32 product on both sides, so the forward is exact
against the XLA tier and within 1e-6 of the tiled tier (its one-hot matmul
scatter); tie counts are exact; gradients rtol 1e-4, atol 1e-5, as in the
JAX package's own tests.  The CUDA kernels are checked in
``tests/test_torch_cuda.py``; their launch counters here, with the entry
points and the card stood in for.
"""

import contextlib
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gespmm_tpu.kernels.spmm_stream import spmm_tiled
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.ops.spmm import spmm as jspmm

from gespmm_tpu_torch.kernels import spmm_minmax as kmm
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.ops.spmm import spmm as tspmm
from gespmm_tpu_torch.sparse import formats as tf
from tests.test_torch_spmm import EMPTY_ROWS, PLAN, M, N, dense_B, graph

SCAN_PLAN = dict(PLAN, minmax_aligned=False)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def quantized_B(K, seed=1, rows=N):
    """Multiples of 0.5, so that several edges achieve a row's max/min."""
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((rows, K)) * 2).astype(np.float32) / 2


def dense_recount(t, B, reduce):
    """(out, ties) by a dense numpy recount over the port CSR ``t``."""
    A = t.todense().numpy()
    mask = np.zeros((M, N), bool)
    mask[t.row_ids().numpy(), t.indices.numpy()] = True
    contrib = np.where(mask[:, :, None], A[:, :, None] * B[None], np.nan)
    red = np.nanmax if reduce == "max" else np.nanmin
    with warnings.catch_warnings():  # an empty row is an all-NaN slice
        warnings.simplefilter("ignore", RuntimeWarning)
        best = red(contrib, axis=1)
    ties = np.sum(contrib == best[:, None, :], axis=1).astype(np.float32)
    return np.where(np.isnan(best), 0.0, best).astype(np.float32), ties


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 3, 16, 130])
def test_minmax_matches_jax_xla(K, binary, reduce):
    j, t = graph(binary)
    B = dense_B(K)
    ref = np.asarray(jspmm(JAdjacency.from_csr(j), jnp.asarray(B),
                           reduce=reduce, method="xla"))
    for method in ("auto", "tiled", "xla"):
        out = tspmm(TAdjacency.from_csr(t), torch.from_numpy(B),
                    reduce=reduce, method=method)
        assert out.dtype == torch.float32 and out.shape == (M, K)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=0)
        assert not out.numpy()[list(EMPTY_ROWS)].any()


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 3, 16, 130])
def test_minmax_matches_jax_scan_kernel(K, binary, reduce):
    j, t = graph(binary)
    B = dense_B(K)
    ref = jspmm(JAdjacency.from_csr(j, plan=True, **SCAN_PLAN), jnp.asarray(B),
                reduce=reduce, method="tiled")
    out = tspmm(TAdjacency.from_csr(t), torch.from_numpy(B), reduce=reduce)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("binary", [False, True])
def test_tie_counts_match_a_dense_recount_and_the_scan_kernel(binary, reduce):
    j, t = graph(binary, seed=3)
    B = quantized_B(8, seed=3)
    out, ties = kmm.spmm_minmax(t.indptr, t.indices, t.data,
                                torch.from_numpy(B), reduce)
    want_out, want_ties = dense_recount(t, B, reduce)
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(ties.numpy(), want_ties)
    assert ties.max() > 1, "the test graph has no ties"
    assert not ties.numpy()[list(EMPTY_ROWS)].any()
    jplan = JAdjacency.from_csr(j, plan=True, **SCAN_PLAN).plan
    jout, jties = spmm_tiled(jplan, j.data, jnp.asarray(B), M, interpret=True,
                             reduce=reduce, want_ties=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ties.numpy(), np.asarray(jties))


def _jax_grads(adj, data, B, W, reduce, method):
    def loss(d, b):
        a = adj if d is None else adj.with_data(d)
        return jnp.sum(jnp.sin(jspmm(a, b, reduce=reduce, method=method)) * W)

    if data is None:
        return None, jax.grad(lambda b: loss(None, b))(B)
    return jax.grad(loss, argnums=(0, 1))(data, B)


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("jax_tier", ["xla", "tiled"])
def test_grads_with_ties_match_jax(jax_tier, binary, reduce):
    j, t = graph(binary, seed=2)
    K = 8
    # relu'd quantized B: zeros and equal values make many ties.
    B, W = np.maximum(quantized_B(K, seed=4), 0), dense_B(K, seed=5, rows=M)
    jadj = (JAdjacency.from_csr(j, plan=True, **SCAN_PLAN)
            if jax_tier == "tiled" else JAdjacency.from_csr(j))
    jgd, jgB = _jax_grads(jadj, j.data, jnp.asarray(B), jnp.asarray(W), reduce,
                          jax_tier)
    _, ties = kmm.spmm_minmax(t.indptr, t.indices, t.data, torch.from_numpy(B),
                              reduce)
    assert ties.max() > 1
    for method in ("auto", "xla"):
        tadj = TAdjacency.from_csr(t)
        Bt = torch.from_numpy(B).requires_grad_(True)
        if not binary:
            d = t.data.clone().requires_grad_(True)
            tadj = tadj.with_data(d)
        out = tspmm(tadj, Bt, reduce=reduce, method=method)
        (torch.sin(out) * torch.from_numpy(W)).sum().backward()
        np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(jgB), **GRAD_TOL)
        if not binary:
            np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgd),
                                       **GRAD_TOL)


@pytest.mark.parametrize("wants", ["B", "values", "both"])
def test_backward_gives_only_the_gradients_asked_for(wants):
    _, t = graph(False, seed=6)
    adj = TAdjacency.from_csr(t)
    B = torch.from_numpy(quantized_B(4, seed=6)).requires_grad_(wants != "values")
    d = t.data.clone().requires_grad_(wants != "B")
    tspmm(adj.with_data(d), B, reduce="max").sum().backward()
    assert (B.grad is not None) == (wants != "values")
    assert (d.grad is not None) == (wants != "B")


def test_plain_backward_equals_the_jax_style_vjp_when_ties_agree():
    # The kernel's plain backward (CSC walk, forward's ties) against the
    # CSR-side per-edge VJP (ties recounted against out), both in the port.
    _, t = graph(False, seed=7)
    adj = TAdjacency.from_csr(t)
    B = torch.from_numpy(np.maximum(quantized_B(6, seed=7), 0))
    g = torch.from_numpy(dense_B(6, seed=8, rows=M))
    out, ties = kmm.spmm_minmax(t.indptr, t.indices, t.data, B, "max")
    grad_B, grad_vals = kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices,
                                            adj.csc.data, B, out, g, ties)
    edge = tref.spmm_max_vjp_edges(adj.rows, t.indices, t.data, B, out, g, M)
    want_B = torch.zeros_like(B).index_add_(0, t.indices.long(),
                                            edge * t.data[:, None])
    want_vals = (edge * B[t.indices.long()]).sum(-1)
    torch.testing.assert_close(grad_B, want_B, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grad_vals[adj.inv_perm.long()], want_vals,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("binary", [False, True])
def test_bf16_in_bf16_out(binary):
    j, t = graph(binary)
    Bb = torch.from_numpy(quantized_B(16)).to(torch.bfloat16)
    adj = TAdjacency.from_csr(t)
    for reduce in ("max", "min"):
        out = tspmm(adj, Bb, reduce=reduce)
        assert out.dtype == torch.bfloat16
        # The f32 extremum of the same f32 products, rounded once.
        want = tspmm(adj, Bb.float(), reduce=reduce).to(torch.bfloat16)
        assert torch.equal(out, want)
        if binary:  # the contributions are B's own bf16 values: exact
            ref = jspmm(JAdjacency.from_csr(j), jnp.asarray(Bb.float().numpy()),
                        reduce=reduce, method="xla")
            np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref))


def test_wrappers_on_cpu_use_the_plain_versions_without_launching():
    _, t = graph(False)
    adj = TAdjacency.from_csr(t)
    B = torch.from_numpy(quantized_B(5))
    g = torch.from_numpy(dense_B(5, rows=M))
    before = (kmm.launches, kmm.vjp_launches)
    out, ties = kmm.spmm_minmax(t.indptr, t.indices, t.data, B, "min")
    grad_B, grad_vals = kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices,
                                            adj.csc.data, B, out, g, ties)
    assert (kmm.launches, kmm.vjp_launches) == before
    want, want_ties = tref.spmm_minmax_rows(adj.rows, t.indices, t.data, B, M,
                                            "min")
    assert torch.equal(out, want) and torch.equal(ties, want_ties)
    want_B, want_vals = tref.spmm_minmax_vjp_cols(
        adj.rows_t, adj.csc.indices, adj.csc.data, B, out,
        g / torch.clamp(ties, min=1.0))
    assert torch.equal(grad_B, want_B) and torch.equal(grad_vals, want_vals)
    with pytest.raises(ValueError, match="max"):
        kmm.spmm_minmax(t.indptr, t.indices, None, B, "sum")


def test_non_contiguous_B_is_a_valid_operand():
    _, t = graph(False)
    adj = TAdjacency.from_csr(t)
    full = torch.from_numpy(dense_B(40))
    for B in (full[:, :16], torch.from_numpy(dense_B(N, rows=16)).t()):
        assert not B.is_contiguous()
        for reduce in ("sum", "max"):
            torch.testing.assert_close(tspmm(adj, B, reduce=reduce),
                                       tspmm(adj, B.contiguous(), reduce=reduce))


@pytest.mark.parametrize("m,n,K", [(5, 6, 0), (0, 6, 3), (5, 6, 3)])
def test_minmax_on_empty_work(m, n, K):
    csr = tf.CSR(torch.zeros(m + 1, dtype=torch.int32),
                 torch.zeros(0, dtype=torch.int32), None, (m, n))
    B = torch.ones(n, K, requires_grad=True)
    out = tspmm(TAdjacency.from_csr(csr), B, reduce="min")
    assert out.shape == (m, K) and not out.any()
    out.sum().backward()
    assert not B.grad.any()


@pytest.mark.parametrize("K,slabs", [(100, 1), (256, 2)])
def test_edge_walks_count_the_slabs_each_launch_walks(K, slabs, monkeypatch):
    """Each launch of row 2 (forward) and row 3 (backward) walks the edges
    once a K slab of ``walk_shape``'s SW·VEC columns: K = 100 one slab of
    32 lanes of 4, K = 256 two.  ``reset_launches`` clears the walks with
    the launches.  The entry points and the card are stood in for."""
    calls = []

    def entry(kind, dtype):
        def fn(*args):
            calls.append(kind)
            return 0
        return fn, None

    monkeypatch.setattr(kmm, "_entry", entry)
    monkeypatch.setattr(kmm, "check_operands", lambda *a: None)
    monkeypatch.setattr(kmm, "_check_dense", lambda B: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    _, t = graph(True)
    adj = TAdjacency.from_csr(t)
    B = torch.from_numpy(quantized_B(K))
    assert kmm.walk_shape(K, 1, B) == (4, 32)
    kmm.reset_launches()
    out, ties = kmm.spmm_minmax_cuda(adj.csr.indptr, adj.csr.indices, None,
                                     B, "max", adj.split)
    kmm.spmm_minmax_vjp_cuda(adj.csc.indptr[None], adj.csc.indices[None],
                             None, B, out, torch.zeros_like(out), ties, False,
                             adj.split_t, 0, 0, False)
    assert calls == ["fwd", "vjp"]
    assert (kmm.launches, kmm.vjp_launches) == (1, 1)
    assert (kmm.edge_walks, kmm.vjp_edge_walks) == (slabs, slabs)
    kmm.reset_launches()
    assert (kmm.edge_walks, kmm.vjp_edge_walks) == (0, 0)
