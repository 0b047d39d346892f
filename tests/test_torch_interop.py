"""Port parity: ``ops/interop.py`` (torch.sparse interop, ``AdjacencyMatrix``), ``coo_from_dense`` and the headline line.

The same scipy matrices (from a numpy seed) go through the JAX package's
``AdjacencyMatrix.from_csr(csr, plan=False)`` (its XLA tier) and the port's.
Forward within 1e-5·max|ref| + 1e-6, gradients within 1e-4·max(|ref|, 1).
Round trips through ``torch.sparse`` are held to scipy, with duplicates and
unsorted COO input.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.ops import interop as jinterop
from gespmm_tpu.sparse import formats as jformats

from gespmm_tpu_torch.bench import headline as theadline
from gespmm_tpu_torch.ops import interop as tinterop
from gespmm_tpu_torch.sparse import formats as tformats
from gespmm_tpu_torch.utils.datasets import rmat_graph
from tests.conftest import random_csr


def close_fwd(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


def close_grad(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


@pytest.fixture(scope="module")
def mats():
    """(JAX AdjacencyMatrix, port AdjacencyMatrix, scipy CSR) of a valued
    48 x 40 matrix."""
    jcsr, mat = random_csr(48, 40, density=0.12, seed=61)
    return (jinterop.AdjacencyMatrix.from_csr(jcsr, plan=False),
            tinterop.AdjacencyMatrix.from_scipy(mat), mat)


def test_round_trip_through_torch_sparse_matches_scipy():
    _, mat = random_csr(23, 31, density=0.15, seed=0)
    csr = tformats.csr_from_scipy(mat)
    t = tinterop.csr_to_torch_sparse(csr)
    assert t.layout == torch.sparse_csr
    assert t.crow_indices().dtype == t.col_indices().dtype == torch.int64
    np.testing.assert_allclose(t.to_dense().numpy(), mat.toarray())
    back = tinterop.csr_from_torch_sparse(t)
    np.testing.assert_array_equal(back.indptr.numpy(), mat.indptr)
    np.testing.assert_array_equal(back.indices.numpy(), mat.indices)
    np.testing.assert_array_equal(back.data.numpy(), mat.data)
    assert back.indptr.dtype == back.indices.dtype == torch.int32
    # Without values: f32 ones.
    ones = tinterop.csr_to_torch_sparse(csr.with_data(None))
    assert ones.values().dtype == torch.float32
    np.testing.assert_array_equal(ones.values().numpy(), 1.0)


def test_unsorted_coo_with_duplicates_is_summed_and_sorted():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 12, 60)
    cols = rng.integers(0, 9, 60)
    vals = rng.standard_normal(60).astype(np.float32)
    want = sp.coo_matrix((vals, (rows, cols)), shape=(12, 9)).tocsr()
    want.sum_duplicates()
    want.sort_indices()
    t = torch.sparse_coo_tensor(torch.from_numpy(np.stack([rows, cols])),
                                torch.from_numpy(vals), (12, 9))
    got = tinterop.csr_from_torch_sparse(t)
    np.testing.assert_array_equal(got.indptr.numpy(), want.indptr)
    np.testing.assert_array_equal(got.indices.numpy(), want.indices)
    np.testing.assert_allclose(got.data.numpy(), want.data, rtol=1e-6)
    # The same matrix handed in as a CSR tensor.
    via_csr = tinterop.csr_from_torch_sparse(t.to_sparse_csr())
    np.testing.assert_array_equal(via_csr.indices.numpy(), want.indices)
    # And the JAX package's canonical form of the same BCOO.
    from jax.experimental import sparse as jsparse

    bcoo = jsparse.BCOO((jnp.asarray(vals), jnp.asarray(np.stack(
        [rows, cols], 1))), shape=(12, 9))
    jcsr = jinterop.csr_from_bcoo(bcoo)
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(jcsr.indptr))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(jcsr.indices))


@pytest.mark.parametrize("case", ["dense", "batched-coo", "hybrid-coo",
                                  "batched-csr"])
def test_csr_from_torch_sparse_refuses(case):
    dense = torch.eye(4)
    if case == "dense":
        with pytest.raises(TypeError, match="expected"):
            tinterop.csr_from_torch_sparse(dense)
        with pytest.raises(TypeError, match="expected"):
            tinterop.csr_from_torch_sparse(np.eye(4))
        return
    t = {"batched-coo": lambda: torch.stack([dense, dense]).to_sparse(),
         "hybrid-coo": lambda: torch.ones(4, 4, 2).to_sparse(2),
         "batched-csr": lambda: torch.stack([dense, dense]).to_sparse_csr()
         }[case]()
    with pytest.raises(ValueError, match="only plain 2-D"):
        tinterop.csr_from_torch_sparse(t)


def test_baseline_matches_bcoo_baseline():
    jcsr, mat = random_csr(30, 28, density=0.12, seed=1)
    B = np.random.default_rng(1).standard_normal((28, 8)).astype(np.float32)
    want = jinterop.bcoo_spmm_baseline(jcsr, jnp.asarray(B))
    got = tinterop.torch_sparse_spmm_baseline(tformats.csr_from_scipy(mat),
                                              torch.from_numpy(B))
    close_fwd(got, want)
    close_fwd(got, mat @ B)


def test_adjacency_matrix_surface(mats):
    JA, TA, mat = mats
    assert TA.shape == JA.shape == (48, 40) and TA.ndim == 2
    assert TA.nse == TA.nnz == mat.nnz and TA.dtype == torch.float32
    assert TA.T.shape == (40, 48) and TA.T.T.shape == TA.shape
    assert TA.transpose().shape == TA.T.shape
    assert repr(TA) == "AdjacencyMatrix(48x40, nse=%d, dtype=torch.float32)" \
        % mat.nnz
    close_fwd(TA.to_dense(), JA.todense())
    close_fwd(TA.T.to_dense(), JA.T.todense())
    back = tinterop.csr_from_torch_sparse(TA.to_torch_sparse())
    np.testing.assert_array_equal(back.indices.numpy(), mat.indices)
    with pytest.raises(ValueError, match="untransposed"):
        TA.T.with_data(TA.adj.data)


def test_adjacency_matrix_products_match_jax(mats):
    JA, TA, _ = mats
    rng = np.random.default_rng(62)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    v = rng.standard_normal(40).astype(np.float32)
    y = rng.standard_normal((48, 8)).astype(np.float32)
    u = rng.standard_normal(48).astype(np.float32)
    tx, tv, ty, tu = map(torch.from_numpy, (x, v, y, u))
    jx, jv, jy, ju = map(jnp.asarray, (x, v, y, u))
    close_fwd(TA @ tx, JA @ jx)
    close_fwd(TA @ tv, JA @ jv)
    close_fwd(TA.T @ ty, JA.T @ jy)
    close_fwd(TA.T @ tu, JA.T @ ju)
    # x @ A: torch.Tensor.__matmul__ returns NotImplemented for the foreign
    # type, so Python reaches AdjacencyMatrix.__rmatmul__.
    assert torch.Tensor.__matmul__(ty.t(), TA) is NotImplemented
    close_fwd(ty.t() @ TA, jy.T @ JA)
    close_fwd(tu @ TA, ju @ JA)
    close_fwd(tx.t() @ TA.T, jx.T @ JA.T)
    # with_data scales the values.
    d = np.asarray(JA.adj.csr.data) * 2.0
    close_fwd(TA.with_data(torch.from_numpy(d)) @ tx,
              JA.with_data(jnp.asarray(d)) @ jx)


def test_adjacency_matrix_gradients_match_jax(mats):
    JA, TA, _ = mats
    rng = np.random.default_rng(63)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    y = rng.standard_normal((5, 48)).astype(np.float32)
    g1 = rng.standard_normal((48, 8)).astype(np.float32)
    g2 = rng.standard_normal((5, 40)).astype(np.float32)
    d = np.asarray(JA.adj.csr.data)

    def jloss(d, x):
        A = JA.with_data(d)
        return jnp.sum((A @ x) * g1) + jnp.sum((jnp.asarray(y) @ A) * g2)

    jgd, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(d), jnp.asarray(x))
    td = torch.from_numpy(d.copy()).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    A = TA.with_data(td)
    loss = ((A @ tx) * torch.from_numpy(g1)).sum() \
        + ((torch.from_numpy(y) @ A) * torch.from_numpy(g2)).sum()
    loss.backward()
    close_grad(tx.grad, jgx)
    close_grad(td.grad, jgd)


def test_coo_from_dense_matches_jax():
    rng = np.random.default_rng(7)
    d = rng.standard_normal((9, 7)).astype(np.float32)
    d[rng.random((9, 7)) < 0.6] = 0
    want = jformats.coo_from_dense(jnp.asarray(d))
    got = tformats.coo_from_dense(torch.from_numpy(d))
    for a, b in ((got.row, want.row), (got.col, want.col),
                 (got.data, want.data)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.row.dtype == got.col.dtype == torch.int32
    assert got.shape == (9, 7)


def test_headline_prints_one_json_line(capsys, monkeypatch):
    rec = theadline.headline(rmat_graph(scale=8, edge_factor=8, seed=0),
                             "rmat8", device="cpu", iters=3)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "spmm_gflops_rmat8_k128"
    assert rec["unit"] == "GFLOP/s" and rec["value"] > 0
    assert rec["vs_baseline"] > 0
    # The CLI: one line, the same four keys.
    monkeypatch.setattr(theadline, "headline",
                        lambda device: dict(rec, device=device))
    theadline.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["device"] == "cpu"


def test_new_modules_do_not_pull_in_jax():
    code = ("import sys, gespmm_tpu_torch.ops.interop, "
            "gespmm_tpu_torch.models.baselines, "
            "gespmm_tpu_torch.models.sage_lstm, "
            "gespmm_tpu_torch.train.checkpoint, gespmm_tpu_torch.train.loop, "
            "gespmm_tpu_torch.bench.headline, gespmm_tpu_torch.bench.gcn_bench, "
            "gespmm_tpu_torch.bench.gat_bench, "
            "gespmm_tpu_torch.bench.sage_bench; "
            "print('jax' in sys.modules, 'gespmm_tpu' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root).stdout.split()
    assert out == ["False", "False"]
