"""Port parity: formats, ingest, generators and Adjacency arrays.

Each test builds its inputs with numpy from a seed, runs the JAX package's
function and the port's on them, and requires the arrays to be EQUAL (these
are index manipulations and copies: no rounding is involved).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from gespmm_tpu.ops import graph as jgraph
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.sparse import formats as jf
from gespmm_tpu.sparse import io as jio
from gespmm_tpu.utils import datasets as jds

from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse import io as tio
from gespmm_tpu_torch.utils import datasets as tds


def scipy_csr(m, n, density, seed, empty_rows=()):
    rng = np.random.default_rng(seed)
    mat = sp.random(m, n, density=density, format="csr", random_state=rng,
                    dtype=np.float64).astype(np.float32)
    if len(empty_rows):
        mat = mat.tolil()
        for r in empty_rows:
            mat[r, :] = 0
        mat = mat.tocsr()
        mat.eliminate_zeros()
    mat.sort_indices()
    return mat


def both_csr(mat, binary=False):
    """The same CSR as a JAX container and as a port container."""
    indptr = mat.indptr.astype(np.int32)
    indices = mat.indices.astype(np.int32)
    data = None if binary else mat.data.astype(np.float32)
    j = jf.CSR(jnp.asarray(indptr), jnp.asarray(indices),
               None if data is None else jnp.asarray(data), mat.shape)
    t = tf.CSR(torch.from_numpy(indptr), torch.from_numpy(indices),
               None if data is None else torch.from_numpy(data), mat.shape)
    return j, t


def eq(a, b):
    """Exact equality of a JAX/numpy array and a torch tensor (or None)."""
    if a is None or b is None:
        assert a is None and b is None
        return
    b = b.detach().cpu().numpy()
    a = np.asarray(a)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def eq_csr(j, t):
    assert tuple(j.shape) == tuple(t.shape)
    eq(j.indptr, t.indptr)
    eq(j.indices, t.indices)
    eq(j.data, t.data)


@pytest.mark.parametrize("seed,m,n", [(0, 30, 40), (1, 64, 17), (2, 1, 5)])
def test_csr_from_coo_equal(seed, m, n):
    mat = scipy_csr(m, n, 0.15, seed, empty_rows=[0] if m > 1 else ()).tocoo()
    row, col = mat.row.astype(np.int32), mat.col.astype(np.int32)
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], mat.data[order]
    j = jf.csr_from_coo(jf.COO(jnp.asarray(row), jnp.asarray(col),
                               jnp.asarray(val), (m, n)))
    t = tf.csr_from_coo(tf.COO(torch.from_numpy(row), torch.from_numpy(col),
                               torch.from_numpy(val), (m, n)))
    eq_csr(j, t)
    assert t.indptr.dtype == torch.int32 and t.indices.dtype == torch.int32


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("seed,m,n", [(3, 40, 33), (4, 25, 60)])
def test_csr_to_csc_and_perm_equal(seed, m, n, binary):
    j, t = both_csr(scipy_csr(m, n, 0.2, seed, empty_rows=[1, 7]), binary)
    jcsc, jperm = jf.csr_to_csc(j, return_permutation=True)
    tcsc, tperm = tf.csr_to_csc(t, return_permutation=True)
    eq(jcsc.indptr, tcsc.indptr)
    eq(jcsc.indices, tcsc.indices)
    eq(jcsc.data, tcsc.data)
    eq(jperm, tperm)
    assert tcsc.shape == (m, n)
    # Transpose round trip and the helpers built on the same arrays.
    eq_csr(jf.transpose(j), tf.transpose(t))
    eq(j.row_ids(), t.row_ids())
    eq(jf.out_degrees(j), tf.out_degrees(t))
    eq(jf.in_degrees(j), tf.in_degrees(t))
    eq(jf.expand_indptr(j.indptr, j.nnz), tf.expand_indptr(t.indptr, t.nnz))


def test_csr_from_scipy_and_todense_equal():
    mat = scipy_csr(20, 30, 0.2, 5)
    j, t = jf.csr_from_scipy(mat), tf.csr_from_scipy(mat)
    eq_csr(j, t)
    eq(j.todense(), t.todense())


@pytest.mark.parametrize("binary", [False, True])
def test_adjacency_arrays_equal(binary):
    j, t = both_csr(scipy_csr(48, 40, 0.12, 6, empty_rows=[0, 5, 47]), binary)
    ja, ta = JAdjacency.from_csr(j), TAdjacency.from_csr(t)
    eq_csr(ja.csr, ta.csr)
    eq(ja.csc.indptr, ta.csc.indptr)
    eq(ja.csc.indices, ta.csc.indices)
    eq(ja.csc.data, ta.csc.data)
    for name in ("perm", "inv_perm", "rows", "rows_t"):
        eq(getattr(ja, name), getattr(ta, name))
    jt, tt = ja.transpose(), ta.transpose()
    eq_csr(jt.csr, tt.csr)
    eq(jt.perm, tt.perm)
    if not binary:
        vals = np.random.default_rng(6).standard_normal(j.nnz).astype(np.float32)
        jw, tw = ja.with_data(jnp.asarray(vals)), ta.with_data(torch.from_numpy(vals))
        eq(jw.csc.data, tw.csc.data)


@pytest.mark.parametrize("binary", [False, True])
def test_add_self_loops_equal(binary):
    mat = scipy_csr(36, 36, 0.1, 7, empty_rows=[3])
    mat.setdiag(2.0)  # existing diagonal entries are replaced
    mat.sort_indices()
    j, t = both_csr(mat, binary)
    js, ts = jgraph.add_self_loops(j), tgraph.add_self_loops(t)
    eq_csr(js, ts)
    assert ts.data is not None  # a binary input comes back valued
    with pytest.raises(ValueError):
        tgraph.add_self_loops(both_csr(scipy_csr(4, 5, 0.5, 0))[1])


@pytest.mark.parametrize("scale,edge_factor,seed", [(7, 4, 0), (9, 8, 3)])
def test_rmat_graph_equal(scale, edge_factor, seed):
    eq_csr(jds.rmat_graph(scale, edge_factor=edge_factor, seed=seed),
           tds.rmat_graph(scale, edge_factor=edge_factor, seed=seed))


@pytest.mark.parametrize("n_per_class,num_classes,seed", [(50, 3, 0), (30, 4, 2)])
def test_sbm_graph_equal(n_per_class, num_classes, seed):
    kw = dict(n_per_class=n_per_class, num_classes=num_classes, p_in=0.1,
              p_out=0.01, feat_dim=16, seed=seed)
    j, t = jds.sbm_graph(**kw), tds.sbm_graph(**kw)
    eq_csr(j.csr, t.csr)
    eq(j.features, t.features)
    np.testing.assert_array_equal(np.asarray(j.labels), t.labels.numpy())
    for k in ("train", "val", "test"):
        eq(j.masks[k], t.masks[k])
    assert (j.num_classes, j.name) == (t.num_classes, t.name)


@pytest.mark.parametrize("symmetry", ["general", "symmetric"])
def test_read_mtx_equal(tmp_path, symmetry):
    mat = scipy_csr(12, 12, 0.3, 8).tocoo()
    path = str(tmp_path / "g.mtx")
    jio.write_mtx(path, mat.row, mat.col, mat.data, mat.shape, symmetry=symmetry)
    j = jio.read_mtx(path, use_native=False)
    t = tio.read_mtx(path)
    eq(j.row, t.row)
    eq(j.col, t.col)
    eq(j.data, t.data)
    eq_csr(jio.read_mtx_csr(path, binary=True, use_native=False),
           tio.read_mtx_csr(path, binary=True))


def test_load_mtx_graph_finds_dataset_dir(tmp_path, monkeypatch):
    mat = scipy_csr(10, 10, 0.3, 9).tocoo()
    tio.write_mtx(str(tmp_path / "tiny.mtx"), mat.row, mat.col, None, mat.shape)
    monkeypatch.setenv("GESPMM_TPU_DATA", str(tmp_path))
    assert tio.default_dataset_dir() == str(tmp_path)
    assert tds.find_graph("tiny") == str(tmp_path / "tiny.mtx")
    assert tds.find_graph("absent") is None
    eq_csr(jds.load_mtx_graph("tiny"), tds.load_mtx_graph("tiny"))
    with pytest.raises(FileNotFoundError):
        tds.load_mtx_graph("absent")
