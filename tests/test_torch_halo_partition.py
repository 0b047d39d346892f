"""The sharded tier's host pre-pass against the JAX package's.

``build_halo_partition`` and ``partition_adjacency`` of the port and of
``gespmm_tpu.parallel`` run on the same CSR; every array must be equal
(values, shapes and dtypes), at P in {1, 2, 4, 8}, on a skewed graph, an SBM
graph, m not divisible by P, a rectangular matrix and a binary one.  The
port's own arrays (each block's transpose, the one-process exchange's
gather, the merge index) are held to their definitions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.parallel.dist_spmm import partition_adjacency as jax_partition
from gespmm_tpu.parallel.edge_ops import merge_edge_values as jax_merge
from gespmm_tpu.parallel.halo import build_halo_partition as jax_build
from gespmm_tpu.parallel.halo import split_edge_values as jax_split
from gespmm_tpu.sparse.formats import csr_from_scipy as jax_csr
from gespmm_tpu_torch.parallel import (build_halo_partition,
                                       partition_adjacency)
from gespmm_tpu_torch.parallel.edge_ops import merge_edge_values
from gespmm_tpu_torch.parallel.halo import split_edge_values
from gespmm_tpu_torch.sparse.formats import csr_from_scipy
from gespmm_tpu_torch.utils.datasets import sbm_graph
from tests.conftest import powerlaw_csr

PARTS = (1, 2, 4, 8)
HALO_FIELDS = ("send_idx", "diag_indptr", "diag_indices", "diag_data",
               "diag_mask", "diag_src", "halo_indptr", "halo_indices",
               "halo_data", "halo_mask", "halo_src", "deg")


def _random(m, n, density, seed):
    rng = np.random.default_rng(seed)
    mat = sp.random(m, n, density=density, random_state=rng, format="csr",
                    dtype=np.float64)
    mat.data = rng.standard_normal(mat.nnz)
    return mat.astype(np.float32)


def _sbm():
    csr = sbm_graph(n_per_class=24, num_classes=3, p_in=0.2, p_out=0.02,
                    feat_dim=4, seed=1).csr
    n = csr.shape[0]
    return sp.csr_matrix((np.ones(csr.nnz, np.float32), csr.indices.numpy(),
                          csr.indptr.numpy()), shape=(n, n))


GRAPHS = {
    "powerlaw": lambda: powerlaw_csr(100, 100, avg_deg=6, seed=5)[1],
    "sbm": _sbm,
    "uneven": lambda: _random(90, 90, 0.08, 2),  # 90 rows over 4 and 8
    "rect": lambda: _random(60, 44, 0.12, 3),
    "binary": lambda: _random(64, 64, 0.1, 4),
}


def _pair(graph):
    """(JAX CSR, port CSR, scipy matrix) of one graph; "binary" drops the
    values in both."""
    mat = GRAPHS[graph]().tocsr()
    mat.sort_indices()
    j, t = jax_csr(mat), csr_from_scipy(mat)
    if graph == "binary":
        j, t = j.with_data(None), t.with_data(None)
    return j, t, mat


def _assert_same(name, jax_arr, port_arr):
    if jax_arr is None:
        assert port_arr is None, name
        return
    a, b = np.asarray(jax_arr), port_arr.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_halo_partition_equals_jax(graph, parts):
    j, t, _ = _pair(graph)
    jh = jax_build(j, parts, tiled=False)
    th = build_halo_partition(t, parts, device="cpu")
    for name in HALO_FIELDS:
        _assert_same(name, getattr(jh, name), getattr(th, name))
    assert th.shape == tuple(jh.shape) and th.rounds == jh.rounds
    assert (th.rpp, th.cpp, th.num_parts) == (jh.rpp, jh.cpp, jh.num_parts)
    assert (th.H, th.halo_rows) == (jh.H, jh.halo_rows)
    assert th.footprint_fraction == jh.footprint_fraction


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partition_adjacency_equals_jax(graph, parts):
    j, t, mat = _pair(graph)
    jp = jax_partition(j, parts)
    tp = partition_adjacency(t, parts, device="cpu")
    for name in ("indptr", "indices", "data", "mask"):
        _assert_same(name, getattr(jp, name), getattr(tp, name))
    assert tp.shape == tuple(jp.shape) and tp.num_parts == jp.num_parts
    assert tp.rows_per_part == jp.rows_per_part
    # Each slab's Adjacency is the slab of A.
    rpp = tp.rows_per_part
    for p, adj in enumerate(tp.slabs):
        want = mat[p * rpp: (p + 1) * rpp].toarray()
        got = adj.csr.todense().numpy()[: want.shape[0]]
        if graph == "binary":
            want = (want != 0).astype(np.float32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parts", (2, 4, 8))
@pytest.mark.parametrize("graph", ("powerlaw", "rect", "binary"))
def test_block_transposes_and_gather(graph, parts):
    """Each block's transpose is its CSC (colptr, row ids in row order, the
    map back to the block's edges); the one-process gather delivers each
    halo column's global B row."""
    _, t, mat = _pair(graph)
    th = build_halo_partition(t, parts, device="cpu")
    for p in range(parts):
        blk = th.blocks(p)
        for indptr, indices, t_indptr, t_rows, t_map, cols in (
                (blk.d_indptr, blk.d_indices, blk.d_t_indptr, blk.d_t_rows,
                 blk.d_t_map, th.cpp),
                (blk.h_indptr, blk.h_indices, blk.h_t_indptr, blk.h_t_rows,
                 blk.h_t_map, th.halo_rows)):
            nnz = indices.shape[0]
            block = sp.csr_matrix((np.arange(1, nnz + 1, dtype=np.float64),
                                   indices.numpy(), indptr.numpy()),
                                  shape=(th.rpp, cols)).tocsc()
            np.testing.assert_array_equal(t_indptr.numpy(), block.indptr)
            np.testing.assert_array_equal(t_rows.numpy(), block.indices)
            np.testing.assert_array_equal(t_map.numpy() + 1, block.data)
        # Halo column c of shard p holds global B row halo_gather[p, c]:
        # every halo edge's global column id is its gathered row.
        gids = th.halo_src[p, : th.halo_nnz[p]].numpy()
        cols_global = mat.indices[gids]
        gathered = th.halo_gather[p].numpy()[blk.h_indices.numpy()]
        np.testing.assert_array_equal(gathered, cols_global)
        assert (gathered < th.num_parts * th.cpp).all()


@pytest.mark.parametrize("heads", (1, 3))
@pytest.mark.parametrize("parts", (1, 4, 8))
def test_split_merge_round_trip_equals_jax(parts, heads):
    j, t, mat = _pair("powerlaw")
    jh = jax_build(j, parts, tiled=False)
    th = build_halo_partition(t, parts, device="cpu")
    rng = np.random.default_rng(parts)
    shape = (mat.nnz,) if heads == 1 else (mat.nnz, heads)
    vals = rng.standard_normal(shape).astype(np.float32)
    jdv, jhv = jax_split(jh, jnp.asarray(vals))
    tdv, thv = split_edge_values(th, torch.from_numpy(vals))
    _assert_same("diag_vals", jdv, tdv)
    _assert_same("halo_vals", jhv, thv)
    np.testing.assert_array_equal(merge_edge_values(th, tdv, thv).numpy(), vals)
    np.testing.assert_array_equal(np.asarray(jax_merge(jh, jdv, jhv)), vals)
