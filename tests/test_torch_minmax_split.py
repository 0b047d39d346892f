"""Kernel row 3 (the max/min SpMM backward) with its column split, on the CPU.

The backward kernel walks a column of more than L edges in segments of L
consecutive edges and adds the segments' partial sums into the column in
segment order (a carry); one launch also covers the stacked transposed
blocks of every shard a process holds.  On the CPU the wrappers run the
plain versions (``ops/reference.py::spmm_minmax_vjp_split_cols`` and
``spmm_minmax_vjp_split_stacked``), held here to:

* float64 (the unsplit plain version fed a float64 ``g / ties``) and the JAX
  package's VJP, through its XLA tier and through its tiled tier (the
  Pallas scan kernel in interpret mode, as ``tests/test_torch_minmax.py``
  runs it), on a graph whose columns have L - 1, L, L + 1 and 2L + 1 edges
  at L = 4, max and min, binary and valued, with B relu'd multiples of 0.5
  so that ties are common.  Tolerance: rtol 1e-4, atol 1e-5;
* the kernel's order of the sums: each segment summed from 0 edge by edge,
  then the segments added into the column in order, bit for bit against a
  NumPy float32 emulation on values of wide range;
* the op: ``spmm(reduce="max"|"min")``'s backward takes ``adj.split_t``;
* the stacked plain version against the per-shard loop of the unsplit plain
  version that the sharded tier ran before, on a ``HaloPartition`` split at
  L = 4, P in {2, 4}.

Inputs come from numpy seeds.  The kernels themselves are checked in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.ops.spmm import spmm as jspmm
from gespmm_tpu.sparse import formats as jf

from gespmm_tpu_torch.kernels import spmm_minmax as kmm
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.ops.spmm import spmm as tspmm
from gespmm_tpu_torch.parallel import build_halo_partition, make_mesh
from gespmm_tpu_torch.parallel.halo import make_exchange, split_edge_values
from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse.partition import build_row_split
from gespmm_tpu_torch.utils.datasets import split_boundary_graph
from tests.test_torch_spmm import PLAN

L = 4
SCAN_PLAN = dict(PLAN, minmax_aligned=False)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def boundary(binary, seed=0):
    """(JAX CSR, port CSR) of a 120 x 120 graph whose columns 0-4 have L - 1,
    L, L + 1, 2L + 1 and 40 edges, among short random ones."""
    csr = split_boundary_graph(L, hub=40, n=120, seed=seed)
    nnz = csr.indices.shape[0]
    data = (None if binary else np.random.default_rng(seed + 1)
            .standard_normal(nnz).astype(np.float32))
    indptr, indices = csr.indptr.numpy(), csr.indices.numpy()
    j = jf.CSR(jnp.asarray(indptr), jnp.asarray(indices),
               None if data is None else jnp.asarray(data), csr.shape)
    t = tf.CSR(csr.indptr, csr.indices,
               None if data is None else torch.from_numpy(data), csr.shape)
    return j, t


def split_adjacency(t):
    """The port's adjacency of ``t`` with its column split at L."""
    adj = TAdjacency.from_csr(t)
    return dataclasses.replace(adj, split_t=build_row_split(adj.csc.indptr, L))


def relu_half(shape, seed):
    """Relu'd multiples of 0.5: zeros and equal values make many ties."""
    x = np.random.default_rng(seed).standard_normal(shape) * 2
    return np.maximum(np.round(x) / 2, 0).astype(np.float32)


def test_the_boundary_graph_has_each_column_length():
    _, t = boundary(True)
    adj = split_adjacency(t)
    deg = np.diff(adj.csc.indptr.numpy())
    assert deg[:4].tolist() == [L - 1, L, L + 1, 2 * L + 1]
    assert adj.split_t.num_segments > 0
    assert {2, 3, 4} <= set(adj.split_t.long_rows.tolist())


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 16])
def test_split_cols_matches_float64(K, binary, reduce):
    _, t = boundary(binary, seed=K)
    adj = split_adjacency(t)
    B = torch.from_numpy(relu_half((t.shape[1], K), seed=K))
    g = torch.from_numpy(np.random.default_rng(K + 2).standard_normal(
        (t.shape[0], K)).astype(np.float32))
    out, ties = kmm.spmm_minmax(t.indptr, t.indices, t.data, B, reduce)
    assert ties.max() > 1
    csc_data = adj.csc.data
    before = (kmm.vjp_launches, kmm.vjp_carry_launches)
    grad_B, grad_vals = kmm.spmm_minmax_vjp(
        adj.csc.indptr, adj.csc.indices, csc_data, B, out, g, ties,
        cols=adj.rows_t, split=adj.split_t)
    assert (kmm.vjp_launches, kmm.vjp_carry_launches) == before
    want_B, want_vals = tref.spmm_minmax_vjp_cols(
        adj.rows_t, adj.csc.indices, csc_data, B, out,
        g.double() / torch.clamp(ties, min=1.0).double())
    np.testing.assert_allclose(grad_B.numpy(), want_B.numpy(), **GRAD_TOL)
    assert (grad_vals is None) == binary
    if not binary:
        np.testing.assert_allclose(grad_vals.numpy(), want_vals.numpy(),
                                   **GRAD_TOL)


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
def test_split_backward_matches_jax(jax_tier, binary, reduce):
    j, t = boundary(binary, seed=3)
    K = 8
    B, W = relu_half((t.shape[1], K), 4), relu_half((t.shape[0], K), 5) - 0.3
    jadj = (JAdjacency.from_csr(j, plan=True, **SCAN_PLAN)
            if jax_tier == "tiled" else JAdjacency.from_csr(j))
    jgd, jgB = _jax_grads(jadj, j.data, jnp.asarray(B), jnp.asarray(W),
                          reduce, jax_tier)
    adj = split_adjacency(t)
    Bt = torch.from_numpy(B).requires_grad_(True)
    d = None if binary else t.data.clone().requires_grad_(True)
    out = tspmm(adj if binary else adj.with_data(d), Bt, reduce=reduce)
    (torch.sin(out) * torch.from_numpy(W)).sum().backward()
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(jgB), **GRAD_TOL)
    if not binary:
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgd),
                                   **GRAD_TOL)


def _emulate(colptr, w, seg_len, segmented):
    """Each column's sum of the f32 weights ``w`` (CSC order), edge by edge
    from 0, or (``segmented`` order: "in", "reversed") for a column above
    ``seg_len`` edges each segment from 0, then the segments from 0."""
    out = np.zeros(colptr.shape[0] - 1, np.float32)
    for c in range(out.shape[0]):
        s, t = colptr[c], colptr[c + 1]
        parts = [w[a:min(a + seg_len, t)] for a in range(s, t, seg_len)]
        if segmented is None or t - s <= seg_len:
            parts = [w[s:t]]
        sums = []
        for part in parts:
            acc = np.float32(0)
            for x in part:
                acc = np.float32(acc + x)
            sums.append(acc)
        if segmented == "reversed":
            sums = sums[::-1]
        acc = np.float32(0)
        for x in sums:
            acc = np.float32(acc + x)
        out[c] = acc
    return out


def test_split_sums_segments_apart_then_in_segment_order():
    # One output row an edge (a binary graph whose column 0 holds rows 0-10
    # and every other column one row): each edge achieves its row alone, so
    # its weight is g of that row.  The split sum must equal the
    # segment-then-carry emulation bit for bit; column 0's weights are
    # chosen so that the unsplit sum and the reversed carry round apart.
    first = [-1e8, -1e8, -5e7, 1e8, 3, 3, 1, 5, 3, 5e7, 5]
    rng = np.random.default_rng(0)
    m, deg = 24, len(first)
    rows = np.arange(m)
    cols = np.r_[np.zeros(deg, np.int64), np.arange(1, m - deg + 1)]
    mat = sp.csr_matrix((np.ones(m, np.float32), (rows, cols)),
                        shape=(m, m - deg + 1))
    t = tf.csr_from_scipy(mat)
    adj = TAdjacency.from_csr(t)
    split = build_row_split(adj.csc.indptr, L)
    assert split.long_rows.tolist() == [0]
    B = torch.ones(mat.shape[1], 1)
    g = torch.from_numpy(np.r_[first, rng.standard_normal(m - deg)].astype(
        np.float32)[:, None])
    out, ties = kmm.spmm_minmax(t.indptr, t.indices, None, B, "max")
    assert bool((ties == 1).all())
    grad_B, _ = kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices, None, B,
                                    out, g, ties, split=split)
    colptr = adj.csc.indptr.numpy()
    w = g.numpy()[adj.csc.indices.numpy(), 0]
    want = _emulate(colptr, w, L, "in")
    np.testing.assert_array_equal(grad_B.numpy()[:, 0], want)
    assert want[0] != _emulate(colptr, w, L, None)[0]
    assert want[0] != _emulate(colptr, w, L, "reversed")[0]


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_the_op_backward_takes_the_adjacency_split(monkeypatch, reduce):
    _, t = boundary(False, seed=6)
    adj = split_adjacency(t)
    seen = []
    plain = tref.spmm_minmax_vjp_split_cols

    def spy(*args, **kw):
        seen.append(args[7])  # seg_row
        return plain(*args, **kw)

    monkeypatch.setattr(tref, "spmm_minmax_vjp_split_cols", spy)
    B = torch.from_numpy(relu_half((t.shape[1], 4), 6)).requires_grad_(True)
    d = t.data.clone().requires_grad_(True)
    tspmm(adj.with_data(d), B, reduce=reduce).sum().backward()
    assert len(seen) == 1 and seen[0] is adj.split_t.seg_row
    # The same gradients as the op without a split, within rounding.
    B2 = B.detach().clone().requires_grad_(True)
    d2 = t.data.clone().requires_grad_(True)
    unsplit = dataclasses.replace(adj, split_t=build_row_split(
        adj.csc.indptr, 10**6))
    tspmm(unsplit.with_data(d2), B2, reduce=reduce).sum().backward()
    torch.testing.assert_close(B.grad, B2.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d.grad, d2.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("parts", [2, 4])
def test_stacked_plain_matches_the_per_shard_loop(parts, reduce, binary):
    csr = split_boundary_graph(L, hub=40, n=120, seed=parts)
    if not binary:
        csr = csr.with_data(torch.from_numpy(np.random.default_rng(parts)
                                             .standard_normal(csr.nnz)
                                             .astype(np.float32)))
    hp = build_halo_partition(csr, parts, seg_len=L)
    mesh = make_mesh(parts, device="cpu")
    K = 5
    B = torch.from_numpy(relu_half((parts * hp.cpp, K), parts))
    halo = make_exchange(hp, mesh)(B)
    dvs, hvs = ((None, None) if binary else
                split_edge_values(hp, csr.data))
    out, ties = tref.halo_spmm_split_rows(
        hp.diag_indptr, hp.diag_indices, dvs, B, hp.halo_indptr,
        hp.halo_indices, hvs, halo, reduce, torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), torch.zeros(1, dtype=torch.int32), 1)
    g = torch.from_numpy(np.random.default_rng(parts + 9).standard_normal(
        (parts * hp.rpp, K)).astype(np.float32))
    for blk, vals, table, split, nnz in (
            ("diag", dvs, B, hp.diag_t_split, hp.diag_nnz),
            ("halo", hvs, halo.reshape(-1, K), hp.halo_t_split,
             hp.halo_nnz)):
        assert split.split.num_segments > 0
        t_indptr = getattr(hp, f"{blk}_t_indptr")
        t_rows = getattr(hp, f"{blk}_t_rows")
        tv = (None if vals is None else
              torch.gather(vals, 1, getattr(hp, f"{blk}_t_map").long()))
        grad_B, grad_vals = kmm.spmm_minmax_vjp_stacked(
            t_indptr, t_rows, tv, table, out, g, ties, split=split)
        n_t = t_indptr.shape[1] - 1
        assert grad_B.shape == table.shape
        assert (grad_vals is None) == binary
        for p in range(parts):
            k, rows = nnz[p], slice(p * hp.rpp, (p + 1) * hp.rpp)
            # The loop the sharded backward ran: row 3 a shard, unsplit.
            want_B, want_v = kmm.spmm_minmax_vjp(
                t_indptr[p], t_rows[p, :k], None if tv is None else tv[p, :k],
                table[p * n_t:(p + 1) * n_t], out[rows], g[rows], ties[rows])
            torch.testing.assert_close(grad_B[p * n_t:(p + 1) * n_t], want_B,
                                       rtol=1e-5, atol=1e-6)
            if not binary:
                torch.testing.assert_close(grad_vals[p, :k], want_v,
                                           rtol=1e-5, atol=1e-6)
                assert not grad_vals[p, k:].any()
        # A launch over the last shard alone takes its slice of the split.
        lo = parts - 1
        k = nnz[lo]
        one_B, one_v = kmm.spmm_minmax_vjp_stacked(
            t_indptr[lo:], t_rows[lo:], None if tv is None else tv[lo:],
            table[lo * n_t:], out[lo * hp.rpp:], g[lo * hp.rpp:],
            ties[lo * hp.rpp:], split=split, first=lo)
        torch.testing.assert_close(one_B, grad_B[lo * n_t:], rtol=0, atol=0)
        if not binary:
            torch.testing.assert_close(one_v[0, :k], grad_vals[lo, :k],
                                       rtol=0, atol=0)


def test_stacked_refuses_a_split_of_other_blocks():
    csr = split_boundary_graph(L, hub=40, n=120)
    hp = build_halo_partition(csr, 2, seg_len=L)
    K = 3
    B = torch.ones(2 * hp.cpp, K)
    out = ties = torch.ones(2 * hp.rpp, K)
    with pytest.raises(ValueError, match="split covers"):
        kmm.spmm_minmax_vjp_stacked(hp.diag_t_indptr, hp.diag_t_rows, None, B,
                                    out, out, ties, split=hp.halo_t_split)
    with pytest.raises(ValueError, match="split covers"):
        kmm.spmm_minmax_vjp_stacked(hp.diag_t_indptr, hp.diag_t_rows, None, B,
                                    out, out, ties, split=hp.diag_t_split,
                                    first=1)
