"""Port parity: the CSR kernel's row split, its plain walk, ``mode="fast"``
and the dense tier, against NumPy recounts, the JAX package and float64.

The split list (``sparse/partition.py::build_row_split``) is recounted in
NumPy: rows of L - 1, L and L + 1 edges, empty rows, a hub, the CSC.  The
split walk's plain version (``ops/reference.py::spmm_split_rows``, what the
CSR kernel's wrapper runs on the CPU) is held to JAX's ``spmm(method="xla")``
(rtol/atol 1e-4: f32 sums of hundreds of terms in other orders) and to
float64 within the sum bound 1e-5·(|A|·|B|) + 1e-6.  ``mode="fast"`` is held
to JAX's tiled stream with ``mode="fast"`` in interpret mode, as
``tests/test_stream.py`` runs it: equal up to f32 summation order for a
binary A (both sum the bf16-rounded rows of B; rtol 1e-6, atol
1e-6·(|A|·|B|)), and within 8e-3·(|A|·|B|) of float64 for a valued A.  The
CUDA kernels themselves are checked in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.kernels.spmm_stream import spmm_tiled as jspmm_tiled
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.ops.spmm import spmm as jspmm
from gespmm_tpu.sparse import formats as jf
from gespmm_tpu.sparse.partition import build_tiled_plan as jbuild_tiled

from gespmm_tpu_torch.kernels import spmm_csr as kspmm
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.ops.spmm import spmm as tspmm
from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse.partition import SPLIT_LEN, build_row_split
from gespmm_tpu_torch.utils.datasets import rmat_graph

L_SMALL = 8


def degree_csr(deg, n, seed=0, valued=True):
    """(port CSR, scipy matrix) whose rows have the given degrees."""
    rng = np.random.default_rng(seed)
    cols = np.concatenate([np.sort(rng.choice(n, d, replace=False))
                           for d in deg]).astype(np.int32)
    indptr = np.r_[0, np.cumsum(deg)].astype(np.int32)
    data = (rng.standard_normal(cols.shape[0]).astype(np.float32) if valued
            else None)
    mat = sp.csr_matrix((np.ones(cols.shape[0]) if data is None else data,
                         cols, indptr), shape=(len(deg), n))
    csr = tf.CSR(torch.from_numpy(indptr), torch.from_numpy(cols),
                 None if data is None else torch.from_numpy(data),
                 (len(deg), n))
    return csr, mat


# Rows at L - 1, L and L + 1, empty rows, 2L and 2L + 1, and a hub.
BOUNDARY_DEG = [0, L_SMALL - 1, L_SMALL, L_SMALL + 1, 0, 3, 2 * L_SMALL,
                2 * L_SMALL + 1, 300, 0]


def recount(indptr, L):
    """The split by a plain loop: (seg_row, seg_start, long_rows, seg_ptr)."""
    seg_row, seg_start, long_rows, seg_ptr = [], [], [], [0]
    for r in range(len(indptr) - 1):
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        if hi - lo <= L:
            continue
        long_rows.append(r)
        for s in range(lo, hi, L):
            seg_row.append(r)
            seg_start.append(s)
        seg_ptr.append(len(seg_row))
    return seg_row, seg_start, long_rows, seg_ptr


@pytest.mark.parametrize("L", [1, L_SMALL, 64, 300, 1000])
@pytest.mark.parametrize("direction", ["csr", "csc"])
def test_split_list_matches_a_numpy_recount(L, direction):
    csr, _ = degree_csr(BOUNDARY_DEG, 400)
    adj = TAdjacency.from_csr(csr)
    indptr = (adj.csr.indptr if direction == "csr" else adj.csc.indptr).numpy()
    split = build_row_split(indptr, L)
    want = recount(indptr, L)
    got = (split.seg_row, split.seg_start, split.long_rows, split.seg_ptr)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))
    assert split.seg_len == L and split.num_segments == len(want[0])
    # Every edge of a long row lies in exactly one segment of at most L.
    deg = np.diff(indptr)
    ends = np.minimum(split.seg_start.numpy() + L,
                      indptr[split.seg_row.numpy() + 1])
    assert (ends - split.seg_start.numpy()).sum() == deg[deg > L].sum()
    assert (ends - split.seg_start.numpy()).max(initial=1) <= L


def test_split_rows_at_the_boundary():
    csr, _ = degree_csr(BOUNDARY_DEG, 400)
    split = build_row_split(csr.indptr, L_SMALL)
    # L - 1 and L stay whole; L + 1 is cut into L and 1, 2L + 1 into 3.
    assert split.long_rows.tolist() == [3, 6, 7, 8]
    assert np.diff(split.seg_ptr.numpy()).tolist() == [2, 2, 3, 38]
    assert build_row_split(csr.indptr, 300).num_segments == 0
    with pytest.raises(ValueError, match="at least 1"):
        build_row_split(csr.indptr, 0)


def test_adjacency_carries_both_splits():
    csr, _ = degree_csr(BOUNDARY_DEG, 400)
    adj = TAdjacency.from_csr(csr)
    assert adj.split.seg_len == adj.split_t.seg_len == SPLIT_LEN
    assert adj.split.long_rows.tolist() == [8]  # the hub of 300
    for split, indptr in ((adj.split, adj.csr.indptr),
                          (adj.split_t, adj.csc.indptr)):
        for g, w in zip((split.seg_row, split.seg_start, split.long_rows,
                         split.seg_ptr), recount(indptr.numpy(), SPLIT_LEN)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))
    t = adj.transpose()
    assert t.split is adj.split_t and t.split_t is adj.split
    assert adj.with_data(None).split is adj.split
    # The GCN slice's shapes (rows of a few dozen edges) have no segment.
    small, _ = degree_csr([3, 0, 16, 12], 40)
    assert TAdjacency.from_csr(small).split.num_segments == 0


def hub_graph():
    """A hub-heavy generator graph: rmat scale 9, rows of up to ~150 edges,
    many empty rows; (JAX CSR, port CSR, scipy matrix)."""
    t = rmat_graph(9, edge_factor=8, seed=3)
    rng = np.random.default_rng(3)
    data = rng.standard_normal(t.nnz).astype(np.float32)
    t = tf.CSR(t.indptr, t.indices, torch.from_numpy(data), t.shape)
    j = jf.CSR(jnp.asarray(t.indptr.numpy()), jnp.asarray(t.indices.numpy()),
               jnp.asarray(data), t.shape)
    mat = sp.csr_matrix((data.astype(np.float64), t.indices.numpy(),
                         t.indptr.numpy()), shape=t.shape)
    return j, t, mat


def sum_bound(mat, B):
    return 1e-5 * (abs(mat) @ np.abs(B)) + 1e-6


@pytest.mark.parametrize("L", [4, 32, 64])
def test_split_walk_matches_jax_xla_and_float64(L):
    j, t, mat = hub_graph()
    split = build_row_split(t.indptr, L)
    assert split.num_segments > 0
    B = np.random.default_rng(L).standard_normal((t.shape[1], 17)).astype(
        np.float32)
    out = kspmm.spmm_csr(t.indptr, t.indices, t.data, torch.from_numpy(B),
                         split=split).numpy()
    ref = np.asarray(jspmm(JAdjacency.from_csr(j), jnp.asarray(B),
                           method="xla"))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    exact = mat @ B.astype(np.float64)
    assert np.all(np.abs(out - exact) <= sum_bound(mat, B))


def test_split_walk_sums_each_segment_then_the_row():
    # In float64 the split walk is the SpMM to roundoff, whatever L; a row
    # of L + 1 edges gets its two segments, and no edge is counted twice.
    csr, mat = degree_csr(BOUNDARY_DEG, 400)
    B = np.random.default_rng(4).standard_normal((400, 5))
    rows = csr.row_ids()
    for L in (1, 2, L_SMALL, 299):
        s = build_row_split(csr.indptr, L)
        out = tref.spmm_split_rows(rows, csr.indptr, csr.indices, csr.data,
                                   torch.from_numpy(B), 10, s.seg_row,
                                   s.long_rows, s.seg_ptr, L)
        np.testing.assert_allclose(out.numpy(), mat @ B, rtol=1e-12,
                                   atol=1e-12)


def test_op_and_grad_b_take_the_split_of_each_direction(monkeypatch):
    calls = []
    wrapper = kspmm.spmm_csr

    def counted(*a, **k):
        calls.append(k["split"])
        return wrapper(*a, **k)

    import gespmm_tpu_torch.ops.spmm as tops
    monkeypatch.setattr(tops, "spmm_csr", counted)
    _, t, mat = hub_graph()
    adj = TAdjacency.from_csr(t)
    assert adj.split.num_segments and adj.split_t.num_segments
    B = torch.randn(t.shape[1], 4, dtype=torch.float64, requires_grad=True)
    out = tspmm(adj, B)
    g = torch.randn_like(out)
    out.backward(g)
    assert calls == [adj.split, adj.split_t]
    np.testing.assert_allclose(B.grad.numpy(), mat.T @ g.numpy(), rtol=1e-10,
                               atol=1e-10)


def stream_graph(binary):
    """A 48x40 matrix with empty rows, for the JAX tiled stream in
    interpret mode; (JAX CSR, port CSR, scipy matrix)."""
    rng = np.random.default_rng(2)
    mat = sp.random(48, 40, density=0.15, format="lil", random_state=rng,
                    dtype=np.float64)
    mat[[0, 17], :] = 0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    mat.sort_indices()
    data = None if binary else rng.standard_normal(mat.nnz).astype(np.float32)
    mat = sp.csr_matrix((np.ones(mat.nnz) if binary else data, mat.indices,
                         mat.indptr), shape=mat.shape)
    ip, ix = mat.indptr.astype(np.int32), mat.indices.astype(np.int32)
    j = jf.CSR(jnp.asarray(ip), jnp.asarray(ix),
               None if binary else jnp.asarray(data), mat.shape)
    t = tf.CSR(torch.from_numpy(ip), torch.from_numpy(ix),
               None if binary else torch.from_numpy(data), mat.shape)
    return j, t, mat


@pytest.fixture(scope="module")
def jax_fast():
    """JAX's tiled stream with mode="fast" (interpret mode), once a case:
    {binary: (B, out)}."""
    res = {}
    for binary in (True, False):
        j, _, _ = stream_graph(binary)
        plan = jbuild_tiled(j, col_tile=16, rows_per_block=8, chunk_nnz=8,
                            part_rows=16)
        B = np.random.default_rng(5).standard_normal((40, 16)).astype(
            np.float32)
        out = jspmm_tiled(plan, j.data, jnp.asarray(B), 48, mode="fast",
                          interpret=True)
        res[binary] = (B, np.asarray(out))
    return res


@pytest.mark.parametrize("binary", [True, False])
def test_mode_fast_matches_jax_fast(jax_fast, binary):
    B, j_out = jax_fast[binary]
    _, t, mat = stream_graph(binary)
    out = tspmm(TAdjacency.from_csr(t), torch.from_numpy(B), mode="fast")
    assert out.dtype == torch.float32
    out = out.numpy()
    mag = abs(mat) @ np.abs(B)
    exact = mat @ B.astype(np.float64)
    assert np.all(np.abs(out - exact) <= 8e-3 * mag)
    if binary:  # both sum the same bf16-rounded rows of B in f32
        np.testing.assert_allclose(out, j_out, rtol=1e-6, atol=0)
        assert np.all(np.abs(out - j_out) <= 1e-6 * mag)
    else:
        assert np.all(np.abs(j_out - exact) <= 8e-3 * mag)
    # The rounding happened: the f32 route gives another answer.
    assert not np.array_equal(out, tspmm(TAdjacency.from_csr(t),
                                         torch.from_numpy(B)).numpy())


@pytest.mark.parametrize("mode", ["fast", "hilo"])
def test_mode_reaches_grad_b(mode):
    _, t, mat = stream_graph(False)
    rng = np.random.default_rng(6)
    B = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    g = rng.standard_normal((48, 8)).astype(np.float32)
    grads = {}
    for md in (mode, "trilo"):
        Bt = B.clone().requires_grad_(True)
        tspmm(TAdjacency.from_csr(t), Bt, mode=md).backward(torch.from_numpy(g))
        grads[md] = Bt.grad.numpy()
    exact = mat.T @ g.astype(np.float64)
    mag = abs(mat).T @ np.abs(g)
    if mode == "fast":  # g rounded to bf16 too
        assert np.all(np.abs(grads["fast"] - exact) <= 8e-3 * mag)
        assert not np.array_equal(grads["fast"], grads["trilo"])
    else:  # the f32 kernel
        np.testing.assert_array_equal(grads["hilo"], grads["trilo"])


def test_fast_kernel_entry_on_cpu_is_bf16_in_f32_out():
    _, t, mat = stream_graph(False)
    B = torch.randn(40, 6).to(torch.bfloat16)
    out = kspmm.spmm_csr(t.indptr, t.indices, t.data, B,
                         out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), mat @ B.double().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert kspmm.spmm_csr(t.indptr, t.indices, t.data, B).dtype == \
        torch.bfloat16


def test_dense_tier_adds_duplicate_pairs():
    # (row, col) pairs repeated: the dense A holds their sum, as scipy's
    # COO-to-dense does.
    rows = torch.tensor([0, 0, 0, 2, 2, 3], dtype=torch.int32)
    cols = torch.tensor([1, 1, 4, 0, 0, 4], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 3.0, -1.5, 0.25, 4.0])
    B = torch.from_numpy(np.random.default_rng(7).standard_normal((5, 3)))
    want = sp.coo_matrix((vals.double().numpy(), (rows.numpy(), cols.numpy())),
                         shape=(4, 5)).toarray() @ B.numpy()
    for data in (vals, None):
        got = tref.spmm_dense(rows, cols, data, B, 4)
        w = want if data is not None else sp.coo_matrix(
            (np.ones(6), (rows.numpy(), cols.numpy())),
            shape=(4, 5)).toarray() @ B.numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-12, atol=1e-12)



def count_routes(monkeypatch):
    """{wrapper name: [B widths]} of the sum kernels ``spmm`` calls."""
    import gespmm_tpu_torch.ops.spmm as tops
    calls = {"spmm_csr": [], "spmm_pallas": [], "spmm_grouped": []}
    for name in calls:
        wrapper = getattr(tops, name)

        def counted(*a, _w=wrapper, _n=name, **k):
            calls[_n].append(a[3 if _n == "spmm_csr" else 2].shape[1])
            return _w(*a, **k)

        monkeypatch.setattr(tops, name, counted)
    return calls


@pytest.mark.parametrize("plan", [False, "perrow", "grouped"])
@pytest.mark.parametrize("K,mode", [(128, "trilo"), (160, "hilo"),
                                    (32, "trilo"), (128, "fast")])
def test_auto_rule_on_a_graph_with_long_rows(monkeypatch, K, mode, plan):
    # rmat scale 9 has rows and columns longer than L = 64: "auto" takes
    # the split CSR kernel forward and for grad_B at every K and mode,
    # whatever plan the adjacency holds (the rule the card measured).
    _, t, mat = hub_graph()
    adj = TAdjacency.from_csr(t, plan=plan)
    assert adj.split.num_segments and adj.split_t.num_segments
    calls = count_routes(monkeypatch)
    B = torch.randn(t.shape[1], K, dtype=torch.float64, requires_grad=True)
    out = tspmm(adj, B, mode=mode)
    g = torch.randn_like(out)
    out.backward(g)
    assert calls == {"spmm_csr": [K, K], "spmm_pallas": [],
                     "spmm_grouped": []}
    np.testing.assert_allclose(out.detach().numpy(), mat @ B.detach().numpy(),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(B.grad.numpy(), mat.T @ g.numpy(), rtol=1e-10,
                               atol=1e-10)
