"""Port parity: the split walks of the fused GAT kernels (kernel row 5), in
their plain PyTorch mirrors, against the JAX package and float64.

The CUDA kernels of ``csrc/gat_fused.cu`` walk a row (column) of more than L
edges in segments and merge the segments' partial states in a carry pass;
the forward walks each unit in batches with an online softmax, and the
backward kernels take the linear form of grad_src and grad_dst.  Their
mirrors (``ops/reference.py::gat_split_rows``, ``gat_split_vjp_rows``,
``gat_split_vjp_cols``) compute the same partial states and merges with
torch ops.  Here they run at L = 4 on a graph whose hub rows and columns have
more than 3L edges and which has empty rows, and are held:
  * to JAX's ``gat_attention_aggregate`` (``plan=True``, Pallas in interpret
    mode, one vjp per case in a module fixture), at the fused op's
    tolerances of ``tests/test_torch_attention.py`` (rtol/atol 1e-4
    forward, 2e-4 gradients);
  * in float64 to the per-edge plain versions (``gat_fused_rows``,
    ``gat_fused_vjp_rows``, ``gat_fused_vjp_cols``) at rtol 1e-10;
  * on a row of 40 edges (two batches of 32) whose logits span more than 80,
    to JAX's (out, mx, den): the online rescale meets the exp floor.
The CUDA kernels themselves are checked in ``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.kernels.gat_fused import _forward as jforward
from gespmm_tpu.kernels.gat_fused import gat_attention_aggregate as jgat
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.sparse import formats as jf

from gespmm_tpu_torch.kernels import gat_fused as kgat
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse.partition import build_row_split

FUSED_FWD = dict(rtol=1e-4, atol=1e-4)
FUSED_GRAD = dict(rtol=2e-4, atol=2e-4)
F64 = dict(rtol=1e-10, atol=1e-12)
M, N = 40, 36
L = 4
EMPTY_ROWS = (0, 17, 39)
HUB_ROWS = {5: 20, 11: 30}
HUB_COLS = {3: 20, 30: 28}
PLAN = dict(col_tile=1 << 20, rows_per_block=16, chunk_nnz=64)
SLOPE = 0.2
CASES = [(1, 8), (3, 4), (2, 65)]


def pair(mat):
    """(JAX Adjacency with plans, port Adjacency) of a scipy CSR."""
    m, n = mat.shape
    indptr = mat.indptr.astype(np.int32)
    indices = mat.indices.astype(np.int32)
    data = mat.data.astype(np.float32)
    j = jf.CSR(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(data),
               (m, n))
    t = tf.CSR(torch.from_numpy(indptr), torch.from_numpy(indices),
               torch.from_numpy(data), (m, n))
    return JAdjacency.from_csr(j, plan=True, **PLAN), TAdjacency.from_csr(t)


@pytest.fixture(scope="module")
def graph():
    """An M x N pattern with hub rows and columns above 3L edges and empty
    rows: (JAX adjacency, port adjacency, row split, column split at L)."""
    rng = np.random.default_rng(0)
    mat = sp.random(M, N, density=0.1, format="lil", random_state=rng,
                    dtype=np.float64)
    for r, d in HUB_ROWS.items():
        mat[r, rng.choice(N, d, replace=False)] = 1.0
    for c, d in HUB_COLS.items():
        mat[rng.choice(M, d, replace=False), c] = 1.0
    for r in EMPTY_ROWS:
        mat[r, :] = 0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    mat.sort_indices()
    jadj, tadj = pair(mat)
    split = build_row_split(tadj.csr.indptr, L)
    split_t = build_row_split(tadj.csc.indptr, L)
    deg, deg_t = np.diff(mat.indptr), np.diff(mat.tocsc().indptr)
    assert deg.max() > 3 * L and deg_t.max() > 3 * L
    assert all(deg[r] == 0 for r in EMPTY_ROWS)
    return jadj, tadj, split, split_t


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs(graph):
    """{(H, dh, max_mode): (inputs, out, grads)} of JAX's fused op."""
    jadj = graph[0]
    rng = np.random.default_rng(3)
    runs = {}
    for H, dh in CASES:
        for max_mode in ("exact", "bound"):
            src, dst = rand(rng, M, H), rand(rng, N, H)
            B, w = rand(rng, N, H * dh), rand(rng, M, H * dh)

            def f(s, d, b, H=H, max_mode=max_mode):
                return jgat(jadj, s, d, b, negative_slope=SLOPE, heads=H,
                            max_mode=max_mode)

            out, vjp = jax.vjp(f, *map(jnp.asarray, (src, dst, B)))
            grads = [np.asarray(x) for x in vjp(jnp.asarray(w))]
            runs[(H, dh, max_mode)] = ((src, dst, B, w), np.asarray(out),
                                       grads)
    return runs


def mirrors(adj, split, split_t, src, dst, B, w, H, max_mode, batch=32):
    """(out, mx, den, grad_src, grad_dst, grad_B) of the split mirrors, the
    backward's s = <g, out> from the mirror's out."""
    m, n = adj.shape
    out, mx, den = tref.gat_split_rows(
        adj.rows, adj.csr.indptr, adj.csr.indices, src, dst, B, m,
        split.seg_row, split.long_rows, split.seg_ptr, split.seg_len, SLOPE,
        max_mode, H, batch)
    s_row = tref.gat_row_dot(w, out, H)
    tables = (src, dst, B, w, mx, den, s_row)
    grad_src = tref.gat_split_vjp_rows(
        adj.rows, adj.csr.indptr, adj.csr.indices, *tables, m, split.seg_row,
        split.long_rows, split.seg_ptr, split.seg_len, SLOPE, H)
    grad_dst, grad_B = tref.gat_split_vjp_cols(
        adj.csc.indices, adj.csc.indptr, adj.rows_t, *tables,
        split_t.seg_row, split_t.long_rows, split_t.seg_ptr, split_t.seg_len,
        SLOPE, H)
    return out, mx, den, grad_src, grad_dst, grad_B


@pytest.mark.parametrize("max_mode", ["exact", "bound"])
@pytest.mark.parametrize("H,dh", CASES)
def test_split_mirrors_match_jax(graph, jax_runs, H, dh, max_mode):
    _, adj, split, split_t = graph
    assert split.num_segments and split_t.num_segments
    (src, dst, B, w), want, want_grads = jax_runs[(H, dh, max_mode)]
    out, _, _, *grads = mirrors(adj, split, split_t,
                                *map(torch.from_numpy, (src, dst, B, w)), H,
                                max_mode)
    np.testing.assert_allclose(out.numpy(), want, **FUSED_FWD)
    for got, ref, name in zip(grads, want_grads, ("src", "dst", "B")):
        np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref,
                                   err_msg=f"grad_{name}", **FUSED_GRAD)


@pytest.mark.parametrize("L_walk,batch", [(L, 32), (64, 4)])
@pytest.mark.parametrize("max_mode", ["exact", "bound"])
@pytest.mark.parametrize("H,dh", CASES)
def test_split_mirrors_match_float64(graph, H, dh, max_mode, L_walk, batch):
    # (L, 32): every hub cut into segments of 4, one batch each; (64, 4):
    # no segment, rows of more than 4 edges walked in several batches
    # (the online rescale of a sub-warp walker).
    _, adj, _, _ = graph
    split = build_row_split(adj.csr.indptr, L_walk)
    split_t = build_row_split(adj.csc.indptr, L_walk)
    m, n = adj.shape
    rng = np.random.default_rng(H * dh)
    src, dst, B, w = (torch.from_numpy(rand(rng, *s)).double() for s in
                      ((m, H), (n, H), (n, H * dh), (m, H * dh)))
    got = mirrors(adj, split, split_t, src, dst, B, w, H, max_mode, batch)
    edges = (adj.rows, adj.csr.indices)
    out, mx, den = tref.gat_fused_rows(*edges, src, dst, B, m, SLOPE,
                                       max_mode, H)
    vjp = (*edges, src, dst, B, w, mx, den, tref.gat_row_dot(w, out, H))
    want = (out, mx, den, tref.gat_fused_vjp_rows(*vjp, m, SLOPE, H),
            *tref.gat_fused_vjp_cols(*vjp, SLOPE, H))
    for name, a, b in zip(("out", "mx", "den", "grad_src", "grad_dst",
                           "grad_B"), got, want):
        assert a.dtype == torch.float64, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **F64)


@pytest.mark.parametrize("H,dh", [(1, 8), (2, 65)])
def test_linear_backward_equals_the_per_edge_form_in_float64(graph, H, dh):
    # The kernels' linear form, unsplit (L beyond every degree), against
    # the per-edge dpre sums of the plain versions, in float64.
    _, adj, _, _ = graph
    m, n = adj.shape
    rng = np.random.default_rng(7)
    src, dst, B, g = (torch.from_numpy(rand(rng, *s)).double() for s in
                      ((m, H), (n, H), (n, H * dh), (m, H * dh)))
    edges = (adj.rows, adj.csr.indices)
    out, mx, den = tref.gat_fused_rows(*edges, src, dst, B, m, SLOPE,
                                       "exact", H)
    s_row = tref.gat_row_dot(g, out, H)
    tables = (src, dst, B, g, mx, den, s_row)
    none = torch.zeros(0, dtype=torch.int32)
    zero_ptr = torch.zeros(1, dtype=torch.int32)
    lin_src = tref.gat_split_vjp_rows(adj.rows, adj.csr.indptr,
                                      adj.csr.indices, *tables, m, none, none,
                                      zero_ptr, 10**6, SLOPE, H)
    lin_dst, lin_B = tref.gat_split_vjp_cols(adj.csc.indices, adj.csc.indptr,
                                             adj.rows_t, *tables, none, none,
                                             zero_ptr, 10**6, SLOPE, H)
    np.testing.assert_allclose(
        lin_src.numpy(),
        tref.gat_fused_vjp_rows(*edges, *tables, m, SLOPE, H).numpy(), **F64)
    want_dst, want_B = tref.gat_fused_vjp_cols(*edges, *tables, SLOPE, H)
    np.testing.assert_allclose(lin_dst.numpy(), want_dst.numpy(), **F64)
    np.testing.assert_allclose(lin_B.numpy(), want_B.numpy(), **F64)


def test_online_rescale_meets_the_exp_floor():
    # Row 0: 40 edges, two batches of 32 when walked whole (L = 64).  The
    # first batch's logits lie in [0, 5], the second holds the row maximum
    # 100: the first batch's z are taken against a running maximum of at
    # most 5 and rescaled, where JAX floors l - 100 < -80 at -80.  Row 1
    # is short, row 2 empty.
    n = 40
    indptr = np.array([0, 40, 43, 43])
    indices = np.r_[np.arange(40), [3, 17, 38]]
    mat = sp.csr_matrix((np.ones(43), indices, indptr), shape=(3, n))
    jadj, adj = pair(mat)
    rng = np.random.default_rng(11)
    dst = np.r_[rng.uniform(0, 5, 32), [100.0, 60.0], rng.uniform(0, 5, 6)]
    dst = dst.astype(np.float32)[:, None]
    src = np.zeros((3, 1), np.float32)
    B = rand(rng, n, 8)
    want = jforward(jadj.plan, *map(jnp.asarray, (src, dst, B)), SLOPE, True)
    split = build_row_split(adj.csr.indptr)
    assert split.num_segments == 0
    got = tref.gat_split_rows(adj.rows, adj.csr.indptr, adj.csr.indices,
                              *map(torch.from_numpy, (src, dst, B)), 3,
                              split.seg_row, split.long_rows, split.seg_ptr,
                              split.seg_len, SLOPE, "exact", 1)
    for name, a, b in zip(("out", "mx", "den"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **FUSED_FWD)
    assert float(got[1][0, 0]) == 100.0


@pytest.mark.parametrize("max_mode", ["exact", "bound"])
def test_an_empty_row_gives_zero_out_and_mx_and_the_denominator_floor(
        graph, max_mode):
    _, adj, split, _ = graph
    m, n = adj.shape
    rng = np.random.default_rng(1)
    src, dst, B = (torch.from_numpy(rand(rng, *s)) for s in
                   ((m, 2), (n, 2), (n, 6)))
    runs = [tref.gat_split_rows(adj.rows, adj.csr.indptr, adj.csr.indices,
                                src, dst, B, m, split.seg_row,
                                split.long_rows, split.seg_ptr, L, SLOPE,
                                max_mode, 2),
            kgat.gat_forward(adj.csr.indptr, adj.csr.indices, src, dst, B,
                             slope=SLOPE, heads=2, max_mode=max_mode,
                             split=split)]
    rows = list(EMPTY_ROWS)
    for out, mx, den in runs:
        assert not out[rows].any()
        assert torch.all(den[rows] == torch.tensor(tref.DENOM_EPS,
                                                   dtype=den.dtype))
        if max_mode == "exact":
            assert not mx[rows].any()


def test_op_hands_each_kernel_the_split_of_its_direction(graph, monkeypatch):
    _, adj, _, _ = graph
    calls = []

    def counted(name, fn):
        def run(*a, **k):
            calls.append((name, k["split"]))
            return fn(*a, **k)
        return run

    for name in ("gat_forward", "gat_backward_rows", "gat_backward_cols"):
        monkeypatch.setattr(tgraph, name,
                            counted(name, getattr(tgraph, name)))
    m, n = adj.shape
    src = torch.randn(m, 2, dtype=torch.float64, requires_grad=True)
    dst = torch.randn(n, 2, dtype=torch.float64, requires_grad=True)
    B = torch.randn(n, 6, dtype=torch.float64, requires_grad=True)
    out = tgraph.gat_attention_aggregate(adj, src, dst, B, heads=2)
    out.backward(torch.randn_like(out))
    assert [name for name, _ in calls] == ["gat_forward", "gat_backward_rows",
                                           "gat_backward_cols"]
    assert calls[0][1] is adj.split and calls[1][1] is adj.split
    assert calls[2][1] is adj.split_t


@pytest.mark.parametrize("H,dh,vec,lanes", [
    (1, 3, 1, 4), (1, 5, 1, 8), (3, 3, 1, 16), (2, 65, 1, 32),
    (1, 2, 2, 4), (1, 10, 2, 8), (3, 6, 2, 16), (2, 130, 2, 32),
    (1, 4, 4, 4), (3, 8, 4, 8), (1, 64, 4, 16), (2, 132, 4, 32)])
def test_walk_shape_reaches_every_instantiation(H, dh, vec, lanes):
    # (H, dh) alone picks each of the kernels' twelve (VEC, SW) pairs: VEC
    # the widest of 4, 2, 1 dividing dh, SW the power of two from 4 to 32
    # covering K / VEC.  A table misaligned for VEC narrows it.
    K = H * dh
    assert kgat.walk_shape(K, H, torch.empty(8, K)) == (vec, lanes)
    skewed = torch.empty(8 * K + 1)[1:].view(8, K)  # 4 bytes off
    assert kgat.walk_shape(K, H, torch.empty(8, K), skewed) == \
        (1, min(32, max(4, 1 << (K - 1).bit_length())))


@pytest.mark.parametrize("H,dh,tables,shape", [
    # The products GAT's hidden layers: K = 512 on 4-column lanes, all four
    # slabs of 128 columns at once, in every kernel.
    (4, 128, 1, (4, 32, 4)), (4, 128, 3, (4, 32, 4)),
    # Its output layer: K = 188 on 1-column lanes, all six slabs of 32 (the
    # heads straddle slabs), in every kernel.
    (4, 47, 1, (1, 32, 6)), (4, 47, 3, (1, 32, 6)),
    # Eight slabs of 128 and twelve of 32: two groups of 4 and of 6.
    (8, 128, 3, (4, 32, 4)), (8, 47, 3, (1, 32, 6)),
    # K within one slab: one walk, NS = 1.
    (1, 64, 3, (4, 16, 1)), (8, 3, 1, (1, 32, 1)),
    # Five slabs of 1-column lanes, two of 4-column lanes: NS does not
    # divide them, so a walk a slab.
    (2, 65, 3, (1, 32, 1)), (32, 8, 1, (4, 32, 1)),
    # 2-column lanes hold one slab a walk.
    (4, 46, 1, (2, 32, 1)),
    # 16 heads of 32: the forward's one table holds all four slabs' heads
    # in 17 KiB a block; the CSC backward's three (50 KiB) would overflow
    # SLAB_TABLE_BYTES, so it walks the slabs in groups of one.
    (16, 32, 1, (4, 32, 4)), (16, 32, 3, (4, 32, 1)),
    # 128 heads of 4: a group of four slabs would hold more heads than lanes.
    (128, 4, 1, (4, 32, 1))])
def test_launch_shape_holds_every_slab_it_can(H, dh, tables, shape):
    # NS, the K slabs a walker holds at once (csrc/gat_fused.cu), on top of
    # walk_shape's (VEC, SW): WALK_SLABS' value at VEC on a whole warp where
    # it divides the slabs, its groups touch at most SW heads and their
    # tables fit SLAB_TABLE_BYTES a block.
    K = H * dh
    vec, sw, ns = kgat.launch_shape(K, H, tables, torch.empty(8, K))
    assert (vec, sw, ns) == shape
    assert (vec, sw) == kgat.walk_shape(K, H, torch.empty(8, K))
    slabs = -(-K // (sw * vec))
    assert slabs % ns == 0 and ns in (1, kgat.WALK_SLABS.get(vec))
    assert kgat.heads_per_slab(K, dh, ns * sw * vec) <= sw


def test_walk_slabs_are_the_instantiated_walkers():
    # launch_shape may pick only the NS that csrc/gat_fused.cu's dispatch_walk
    # instantiates (else the launch returns cudaErrorInvalidValue): its
    # (VEC, NS) cases on whole warps are WALK_SLABS, and NS = 1 everywhere.
    src = (Path(kgat.__file__).parent.parent / "csrc" / "gat_fused.cu"
           ).read_text()
    body = src[src.index("cudaError_t dispatch_walk("):]
    body = body[:body.index("\n}\n")]
    cases = re.findall(r"if constexpr \(SW == 32 && VEC == (\d+)\)\s*"
                       r"if \(ns == (\d+)\) return fn\(V, W, gespmm::Int<"
                       r"(\d+)>\(\)\);", body)
    assert {int(v): int(n) for v, n, _ in cases} == kgat.WALK_SLABS
    assert all(n == i for _, n, i in cases)
    assert "if (ns == 1) return fn(V, W, gespmm::Int<1>());" in body
    assert body.count("return fn(") == len(cases) + 1
