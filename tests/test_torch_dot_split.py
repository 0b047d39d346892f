"""Port parity: the split walks of the dot-attention kernels (kernel row 6),
in their plain PyTorch mirrors, against the JAX package and float64.

The CUDA kernels of ``csrc/dot_attention.cu`` walk a row (column) of more
than L edges in segments and merge the segments' partial states in a carry
pass; the forward walks each unit in batches of its walker's width with an
online softmax.  Their mirrors (``ops/reference.py::dot_split_rows``,
``dot_split_vjp_rows``, ``dot_split_vjp_cols``) compute the same partial
states and merges with torch ops.  Here they run at L = 4 on a non-square
graph whose hub rows and columns have more than 3L edges and which has empty
rows, and are held:
  * to JAX's ``dot_attention_aggregate`` (``plan=True``, Pallas in interpret
    mode, one vjp per case in a module fixture), at the fused op's
    tolerances of ``tests/test_torch_dot_attention.py`` (rtol/atol 1e-4
    forward, 3e-4 gradients);
  * in float64 to the per-edge plain versions (``dot_attention_rows``,
    ``dot_attention_vjp_rows``, ``dot_attention_vjp_cols``) at rtol 1e-10;
  * on a row of 40 edges (two batches of 32) whose logits span more than 80,
    to JAX's (out, mx, den): the online rescale meets the exp floor.
Without a card, also the multi-head walkers' head groups
(``kernels/gat_fused.py::dot_head_group``) and the G their launches pass.
The CUDA kernels themselves are checked in ``tests/test_torch_cuda.py``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.kernels.gat_fused import _dot_forward as jforward
from gespmm_tpu.kernels.gat_fused import dot_attention_aggregate as jdot
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.sparse import formats as jf

from gespmm_tpu_torch.kernels import gat_fused as kgat
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse.partition import build_row_split

FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=3e-4, atol=3e-4)
F64 = dict(rtol=1e-10, atol=1e-12)
M, N, K = 40, 36, 8
L = 4
EMPTY_ROWS = (0, 17, 39)
HUB_ROWS = {5: 20, 11: 30}
HUB_COLS = {3: 20, 30: 28}
PLAN = dict(col_tile=1 << 20, rows_per_block=16, chunk_nnz=64)
# (Ka, negative_slope): an act-free and a leaky case, and Ka = 1.
CASES = [(6, None), (6, 0.2), (1, None)]


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


def inputs(Ka, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((M, Ka), (N, Ka), (N, K), (M, K))]


@pytest.fixture(scope="module")
def jax_runs(graph):
    """{(Ka, slope): (out, grads)} of JAX's fused op in interpret mode."""
    jadj = graph[0]
    runs = {}
    for Ka, slope in CASES:
        D1, D2, B, g = inputs(Ka)
        out, vjp = jax.vjp(lambda a, b, c, s=slope: jdot(
            jadj, a, b, c, negative_slope=s), *map(jnp.asarray, (D1, D2, B)))
        runs[(Ka, slope)] = (np.asarray(out),
                             [np.asarray(x) for x in vjp(jnp.asarray(g))])
    return runs


def mirrors(adj, split, split_t, D1, D2, B, g, slope, batch=32):
    """(out, mx, den, grad_D1, grad_D2, grad_B) of the split mirrors, the
    backward's s = <g, out> from the mirror's out."""
    m, _ = adj.shape
    out, mx, den = tref.dot_split_rows(
        adj.rows, adj.csr.indptr, adj.csr.indices, D1, D2, B, m,
        split.seg_row, split.long_rows, split.seg_ptr, split.seg_len, slope,
        batch)
    tables = (D1, D2, B, g, mx, den, tref.dot_row_dot(g, out))
    grad_D1 = tref.dot_split_vjp_rows(
        adj.rows, adj.csr.indptr, adj.csr.indices, *tables, m, split.seg_row,
        split.long_rows, split.seg_ptr, split.seg_len, slope)
    grad_D2, grad_B = tref.dot_split_vjp_cols(
        adj.csc.indices, adj.csc.indptr, adj.rows_t, *tables,
        split_t.seg_row, split_t.long_rows, split_t.seg_ptr, split_t.seg_len,
        slope)
    return out, mx, den, grad_D1, grad_D2, grad_B


@pytest.mark.parametrize("Ka,slope", CASES)
def test_split_mirrors_match_jax(graph, jax_runs, Ka, slope):
    _, adj, split, split_t = graph
    assert split.num_segments and split_t.num_segments
    want, want_grads = jax_runs[(Ka, slope)]
    out, _, _, *grads = mirrors(adj, split, split_t,
                                *map(torch.from_numpy, inputs(Ka)), slope)
    np.testing.assert_allclose(out.numpy(), want, **FWD)
    for got, ref, name in zip(grads, want_grads, ("D1", "D2", "B")):
        np.testing.assert_allclose(got.numpy(), ref, err_msg=f"grad_{name}",
                                   **GRAD)


@pytest.mark.parametrize("L_walk,batch", [(L, 32), (64, 4), (L, 2)])
@pytest.mark.parametrize("Ka,slope", CASES)
def test_split_mirrors_match_float64(graph, Ka, slope, L_walk, batch):
    # (L, 32): every hub cut into segments of 4, one batch each; (64, 4): no
    # segment, rows of more than 4 edges walked in several batches (the
    # online rescale of a 4-lane walker); (L, 2): both.
    _, adj, _, _ = graph
    split = build_row_split(adj.csr.indptr, L_walk)
    split_t = build_row_split(adj.csc.indptr, L_walk)
    m, _ = adj.shape
    D1, D2, B, g = (torch.from_numpy(x).double() for x in inputs(Ka, seed=5))
    got = mirrors(adj, split, split_t, D1, D2, B, g, slope, batch)
    edges = (adj.rows, adj.csr.indices)
    out, mx, den = tref.dot_attention_rows(*edges, D1, D2, B, m, slope)
    tables = (D1, D2, B, g, mx, den, tref.dot_row_dot(g, out))
    want = (out, mx, den, tref.dot_attention_vjp_rows(*edges, *tables, m,
                                                      slope),
            *tref.dot_attention_vjp_cols(*edges, *tables, slope))
    for name, a, b in zip(("out", "mx", "den", "grad_D1", "grad_D2",
                           "grad_B"), got, want):
        assert a.dtype == torch.float64, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **F64)


def test_online_rescale_meets_the_exp_floor():
    # Row 0: 40 edges, two batches of 32 when walked whole (L = 64).  With
    # D1[0] = 1 (Ka = 1) the logits are D2: the first batch's lie in [0, 5],
    # the second holds the row maximum 100, so the first batch's z are taken
    # against a running maximum of at most 5 and rescaled, where JAX floors
    # l - 100 < -80 at -80.  Row 1 is short, row 2 empty.
    n = 40
    indptr = np.array([0, 40, 43, 43])
    indices = np.r_[np.arange(40), [3, 17, 38]]
    mat = sp.csr_matrix((np.ones(43), indices, indptr), shape=(3, n))
    jadj, adj = pair(mat)
    rng = np.random.default_rng(11)
    D2 = np.r_[rng.uniform(0, 5, 32), [100.0, 60.0], rng.uniform(0, 5, 6)]
    D2 = D2.astype(np.float32)[:, None]
    D1 = np.ones((3, 1), np.float32)
    B = rng.standard_normal((n, 8)).astype(np.float32)
    want = jforward(jadj.plan, *map(jnp.asarray, (D1, D2, B)), None, True)
    split = build_row_split(adj.csr.indptr)
    assert split.num_segments == 0
    got = tref.dot_split_rows(adj.rows, adj.csr.indptr, adj.csr.indices,
                              *map(torch.from_numpy, (D1, D2, B)), 3,
                              split.seg_row, split.long_rows, split.seg_ptr,
                              split.seg_len)
    for name, a, b in zip(("out", "mx", "den"), got, want):
        np.testing.assert_allclose(a.numpy().reshape(np.shape(b)),
                                   np.asarray(b), err_msg=name, **FWD)
    assert float(got[1][0]) == 100.0


def test_an_empty_row_gives_zero_out_and_mx_and_the_denominator_floor(graph):
    _, adj, split, _ = graph
    m, _ = adj.shape
    D1, D2, B, _ = (torch.from_numpy(x) for x in inputs(6, seed=1))
    runs = [tref.dot_split_rows(adj.rows, adj.csr.indptr, adj.csr.indices,
                                D1, D2, B, m, split.seg_row, split.long_rows,
                                split.seg_ptr, L, 0.2),
            kgat.dot_forward(adj.csr.indptr, adj.csr.indices, D1, D2, B,
                             slope=0.2, split=split)]
    rows = list(EMPTY_ROWS)
    for out, mx, den in runs:
        assert not out[rows].any() and not mx[rows].any()
        assert torch.all(den[rows] == torch.tensor(tref.DENOM_EPS,
                                                   dtype=den.dtype))


def test_op_hands_each_kernel_the_split_of_its_direction(graph, monkeypatch):
    _, adj, _, _ = graph
    calls = []

    def counted(name, fn):
        def run(*a, **k):
            calls.append((name, k["split"]))
            return fn(*a, **k)
        return run

    for name in ("dot_forward", "dot_backward_rows", "dot_backward_cols"):
        monkeypatch.setattr(tgraph, name,
                            counted(name, getattr(tgraph, name)))
    m, n = adj.shape
    xs = [torch.randn(s, dtype=torch.float64, requires_grad=True)
          for s in ((m, 6), (n, 6), (n, K))]
    out = tgraph.dot_attention_aggregate(adj, *xs)
    out.backward(torch.randn_like(out))
    assert [name for name, _ in calls] == ["dot_forward", "dot_backward_rows",
                                           "dot_backward_cols"]
    assert calls[0][1] is adj.split and calls[1][1] is adj.split
    assert calls[2][1] is adj.split_t


@pytest.mark.parametrize("Ka,K_,vec,lanes", [
    (3, 1, 1, 4), (5, 8, 1, 8), (16, 3, 1, 16), (65, 130, 1, 32),
    (2, 4, 2, 4), (10, 6, 2, 8), (30, 2, 2, 16), (64, 130, 2, 32),
    (4, 4, 4, 4), (32, 8, 4, 8), (64, 64, 4, 16), (128, 256, 4, 32)])
def test_dot_walk_shape_reaches_every_instantiation(Ka, K_, vec, lanes):
    # VEC the widest of 4, 2, 1 dividing K and Ka, SW the power of two from
    # 4 to 32 whose SW·VEC columns cover the wider; a misaligned table
    # narrows VEC.
    assert kgat.dot_walk_shape(K_, Ka, torch.empty(8, Ka)) == (vec, lanes)
    skewed = torch.empty(8 * Ka + 1)[1:].view(8, Ka)  # 4 bytes off
    wide = max(K_, Ka)
    assert kgat.dot_walk_shape(K_, Ka, skewed) == \
        (1, min(32, max(4, 1 << (wide - 1).bit_length())))


# (K, Ka, H, VEC, SW, NS, G): the UniMP cell's output layer (heads of 47,
# head-major over three slabs), its hidden layers and a narrow-head case as
# today's rule has them, two heads of 15 (a head narrower than its group's
# slabs), one head of several slabs (the walker-wide group), groups that
# would not fit and K != Ka (head by head).
HEAD_GROUPS = [(94, 94, 2, 1, 32, 3, 16), (64, 64, 2, 2, 32, 1, 16),
               (12, 12, 3, 2, 32, 1, 2), (30, 30, 2, 1, 32, 3, 8),
               (94, 94, 1, 1, 32, 3, 32), (90, 90, 3, 1, 32, 3, 0),
               (18, 12, 3, 1, 32, 1, 0)]


@pytest.mark.parametrize("K_,Ka,H,vec,sw,ns,G", HEAD_GROUPS)
def test_dot_head_group_at_each_width(K_, Ka, H, vec, sw, ns, G):
    assert kgat.dot_head_group(K_, Ka, H, vec, sw, ns) == G
    if G and H * G <= sw:
        # Head-major: head h's G lanes hold columns h*dk + (s*G + l%G)*VEC
        # of slab s, and every column of K is held once.
        dk = Ka // H
        held = [h * dk + (s * G + l % G) * vec + t
                for l in range(sw) for s in range(ns) for t in range(vec)
                for h in [l // G]
                if h < H and (s * G + l % G) * vec < dk]
        assert sorted(held) == list(range(K_))


@pytest.mark.parametrize("K_,H,G", [(94, 2, 16), (64, 2, 16), (90, 3, 0)])
def test_dot_head_launches_pass_their_group(K_, H, G, monkeypatch):
    # Each multi-head launch hands its entry point the G of dot_head_group
    # after (vec, sw, ns), and counts its walk in dot_grouped_walks where
    # G > 0.  The entry points and the card are stood in for.
    calls = []

    def entry(kind, dtype):
        def fn(*args):
            calls.append((kind, args[4:8]))
            return 0
        return fn, None

    monkeypatch.setattr(kgat, "_dot_heads_entry", entry)
    monkeypatch.setattr(kgat, "check_operands", lambda *a: None)
    monkeypatch.setattr(kgat, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    csr = tf.CSR(torch.tensor([0, 2, 3], dtype=torch.int32),
                 torch.tensor([0, 1, 1], dtype=torch.int32), None, (2, 2))
    adj = TAdjacency.from_csr(csr)
    D1, D2, B, g = (torch.randn(2, K_) for _ in range(4))
    mx = den = s = torch.ones(2, H)
    kw = dict(heads=H, scale=0.5)
    kgat.reset_launches()
    kgat.dot_forward_cuda(adj.csr.indptr, adj.csr.indices, D1, D2, B, None,
                          adj.split, **kw)
    tabs = (D1, D2, B, g, mx, den, s, None)
    kgat.dot_backward_rows_cuda(adj.csr.indptr, adj.csr.indices, *tabs,
                                adj.split, **kw)
    kgat.dot_backward_cols_cuda(adj.csc.indptr, adj.csc.indices, *tabs,
                                adj.split_t, **kw)
    shape = kgat.dot_heads_shape(K_, K_, H, D1)
    assert calls == [(kind, (*shape, G))
                     for kind in ("fwd", "bwd_rows", "bwd_cols")]
    assert G == kgat.dot_head_group(K_, K_, H, *shape)
    assert (kgat.dot_edge_walks, kgat.dot_grouped_walks) == (3, 3 if G else 0)
