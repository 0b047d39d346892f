"""Port parity: the split walk of the edge segment reduce (kernel row 4), in
its plain PyTorch mirror, against the JAX package and float64.

The CUDA kernel of ``csrc/edge_reduce.cu`` walks a row of more than L edges
in segments and a carry pass adds the segments' sums in segment order (or
takes the maximum of their maxima).  Its mirror
(``ops/reference.py::edge_segment_split``) computes the same per-segment
partials and merges with torch ops.  Here it runs at L = 4 on a graph whose
hub rows have more than 3L edges and which has empty rows, over the CSR and
over the CSC (the backward of ``additive_attention_logits``), and is held:
  * to JAX's ``edge_segment_reduce`` (``spmm_stream.py:816``, through its
    plan, Pallas in interpret mode) at rtol/atol 1e-5 for the sum (f32 sums
    in another order) and exactly for the max;
  * in float64 to the unsplit plain version (``edge_segment_rows``) at rtol
    1e-12, and bit for bit for the max.
The CUDA kernel itself is checked in ``tests/test_torch_cuda.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.kernels.spmm_stream import edge_segment_reduce as jsegment
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.sparse import formats as jf

from gespmm_tpu_torch.kernels import edge_reduce as kedge
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse.partition import build_row_split

SUM = dict(rtol=1e-5, atol=1e-5)
M, N = 40, 36
L = 4
EMPTY_ROWS = (0, 17, 39)
HUB_ROWS = {5: 20, 11: 30}
HUB_COLS = {3: 20, 30: 28}
PLAN = dict(col_tile=1 << 20, rows_per_block=16, chunk_nnz=64)


def csr_pair(indptr, indices, shape):
    """(JAX Adjacency with its plan, port Adjacency) of a CSR pattern."""
    indptr, indices = indptr.astype(np.int32), indices.astype(np.int32)
    data = np.ones(indices.shape[0], np.float32)
    j = jf.CSR(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(data),
               shape)
    t = tf.CSR(torch.from_numpy(indptr), torch.from_numpy(indices),
               torch.from_numpy(data), shape)
    return JAdjacency.from_csr(j, plan=True, **PLAN), TAdjacency.from_csr(t)


@pytest.fixture(scope="module")
def graphs():
    """{"csr": ..., "csc": ...}: (JAX adjacency of that edge order, port
    adjacency, its split at L) for a pattern with hub rows and columns above
    3L edges and empty rows; the CSC's is the transpose's CSR."""
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
    out = {}
    for name, a in (("csr", mat), ("csc", mat.T.tocsr())):
        a.sort_indices()
        jadj, tadj = csr_pair(a.indptr, a.indices, a.shape)
        split = build_row_split(tadj.csr.indptr, L)
        assert split.num_segments and np.diff(a.indptr).max() > 3 * L
        out[name] = (jadj, tadj, split)
    return out


def mirror(tadj, split, vals, op):
    return tref.edge_segment_split(tadj.rows, tadj.csr.indptr, vals,
                                   tadj.shape[0], op, split.seg_row,
                                   split.long_rows, split.seg_ptr,
                                   split.seg_len)


@pytest.mark.parametrize("direction", ["csr", "csc"])
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_split_mirror_matches_jax(graphs, op, K, direction):
    jadj, tadj, split = graphs[direction]
    vals = np.random.default_rng(K).standard_normal(
        (tadj.nnz, K)).astype(np.float32)
    want = np.asarray(jsegment(jadj.plan, jnp.asarray(vals), op))
    got = mirror(tadj, split, torch.from_numpy(vals), op).numpy()
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **SUM)
    if direction == "csr":
        assert not got[list(EMPTY_ROWS)].any()


@pytest.mark.parametrize("L_walk", [1, L, 7])
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_split_mirror_matches_float64(graphs, op, K, L_walk):
    # Segments of 1, 4 and 7 edges: rows cut at, off and on the boundary.
    _, tadj, _ = graphs["csr"]
    split = build_row_split(tadj.csr.indptr, L_walk)
    vals = torch.from_numpy(np.random.default_rng(K + 10).standard_normal(
        (tadj.nnz, K)))
    got = mirror(tadj, split, vals, op)
    want = tref.edge_segment_rows(tadj.rows, vals, tadj.shape[0], op)
    assert got.dtype == torch.float64
    if op == "max":
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_max_of_a_row_of_negative_infinities_is_zero(graphs):
    # A long row whose every value is -inf: each segment's max and the
    # carry's are -inf, written as 0, as the unsplit walk writes it.
    _, tadj, split = graphs["csr"]
    vals = torch.randn(tadj.nnz, 2)
    hub = next(iter(HUB_ROWS))
    lo, hi = int(tadj.csr.indptr[hub]), int(tadj.csr.indptr[hub + 1])
    vals[lo:hi] = float("-inf")
    got = mirror(tadj, split, vals, "max")
    assert not got[hub].any()
    assert torch.equal(got, tref.edge_segment_rows(tadj.rows, vals,
                                                   tadj.shape[0], "max"))


def test_the_op_hands_each_segment_reduce_the_split_of_its_order(
        graphs, monkeypatch):
    # edge_softmax (forward max and sum, backward sum) and the backward of
    # additive_attention_logits (a sum over the CSR and one over the CSC).
    from gespmm_tpu_torch.ops import graph as tgraph
    _, adj, _ = graphs["csr"]
    seen = []

    def spy(indptr, vals, op="sum", rows=None, split=None):
        seen.append((op, split))
        return kedge.edge_segment_reduce(indptr, vals, op, rows=rows,
                                         split=split)

    monkeypatch.setattr(tgraph, "edge_segment_reduce", spy)
    src = torch.randn(adj.shape[0], requires_grad=True)
    dst = torch.randn(adj.shape[1], requires_grad=True)
    logits = tgraph.additive_attention_logits(adj, src, dst)
    tgraph.edge_softmax(adj, logits).sum().backward()
    assert [op for op, _ in seen] == ["max", "sum", "sum", "sum", "sum"]
    assert all(s is adj.split for _, s in seen[:4]) and seen[4][1] is adj.split_t


def test_walk_width_covers_half_the_mean_degree():
    assert kedge.walk_width(102_707, 19_719, 1) == 4  # sbm-pubmed with loops
    assert kedge.walk_width(102_707, 19_719, 8) == 8  # two column chunks
    assert kedge.walk_width(467_442, 32_768, 1) == 8  # rmat15
    assert kedge.walk_width(467_442, 32_768, 8) == 8
    assert kedge.walk_width(10, 1, 1) == 8
    assert kedge.walk_width(10**6, 10, 8) == 32
    assert kedge.walk_width(0, 0, 1) == 4
    assert kedge.walk_width(0, 0, kedge.KC) == 4
    assert kedge.walk_width(0, 0, kedge.KC + 1) == 8
    cu = os.path.join(os.path.dirname(kedge.__file__), "..", "csrc",
                      "edge_reduce.cu")
    with open(cu) as fh:
        assert f"constexpr int KC = {kedge.KC};" in fh.read()
