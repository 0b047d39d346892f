"""Kernel row 2 (the max/min SpMM forward) with its row split, on the CPU.

The forward kernel walks a row of more than L edges in segments of L
consecutive edges, each segment giving an (extremum, count) pair, and a pair
carry folds a row's pairs in segment order.  On the CPU the wrapper runs the
plain version of that walk (``ops/reference.py::spmm_minmax_split_rows``),
held here to:

* float64: ``out`` equal to the float64 row extremum (scipy's CSR arrays,
  contributions formed in float64) rounded to f32 (to bf16 through f32 for a
  bf16 B), and ``ties`` equal to a NumPy recount of the f32 contributions
  that equal it, exactly; on a graph whose rows 0-4 have L - 1, L, L + 1,
  2L + 1 and 2,000 edges at L = 64 (``split_boundary_graph``), among short
  and empty rows, K in {1, 3, 16, 33, 128}, binary and valued, f32 and bf16,
  max and min, B in multiples of 0.5 so that ties are common;
* the unsplit plain version (``spmm_minmax_rows``), bit for bit: out and
  ties;
* the JAX package's max/min SpMM on the same inputs: its XLA tier (out
  exactly) and its tiled tier's Pallas scan kernel in interpret mode with
  ``want_ties`` (out and ties exactly, as ``tests/test_torch_minmax.py``
  holds the unsplit walk to it);
* the op: ``spmm(reduce="max"|"min")`` takes ``adj.split``.

Inputs come from numpy seeds.  The kernel itself is checked in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.kernels.spmm_stream import spmm_tiled
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.ops.spmm import spmm as jspmm
from gespmm_tpu.sparse import formats as jf

from gespmm_tpu_torch.kernels import spmm_minmax as kmm
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.ops.spmm import spmm as tspmm
from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse.partition import SPLIT_LEN
from gespmm_tpu_torch.utils.datasets import split_boundary_graph

L = SPLIT_LEN
HUB, N = 2000, 2200
KS = [1, 3, 16, 33, 128]
# The JAX tiled tier with the scan kernel (minmax_aligned=False), at chunk
# sizes that keep its interpret mode to seconds on this graph.
SCAN_PLAN = dict(col_tile=128, rows_per_block=64, chunk_nnz=256,
                 part_rows=512, minmax_aligned=False)


def half_steps(shape, seed):
    """Multiples of 0.5 (zeros among them), so that many edges tie."""
    x = np.random.default_rng(seed).standard_normal(shape) * 2
    return (np.round(x) / 2).astype(np.float32)


def boundary(binary, seed=0):
    """(JAX CSR, port CSR) of an N x N graph whose rows 0-4 have L - 1, L,
    L + 1, 2L + 1 and HUB edges, among rows of 0-4 edges (some empty);
    valued: multiples of 0.5, so that products tie too."""
    csr = split_boundary_graph(L, hub=HUB, n=N, seed=seed)
    data = None if binary else half_steps(csr.indices.shape[0], seed + 1)
    indptr, indices = csr.indptr.numpy(), csr.indices.numpy()
    j = jf.CSR(jnp.asarray(indptr), jnp.asarray(indices),
               None if data is None else jnp.asarray(data), csr.shape)
    t = tf.CSR(csr.indptr, csr.indices,
               None if data is None else torch.from_numpy(data), csr.shape)
    return j, t


def float64_oracle(t, B, reduce):
    """(out, ties) from scipy's CSR arrays: the row extremum of the float64
    contributions, and the count of the f32 contributions (the kernel's
    products) equal to that extremum rounded to f32."""
    m = t.shape[0]
    data = (np.ones(t.indices.shape[0]) if t.data is None
            else t.data.numpy().astype(np.float64))
    A = sp.csr_matrix((data, t.indices.numpy(), t.indptr.numpy()),
                      shape=t.shape)
    c64 = A.data[:, None] * B.astype(np.float64)[A.indices]
    c32 = (A.data.astype(np.float32)[:, None] * B.astype(np.float32)[A.indices]
           if t.data is not None else B.astype(np.float32)[A.indices])
    rows = np.repeat(np.arange(m), np.diff(A.indptr))
    nonempty = np.flatnonzero(np.diff(A.indptr))
    red = np.maximum if reduce == "max" else np.minimum
    out = np.zeros((m, B.shape[1]))
    out[nonempty] = red.reduceat(c64, A.indptr[nonempty], axis=0)
    out32 = out.astype(np.float32)
    ties = np.zeros((m, B.shape[1]), np.float32)
    np.add.at(ties, rows, (c32 == out32[rows]).astype(np.float32))
    return out, ties


def split_forward(t, B, reduce):
    adj = TAdjacency.from_csr(t)
    assert adj.split.seg_len == L and adj.split.num_segments > 0
    return kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices, adj.data, B,
                           reduce, rows=adj.rows, split=adj.split)


def test_the_boundary_graph_has_each_row_length():
    _, t = boundary(True)
    deg = np.diff(t.indptr.numpy())
    assert deg[:5].tolist() == [L - 1, L, L + 1, 2 * L + 1, HUB]
    assert (deg == 0).any()
    split = TAdjacency.from_csr(t).split
    assert split.long_rows.tolist() == [2, 3, 4]
    assert np.diff(split.seg_ptr.numpy()).tolist() == [2, 3, -(-HUB // L)]


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", KS)
def test_split_forward_matches_float64(K, binary, dtype, reduce):
    _, t = boundary(binary)
    B = torch.from_numpy(half_steps((N, K), K)).to(dtype)
    out, ties = split_forward(t, B, reduce)
    assert out.dtype == dtype and ties.dtype == torch.float32
    want, want_ties = float64_oracle(t, B.float().numpy(), reduce)
    # Rounding to f32 is monotone and exact for a product of two f32
    # values' float64 product; bf16 rounds the f32 product.
    want = torch.from_numpy(want).float().to(dtype)
    assert torch.equal(out, want)
    np.testing.assert_array_equal(ties.numpy(), want_ties)
    assert ties.max() > 1, "no ties"
    empty = np.flatnonzero(np.diff(t.indptr.numpy()) == 0)
    assert not out[empty].any() and not ties[empty].any()


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", KS)
def test_split_equals_unsplit_bit_for_bit(K, binary, reduce):
    _, t = boundary(binary, seed=2)
    # Signed zeros too: relu'd halves times signed values.
    B = torch.from_numpy(np.maximum(half_steps((N, K), K + 7), 0))
    out, ties = split_forward(t, B, reduce)
    want, want_ties = tref.spmm_minmax_rows(t.row_ids(), t.indices, t.data, B,
                                            N, reduce)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ties.view(torch.int32), want_ties.view(torch.int32))


@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [3, 33])
def test_split_forward_matches_jax_xla(K, binary, reduce):
    j, t = boundary(binary, seed=3)
    B = half_steps((N, K), K)
    want = jspmm(JAdjacency.from_csr(j), jnp.asarray(B), reduce=reduce,
                 method="xla")
    out, _ = split_forward(t, torch.from_numpy(B), reduce)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    # And through the op, which takes the adjacency's split.
    out = tspmm(TAdjacency.from_csr(t), torch.from_numpy(B), reduce=reduce)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def jax_scan():
    """The JAX scan kernel's (out, ties) in interpret mode, once a case."""
    res = {}
    for binary, K, reduce in ((True, 16, "max"), (False, 3, "min")):
        j, _ = boundary(binary, seed=4)
        B = half_steps((N, K), K)
        plan = JAdjacency.from_csr(j, plan=True, **SCAN_PLAN).plan
        out, ties = spmm_tiled(plan, j.data, jnp.asarray(B), N,
                               interpret=True, reduce=reduce, want_ties=True)
        res[binary, K, reduce] = (B, np.asarray(out), np.asarray(ties))
    return res


@pytest.mark.parametrize("binary,K,reduce", [(True, 16, "max"),
                                             (False, 3, "min")])
def test_split_ties_match_the_jax_scan_kernel(jax_scan, binary, K, reduce):
    B, j_out, j_ties = jax_scan[binary, K, reduce]
    _, t = boundary(binary, seed=4)
    out, ties = split_forward(t, torch.from_numpy(B), reduce)
    np.testing.assert_array_equal(out.numpy(), j_out)
    np.testing.assert_array_equal(ties.numpy(), j_ties)
    assert ties[:5].max() > 1, "no ties on the long rows"


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_the_op_forward_takes_the_adjacency_split(monkeypatch, reduce):
    _, t = boundary(False, seed=5)
    adj = TAdjacency.from_csr(t)
    seen = []
    split_rows = tref.spmm_minmax_split_rows

    def spy(*args):
        seen.append(args)
        return split_rows(*args)

    monkeypatch.setattr(tref, "spmm_minmax_split_rows", spy)
    B = torch.from_numpy(half_steps((N, 16), 6)).requires_grad_(True)
    out = tspmm(adj, B, reduce=reduce)
    assert len(seen) == 1
    seg_row, long_rows, seg_ptr, seg_len = seen[0][-4:]
    assert seg_row is adj.split.seg_row and long_rows is adj.split.long_rows
    assert seg_ptr is adj.split.seg_ptr and seg_len == L
    want, _ = tref.spmm_minmax_rows(adj.rows, adj.csr.indices, adj.data,
                                    B.detach(), N, reduce)
    assert torch.equal(out.detach(), want)
    out.sum().backward()  # the backward takes the stored out and ties
    assert torch.isfinite(B.grad).all()


def test_a_graph_without_a_long_row_takes_the_unsplit_walk(monkeypatch):
    _, t = boundary(True)
    short = tf.CSR(t.indptr[5:] - t.indptr[5], t.indices[int(t.indptr[5]):],
                   None, (N - 5, N))
    adj = TAdjacency.from_csr(short)
    assert adj.split.num_segments == 0

    def refuse(*a, **k):
        raise AssertionError("the split walk ran without a segment")

    monkeypatch.setattr(tref, "spmm_minmax_split_rows", refuse)
    B = torch.from_numpy(half_steps((N, 8), 8))
    out, ties = kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices, None, B,
                                "max", split=adj.split)
    want, want_ties = tref.spmm_minmax_rows(adj.rows, adj.csr.indices, None,
                                            B, N - 5, "max")
    assert torch.equal(out, want) and torch.equal(ties, want_ties)
