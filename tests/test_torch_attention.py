"""Port parity: SDDMM, edge softmax, additive logits, the edge segment reduce and the fused GAT attention op, against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs with tiled plans (``plan=True``, the small settings of
``tests/test_gat_fused.py``), so that ``edge_softmax`` and
``additive_attention_logits`` go through ``spmm_stream.edge_segment_reduce``
and the fused op through its Pallas passes, all in interpret mode.  Each
JAX call is made once, in a module-scoped fixture.  The port runs on the
CPU here, i.e. through its kernels' plain versions; the CUDA kernels
themselves are checked in ``tests/test_torch_cuda.py``.

Tolerances: the fused op at rtol/atol 1e-4 forward and 2e-4 gradients, the
JAX fused tests' own; the edge ops, SDDMM and the segment reduce at 1e-5
(both sides accumulate in f32, in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.kernels.gat_fused import gat_attention_aggregate as jgat
from gespmm_tpu.kernels.spmm_stream import edge_segment_reduce as jsegment
from gespmm_tpu.ops import graph as jgraph
from gespmm_tpu.ops.sddmm import sddmm as jsddmm
from gespmm_tpu.ops.sddmm import sddmm_coo as jsddmm_coo
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.sparse import formats as jf

from gespmm_tpu_torch.kernels import edge_reduce as kedge
from gespmm_tpu_torch.kernels import gat_fused as kgat
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops import sddmm as tsddmm
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.sparse import formats as tf

FUSED_FWD = dict(rtol=1e-4, atol=1e-4)
FUSED_GRAD = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
M, N = 44, 36
EMPTY_ROWS = (0, 17, 43)
PLAN = dict(col_tile=1 << 20, rows_per_block=8, chunk_nnz=8)
SLOPE = 0.2


def make_graph(m=M, n=N, seed=0):
    """(JAX Adjacency with plans, port Adjacency, scipy CSR) of an m x n
    valued matrix with empty rows."""
    rng = np.random.default_rng(seed)
    mat = sp.random(m, n, density=0.12, format="lil", random_state=rng,
                    dtype=np.float64)
    for r in EMPTY_ROWS:
        mat[r, :] = 0
    mat = mat.tocsr().astype(np.float32)
    mat.eliminate_zeros()
    mat.sort_indices()
    indptr = mat.indptr.astype(np.int32)
    indices = mat.indices.astype(np.int32)
    data = mat.data.astype(np.float32)
    j = jf.CSR(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(data),
               (m, n))
    t = tf.CSR(torch.from_numpy(indptr), torch.from_numpy(indices),
               torch.from_numpy(data), (m, n))
    return JAdjacency.from_csr(j, plan=True, **PLAN), TAdjacency.from_csr(t), mat


@pytest.fixture(scope="module")
def graphs():
    return make_graph()


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def to_t(*arrays, grad=True):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


# --- the fused op --------------------------------------------------------

FUSED_CASES = [(1, 8, "exact"), (1, 8, "bound"), (3, 4, "exact"),
               (3, 4, "bound")]


@pytest.fixture(scope="module")
def jax_fused(graphs):
    """{(H, max_mode): (inputs, out, grads)} of JAX's fused op, one vjp
    each.  heads=1 hands in 1-D scores."""
    jadj = graphs[0]
    rng = np.random.default_rng(5)
    results = {}
    for H, dh, max_mode in FUSED_CASES:
        src, dst = rand(rng, M, H), rand(rng, N, H)
        if H == 1:
            src, dst = src[:, 0], dst[:, 0]
        B, w = rand(rng, N, H * dh), rand(rng, M, H * dh)

        def f(s, d, b, H=H, max_mode=max_mode):
            return jgat(jadj, s, d, b, negative_slope=SLOPE, heads=H,
                        max_mode=max_mode)

        out, vjp = jax.vjp(f, *map(jnp.asarray, (src, dst, B)))
        grads = [np.asarray(x) for x in vjp(jnp.asarray(w))]
        results[(H, max_mode)] = ((src, dst, B, w), np.asarray(out), grads)
    return results


@pytest.mark.parametrize("H,dh,max_mode", FUSED_CASES)
def test_gat_fused_matches_jax(graphs, jax_fused, H, dh, max_mode):
    (src, dst, B, w), want, want_grads = jax_fused[(H, max_mode)]
    s, d, b = to_t(src, dst, B)
    before = (kgat.launches, kgat.bwd_rows_launches, kgat.bwd_cols_launches)
    out = tgraph.gat_attention_aggregate(graphs[1], s, d, b, heads=H,
                                       max_mode=max_mode)
    np.testing.assert_allclose(out.detach().numpy(), want, **FUSED_FWD)
    out.backward(torch.from_numpy(w))
    for got, ref, name in zip((s.grad, d.grad, b.grad), want_grads,
                              ("src", "dst", "B")):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, err_msg=f"grad_{name}",
                                   **FUSED_GRAD)
    # On the CPU the wrapper runs the plain version: nothing is launched.
    assert (kgat.launches, kgat.bwd_rows_launches,
            kgat.bwd_cols_launches) == before


@pytest.mark.parametrize("dh", [1, 3, 8])
def test_gat_fused_heads_batch_as_separate_heads(graphs, dh):
    # H heads in one call equal H single-head calls on the head slices,
    # forward and gradients, for head blocks of any width.
    H = 3
    rng = np.random.default_rng(dh)
    src, dst, B, w = rand(rng, M, H), rand(rng, N, H), rand(rng, N, H * dh), \
        rand(rng, M, H * dh)
    s, d, b = to_t(src, dst, B)
    out = tgraph.gat_attention_aggregate(graphs[1], s, d, b, heads=H)
    (out * torch.from_numpy(w)).sum().backward()
    for h in range(H):
        cols = slice(h * dh, (h + 1) * dh)
        s1, d1, b1 = to_t(src[:, h], dst[:, h], B[:, cols])
        o1 = tgraph.gat_attention_aggregate(graphs[1], s1, d1, b1)
        (o1 * torch.from_numpy(w[:, cols])).sum().backward()
        torch.testing.assert_close(out[:, cols], o1, **TOL)
        torch.testing.assert_close(s.grad[:, h], s1.grad, **TOL)
        torch.testing.assert_close(d.grad[:, h], d1.grad, **TOL)
        torch.testing.assert_close(b.grad[:, cols], b1.grad, **TOL)


def test_gat_fused_residuals_and_interpret(graphs):
    rng = np.random.default_rng(11)
    src, dst, B = map(torch.from_numpy, (rand(rng, M, 2), rand(rng, N, 2),
                                         rand(rng, N, 6)))
    adj = graphs[1]
    out, mx, den = kgat.gat_forward(adj.csr.indptr, adj.csr.indices, src, dst,
                                    B, heads=2)
    pre = src[adj.rows.long()] + dst[adj.csr.indices.long()]
    want_mx = tref.edge_segment_rows(adj.rows, tref.leaky(pre, SLOPE), M, "max")
    torch.testing.assert_close(mx, want_mx, rtol=0, atol=0)
    empty = list(EMPTY_ROWS)
    assert not mx[empty].any() and torch.all(den[empty] == tref.DENOM_EPS)
    assert torch.all(den[[r for r in range(M) if r not in empty]] >= 1.0)
    _, mx_b, _ = kgat.gat_forward(adj.csr.indptr, adj.csr.indices, src, dst, B,
                                  heads=2, max_mode="bound")
    torch.testing.assert_close(mx_b, tref.leaky(src + dst.max(0).values, SLOPE))
    # The op on a CPU tensor is the plain version, bit for bit.
    torch.testing.assert_close(
        tgraph.gat_attention_aggregate(adj, src, dst, B, heads=2), out,
        rtol=0, atol=0)


def test_gat_fused_empty_rows_and_bf16(graphs):
    rng = np.random.default_rng(3)
    src, dst, B = to_t(rand(rng, M), rand(rng, N), rand(rng, N, 8))
    out = tgraph.gat_attention_aggregate(graphs[1], src, dst, B)
    assert not out[list(EMPTY_ROWS)].any()
    out.sum().backward()
    for g in (src.grad, dst.grad, B.grad):
        assert torch.isfinite(g).all()
    assert not src.grad[list(EMPTY_ROWS)].any()
    Bh = B.detach().to(torch.bfloat16).requires_grad_(True)
    oh = tgraph.gat_attention_aggregate(graphs[1], src.detach(), dst.detach(), Bh)
    assert oh.dtype == torch.bfloat16 and torch.isfinite(oh.float()).all()
    torch.testing.assert_close(oh.float(), out.detach(), rtol=2e-2, atol=2e-2)
    oh.float().sum().backward()
    assert Bh.grad.dtype == torch.bfloat16


def test_gat_fused_validates_inputs(graphs):
    rng = np.random.default_rng(4)
    src, dst, B = map(torch.from_numpy, (rand(rng, M), rand(rng, N),
                                         rand(rng, N, 8)))
    adj = graphs[1]
    with pytest.raises(ValueError, match="single head"):
        tgraph.gat_attention_aggregate(adj, src[:10], dst, B)
    with pytest.raises(ValueError, match="must be"):
        tgraph.gat_attention_aggregate(adj, src, dst, B[:10])
    with pytest.raises(ValueError, match="must be"):
        tgraph.gat_attention_aggregate(adj, src[:, None].expand(M, 3),
                                     dst[:, None].expand(N, 3), B[:, :7],
                                     heads=3)
    with pytest.raises(ValueError, match="max_mode"):
        tgraph.gat_attention_aggregate(adj, src, dst, B, max_mode="approx")
    # A bare CSR is paired on the fly.
    torch.testing.assert_close(
        tgraph.gat_attention_aggregate(adj.csr, src, dst, B),
        tgraph.gat_attention_aggregate(adj, src, dst, B))


# --- edge softmax, additive logits, the segment reduce --------------------


@pytest.fixture(scope="module")
def jax_edge(graphs):
    """JAX values and vjps of edge_softmax and additive_attention_logits
    (1-D and 2-head), through edge_segment_reduce."""
    jadj, _, mat = graphs
    rng = np.random.default_rng(7)
    res = {}
    for H in (1, 2):
        shape = (lambda *s: s) if H == 2 else (lambda *s: s[:1])
        logits, w = rand(rng, *shape(mat.nnz, H)), rand(rng, *shape(mat.nnz, H))
        alpha, vjp = jax.vjp(lambda l: jgraph.edge_softmax(jadj, l),
                             jnp.asarray(logits))
        res[("softmax", H)] = ((logits, w), np.asarray(alpha),
                               [np.asarray(vjp(jnp.asarray(w))[0])])
        src, dst = rand(rng, *shape(M, H)), rand(rng, *shape(N, H))
        e, vjp = jax.vjp(
            lambda s, d: jgraph.additive_attention_logits(jadj, s, d),
            jnp.asarray(src), jnp.asarray(dst))
        res[("logits", H)] = ((src, dst, w), np.asarray(e),
                              [np.asarray(x) for x in vjp(jnp.asarray(w))])
    return res


@pytest.mark.parametrize("method", ["auto", "xla"])
@pytest.mark.parametrize("H", [1, 2])
def test_edge_softmax_matches_jax(graphs, jax_edge, H, method):
    (logits, w), want, (want_grad,) = jax_edge[("softmax", H)]
    (lt,) = to_t(logits)
    alpha = tgraph.edge_softmax(graphs[1], lt, method=method)
    np.testing.assert_allclose(alpha.detach().numpy(), want, **TOL)
    alpha.backward(torch.from_numpy(w))
    np.testing.assert_allclose(lt.grad.numpy(), want_grad, **TOL)
    sums = tref.edge_segment_rows(graphs[1].rows, alpha.detach().reshape(
        alpha.shape[0], -1), M, "sum")
    nonempty = [r for r in range(M) if r not in EMPTY_ROWS]
    torch.testing.assert_close(sums[nonempty], torch.ones_like(sums[nonempty]))


@pytest.mark.parametrize("method", ["auto", "xla"])
@pytest.mark.parametrize("H", [1, 2])
def test_additive_attention_logits_match_jax(graphs, jax_edge, H, method):
    (src, dst, w), want, want_grads = jax_edge[("logits", H)]
    s, d = to_t(src, dst)
    e = tgraph.additive_attention_logits(graphs[1], s, d, method=method)
    np.testing.assert_allclose(e.detach().numpy(), want, **TOL)
    e.backward(torch.from_numpy(w))
    for got, ref in zip((s.grad, d.grad), want_grads):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_edge_segment_reduce_matches_jax(graphs, op):
    jadj, tadj, mat = graphs
    vals = rand(np.random.default_rng(9), mat.nnz, 3)
    want = np.asarray(jsegment(jadj.plan, jnp.asarray(vals), op))
    out = kedge.edge_segment_reduce(tadj.csr.indptr, torch.from_numpy(vals), op)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    assert not out[list(EMPTY_ROWS)].any()
    bf = kedge.edge_segment_reduce(tadj.csr.indptr,
                                   torch.from_numpy(vals).to(torch.bfloat16), op)
    assert bf.dtype == torch.bfloat16


def test_edge_ops_validate_their_arguments(graphs):
    adj = graphs[1]
    vals = torch.zeros(adj.nnz, 2)
    with pytest.raises(ValueError, match="op must be"):
        kedge.edge_segment_reduce(adj.csr.indptr, vals, "min")
    with pytest.raises(ValueError, match="vals must be"):
        tref.edge_segment_rows(adj.rows, vals[:, 0], M, "sum")
    with pytest.raises(ValueError, match="method"):
        tgraph.edge_softmax(adj, vals, method="pallas")
    with pytest.raises(ValueError, match="method"):
        tgraph.additive_attention_logits(adj, torch.zeros(M), torch.zeros(N),
                                         method="dense")
    # A bare CSR is paired on the fly.
    torch.testing.assert_close(tgraph.edge_softmax(adj.csr, vals),
                               tgraph.edge_softmax(adj, vals))


# --- SDDMM ---------------------------------------------------------------


@pytest.mark.parametrize("method", ["auto", "xla"])
def test_sddmm_and_grads_match_jax(method):
    jadj, tadj, mat = make_graph(seed=2)
    rng = np.random.default_rng(13)
    D1, D2, w = rand(rng, M, 5), rand(rng, N, 5), rand(rng, mat.nnz)
    want, vjp = jax.vjp(lambda a, b: jsddmm(jadj, a, b, method=method),
                        jnp.asarray(D1), jnp.asarray(D2))
    want_grads = vjp(jnp.asarray(w))
    a, b = to_t(D1, D2)
    out = tsddmm.sddmm(tadj, a, b, method=method)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    out.backward(torch.from_numpy(w))
    for got, ref in zip((a.grad, b.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # A bare CSR gives the same values.
    torch.testing.assert_close(tsddmm.sddmm(tadj.csr, a, b), out)


def test_sddmm_coo_matches_jax():
    _, tadj, mat = make_graph(seed=2)
    coo = mat.tocoo()
    rows, cols = coo.row.astype(np.int32), coo.col.astype(np.int32)
    rng = np.random.default_rng(17)
    D1, D2, w = rand(rng, M, 4), rand(rng, N, 4), rand(rng, mat.nnz)
    want, vjp = jax.vjp(
        lambda a, b: jsddmm_coo(jnp.asarray(rows), jnp.asarray(cols), a,
                                      b, shape=(M, N)),
        jnp.asarray(D1), jnp.asarray(D2))
    a, b = to_t(D1, D2)
    out = tsddmm.sddmm_coo(torch.from_numpy(rows), torch.from_numpy(cols), a, b,
                           shape=(M, N))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    out.backward(torch.from_numpy(w))
    for got, ref in zip((a.grad, b.grad), vjp(jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    bf = tsddmm.sddmm(tadj, a.detach().to(torch.bfloat16),
                      b.detach().to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="must be"):
        tsddmm.sddmm(tadj, a, b[:, :3])
    with pytest.raises(ValueError, match="method"):
        tsddmm.sddmm_coo(torch.from_numpy(rows), torch.from_numpy(cols), a, b,
                         method="tiled")


def test_gat_attention_matches_jax():
    jadj, tadj, _ = make_graph(seed=6)
    rng = np.random.default_rng(19)
    q, k = rand(rng, M, 4), rand(rng, N, 4)
    want = jgraph.gat_attention(JAdjacency.from_csr(jadj.csr), jnp.asarray(q),
                                jnp.asarray(k), method="xla")
    for method in ("auto", "xla"):
        out = tgraph.gat_attention(tadj, torch.from_numpy(q),
                                   torch.from_numpy(k), method=method)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
