"""Port parity: fused dot-product attention (``dot_attention_aggregate``) and
``attention_aggregate``, against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
fused op runs on tiled plans (``plan=True``, the small settings of
``tests/test_gat_fused.py``), i.e. through its Pallas passes in interpret
mode, once per case in a module fixture; its composed chain (SDDMM, edge
softmax, SpMM with the weights as values) runs on XLA.  The port runs on the
CPU here, i.e. through its kernels' plain versions; the CUDA kernels
themselves are checked in ``tests/test_torch_cuda.py``.

The graph is non-square (56 x 48, D1 with m rows, D2 and B with n) with
empty rows.  Tolerances: rtol/atol 1e-4 forward and 3e-4 gradients, the JAX
fused tests' own; 8e-3 for a bf16 output (one rounding to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.kernels.gat_fused import dot_attention_aggregate as jdot
from gespmm_tpu.ops.graph import attention_aggregate as jattention
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.sparse import formats as jf

from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.sparse import formats as tf

FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=3e-4, atol=3e-4)
M, N, K = 56, 48, 8
EMPTY_ROWS = (0, 21, 55)
PLAN = dict(col_tile=16, rows_per_block=8, chunk_nnz=8, part_rows=24)
# (Ka, negative_slope) of the cases held to the JAX fused op.
CASES = [(6, None), (6, 0.2), (1, None)]


def make_graph(seed=17):
    """(JAX CSR, port CSR) of a 56 x 48 valued matrix with empty rows."""
    rng = np.random.default_rng(seed)
    mat = sp.random(M, N, density=0.12, format="lil", random_state=rng,
                    dtype=np.float64)
    for r in EMPTY_ROWS:
        mat[r, :] = 0
    mat = mat.tocsr().astype(np.float32)
    mat.eliminate_zeros()
    mat.sort_indices()
    indptr, indices = mat.indptr.astype(np.int32), mat.indices.astype(np.int32)
    data = mat.data.astype(np.float32)
    j = jf.CSR(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(data),
               (M, N))
    t = tf.CSR(torch.from_numpy(indptr), torch.from_numpy(indices),
               torch.from_numpy(data), (M, N))
    return j, t


def inputs(Ka, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((M, Ka), (N, Ka), (N, K), (M, K))]


@pytest.fixture(scope="module")
def graph():
    j, t = make_graph()
    return JAdjacency.from_csr(j, plan=True, **PLAN), TAdjacency.from_csr(t)


@pytest.fixture(scope="module")
def jax_fused(graph):
    """The JAX fused op and its VJP, in interpret mode, once per case."""
    jadj, _ = graph
    res = {}
    for Ka, slope in CASES:
        D1, D2, B, g = inputs(Ka)
        out, vjp = jax.vjp(lambda a, b, c: jdot(jadj, a, b, c,
                                                negative_slope=slope),
                           jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(B))
        res[(Ka, slope)] = (np.asarray(out),
                            [np.asarray(x) for x in vjp(jnp.asarray(g))])
    return res


def port_fused(adj, D1, D2, B, g, slope, fn=None):
    """(out, [grad_D1, grad_D2, grad_B]) of the port's op on the CPU."""
    fn = fn or (lambda a, b, c: tgraph.dot_attention_aggregate(
        adj, a, b, c, negative_slope=slope))
    xs = [torch.tensor(x, requires_grad=True) for x in (D1, D2, B)]
    out = fn(*xs)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("Ka,slope", CASES)
def test_fused_matches_jax_fused(graph, jax_fused, Ka, slope):
    _, tadj = graph
    out, grads = port_fused(tadj, *inputs(Ka), slope)
    j_out, j_grads = jax_fused[(Ka, slope)]
    np.testing.assert_allclose(out, j_out, **FWD)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got, want, **GRAD)
    assert np.all(out[list(EMPTY_ROWS)] == 0)
    assert all(np.isfinite(x).all() for x in grads)


@pytest.mark.parametrize("method", ["auto", "tiled", "xla"])
@pytest.mark.parametrize("Ka,slope", CASES)
def test_attention_aggregate_matches_jax(graph, jax_fused, Ka, slope, method):
    """Both of the port's methods against the JAX fused op and against the
    JAX composed chain (``attention_aggregate(method="xla")``)."""
    jadj, tadj = graph
    D1, D2, B, g = inputs(Ka)
    out, grads = port_fused(tadj, D1, D2, B, g, slope, fn=lambda a, b, c:
                            tgraph.attention_aggregate(
                                tadj, a, b, c, negative_slope=slope,
                                method=method))
    j_out, j_grads = jax_fused[(Ka, slope)]
    np.testing.assert_allclose(out, j_out, **FWD)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got, want, **GRAD)
    chain = jattention(JAdjacency.from_csr(jadj.csr), jnp.asarray(D1),
                       jnp.asarray(D2), jnp.asarray(B), negative_slope=slope,
                       method="xla")
    np.testing.assert_allclose(out, np.asarray(chain), **FWD)


def test_fused_grads_match_port_composed_chain(graph):
    _, tadj = graph
    D1, D2, B, g = inputs(5, seed=3)
    fused = port_fused(tadj, D1, D2, B, g, 0.2)
    chain = port_fused(tadj, D1, D2, B, g, 0.2, fn=lambda a, b, c:
                       tgraph.attention_aggregate(tadj, a, b, c,
                                                  negative_slope=0.2,
                                                  method="xla"))
    np.testing.assert_allclose(fused[0], chain[0], **FWD)
    for got, want in zip(fused[1], chain[1]):
        np.testing.assert_allclose(got, want, **GRAD)


def test_plain_versions_hold_to_float64(graph):
    """mx is the exact row max of act(pre); den and out follow; empty rows
    give out 0, mx 0, den 1e-20."""
    _, tadj = graph
    D1, D2, B, _ = (torch.from_numpy(x) for x in inputs(6))
    edges = (tadj.rows, tadj.csr.indices)
    out, mx, den = tref.dot_attention_rows(*edges, D1, D2, B, M, 0.2)
    out64, mx64, den64 = tref.dot_attention_rows(*edges, D1.double(),
                                                 D2.double(), B.double(), M,
                                                 0.2)
    pre = (D1.double()[tadj.rows.long()]
           * D2.double()[tadj.csr.indices.long()]).sum(-1)
    act = torch.where(pre >= 0, pre, 0.2 * pre)
    for r in range(M):
        sel = act[tadj.rows.long() == r]
        want = float(sel.max()) if sel.numel() else 0.0
        assert abs(float(mx64[r]) - want) < 1e-12
    assert float(den[list(EMPTY_ROWS)].max()) == pytest.approx(1e-20)
    assert float(mx[list(EMPTY_ROWS)].abs().max()) == 0.0
    np.testing.assert_allclose(out.numpy(), out64.numpy(), **FWD)
    np.testing.assert_allclose(den.numpy(), den64.numpy(), **FWD)


def test_bf16_B_gives_bf16_out_and_grads_in_input_dtypes(graph):
    _, tadj = graph
    D1, D2, B, g = inputs(6)
    Bb = torch.from_numpy(B).to(torch.bfloat16).requires_grad_(True)
    d1 = torch.from_numpy(D1).requires_grad_(True)
    out = tgraph.dot_attention_aggregate(tadj, d1, torch.from_numpy(D2), Bb)
    assert out.dtype == torch.bfloat16
    out.float().backward(torch.from_numpy(g))
    assert Bb.grad.dtype == torch.bfloat16 and d1.grad.dtype == torch.float32
    # Against JAX on the same bf16-rounded B, in f32: one output rounding.
    jadj, _ = graph
    want = jdot(jadj, jnp.asarray(D1), jnp.asarray(D2),
                jnp.asarray(Bb.detach().float().numpy()))
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(want),
                               rtol=8e-3, atol=8e-3)


def test_interpret_and_bare_csr(graph):
    jadj, tadj = graph
    D1, D2, B, _ = (torch.from_numpy(x) for x in inputs(6))
    ref = tgraph.dot_attention_aggregate(tadj, D1, D2, B)
    # The op on a CPU tensor is the plain version, bit for bit.
    plain, _, _ = tref.dot_attention_rows(tadj.rows, tadj.csr.indices, D1, D2,
                                          B, M, None)
    bare = tgraph.dot_attention_aggregate(tadj.csr, D1, D2, B)
    np.testing.assert_array_equal(plain.numpy(), ref.numpy())
    np.testing.assert_array_equal(bare.numpy(), ref.numpy())


@pytest.mark.parametrize("bad,match", [
    (lambda D1, D2, B: (D1[:, :3], D2, B), "must be"),
    (lambda D1, D2, B: (D1[:10], D2, B), "must match"),
    (lambda D1, D2, B: (D1, D2, B[:10]), "must be"),
])
def test_validation_errors_match_jax(graph, bad, match):
    jadj, tadj = graph
    D1, D2, B, _ = inputs(6)
    with pytest.raises(ValueError, match=match):
        jdot(jadj, *bad(jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(B)))
    with pytest.raises(ValueError, match=match):
        tgraph.dot_attention_aggregate(
            tadj, *bad(torch.from_numpy(D1), torch.from_numpy(D2),
                       torch.from_numpy(B)))
    with pytest.raises(ValueError, match="unknown method"):
        tgraph.attention_aggregate(tadj, torch.from_numpy(D1),
                                   torch.from_numpy(D2), torch.from_numpy(B),
                                   method="pallas")
