"""The port's graph transformer (``models/transformer.py``: ``TransformerConv``
and ``UniMP``) and the multi-head fused dot-attention op on the CPU route.

The port's ``UniMP`` is held to the plain reference of the benchmark
(``gnnbench/reference/unimp.py``) on seeded random weights, through the
benchmark's own set-up and checked steps (``gnnbench/harness.py``): the
logits, the first gradient of every leaf and every leaf after 3 Adam steps,
with attention dropout on and off.  Widths: the cell's own (heads of 32 and
47), odd hidden heads (15) and three heads.  The graph has empty rows and
rows above L = 64 edges (the kernels' segment length).  Tolerances, each
from f32 sums taken in another order (the fused op's plain version against
the reference's blocked ``index_add_``), measured at a fifth of each bound
or less:

* logits: 1e-5, relative and absolute;
* every leaf's first gradient: 1e-5 of the leaf's largest entry (the
  keys' biases, whose gradient is rounding, left out as the benchmark
  leaves them out);
* every leaf after 3 Adam steps: its change within 2e-3 of the reference's
  change, by norm (Adam divides each entry's gradient by its own size, so
  an entry whose gradient is rounding-sized moves by up to the learning
  rate in either direction).

The multi-head op against one single-head call a head (the scale folded
into D1, each head's mask column), forward and gradients within 1e-5; at one
head without a scale or a mask, the plain version against the single-head
arithmetic it had before heads, bit for bit; the CSC backward reading the
mask in CSR edge order through ``Adjacency.perm``, which it requires.
"""

import numpy as np
import pytest
import torch

from gnnbench import compare, graphgen, harness
from gnnbench.reference import common as ref_common
from gnnbench.reference import unimp as ref_unimp
from gespmm_tpu_torch.kernels import gat_fused as kgat
from gespmm_tpu_torch.models.transformer import TransformerConv, UniMP
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.graph import dot_attention_aggregate
from gespmm_tpu_torch.ops.spmm import Adjacency
from gespmm_tpu_torch.sparse.formats import CSR

N = 400
HUBS = (150, 90)  # rows (and columns) above L = 64 edges
EMPTY = 40


def _graph(seed=0):
    """A directed N-node CSR: 0-6 random in-edges a row, ``EMPTY`` empty
    rows, and the first rows (and columns) hubs of ``HUBS`` edges."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, N)
    deg[rng.choice(np.arange(len(HUBS), N), EMPTY, replace=False)] = 0
    deg[:len(HUBS)] = HUBS
    rows = np.repeat(np.arange(N), deg)
    cols = np.concatenate([np.sort(rng.choice(N, d, replace=False))
                           for d in deg])
    hub_in = np.concatenate([rng.choice(np.arange(len(HUBS), N), d,
                                        replace=False) for d in HUBS])
    rows = np.concatenate([rows, hub_in])
    cols = np.concatenate([cols, np.repeat(np.arange(len(HUBS)), HUBS)])
    keys = np.unique(rows * N + cols)
    rows, cols = keys // N, keys % N
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=N))])
    return graphgen.Graph(n=N, indptr=torch.from_numpy(indptr.astype(np.int32)),
                          indices=torch.from_numpy(cols.astype(np.int32)))


def _cell(dims, heads, attn_dropout):
    config = {"name": "unimp-test", "kind": "unimp", "dims": list(dims),
              "heads": heads, "attn_dropout": attn_dropout,
              "lr": 0.001, "self_loops": False,
              "in_features": dims[0], "num_classes": dims[-1]}
    return harness.Cell(name="unimp-test", chips=1, config=config,
                        traffic={"train_nodes": 120}, limits={}, metrics={})


def _inputs(cell, graph, seed):
    inputs = graphgen.make_inputs(cell.traffic, cell.config, graph.n, seed,
                                  "cpu")
    init = ref_common.init_params(
        ref_unimp.param_shapes(cell.config),
        graphgen.generator(seed, "weights", "cpu"), "cpu")
    # Nonzero biases, LayerNorm gains and offsets, so that each leaf shows.
    gen = torch.Generator().manual_seed(seed)
    for k, v in init.items():
        if v.dim() == 1:
            init[k] = 0.1 * torch.randn(v.shape, generator=gen)
    return inputs, init


# (dims, heads): the cell's widths (heads of 32, 47 at the output), odd
# hidden heads (15), three heads of 8 and 5.
SHAPES = [([12, 64, 64, 47], 2), ([10, 30, 30, 7], 2), ([9, 24, 5], 3)]


def test_graph_has_empty_rows_and_rows_above_a_segment():
    g = _graph()
    deg = (g.indptr[1:] - g.indptr[:-1]).numpy()
    col = np.bincount(g.indices.numpy(), minlength=N)
    assert (deg == 0).sum() >= EMPTY and deg.max() > 64 and col.max() > 64


@pytest.mark.parametrize("attn_dropout", [0.0, 0.3])
@pytest.mark.parametrize("dims,heads", SHAPES)
def test_logits_match_reference(dims, heads, attn_dropout):
    cell = _cell(dims, heads, attn_dropout)
    graph = _graph()
    inputs, init = _inputs(cell, graph, 3)
    adj = harness.adapter(cell.config).adjacency(graph, "cpu")
    model = harness.adapter(cell.config).model(cell.config, adj, "cpu")
    named = dict(model.named_parameters())
    assert set(named) == set(init)
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(init[k])
    model.train()
    got = model(adj, inputs.x, generator=torch.Generator().manual_seed(77))
    edges = ref_common.EdgeGraph.from_csr(graph.n, graph.indptr,
                                          graph.indices)
    want = ref_unimp.forward(cell.config, init, edges, inputs.x,
                             torch.Generator().manual_seed(77), torch.matmul)
    assert got.shape == (N, dims[-1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn_dropout", [0.0, 0.3])
@pytest.mark.parametrize("dims,heads", SHAPES)
def test_first_gradients_and_three_adam_steps_match_reference(dims, heads,
                                                              attn_dropout):
    cell = _cell(dims, heads, attn_dropout)
    graph, seed = _graph(1), 2**31 + 7
    inputs, init = _inputs(cell, graph, seed)
    prog = harness.build_program(cell, graph, inputs, init, seed, "cpu",
                                 harness.Clock(torch.device("cpu")))
    got = harness.checked_steps(prog, init)
    want = harness.reference_readings(cell, graph, inputs, init, seed)
    torch.testing.assert_close(got.losses, want.losses, rtol=1e-5, atol=0)
    assert set(got.grad1) == set(want.grad1) == set(init)
    # A key's bias adds one constant to a row's logits, which the softmax
    # takes away: its gradient is rounding, and the comparison that decides
    # ``correct`` leaves it out (``compare.LEAF_FLOOR``), as here.
    kept = compare.leaf_gaps(got, want)["grad1"]
    assert set(init) - set(kept) == {f"layer_{i}.key.b"
                                     for i in range(len(dims) - 1)}
    for k in kept:
        scale = float(want.grad1[k].abs().max())
        err = float((got.grad1[k] - want.grad1[k]).abs().max())
        assert err <= 1e-5 * scale, (k, err, scale)
        moved = float(want.delta[k].norm())
        assert moved > 0, k
        assert float((got.delta[k] - want.delta[k]).norm()) <= 2e-3 * moved, k


def test_dropout_changes_the_steps_and_draws_one_mask_a_layer():
    cell = _cell([12, 64, 64, 47], 2, 0.3)
    graph = _graph()
    inputs, init = _inputs(cell, graph, 5)
    adj = harness.adapter(cell.config).adjacency(graph, "cpu")
    model = harness.adapter(cell.config).model(cell.config, adj, "cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(init[k])
    gen = torch.Generator().manual_seed(9)
    model.train()
    dropped = model(adj, inputs.x, generator=gen)
    # Three layers: three (nnz, 2) draws from the generator.
    replay = torch.Generator().manual_seed(9)
    for _ in range(3):
        torch.rand((adj.nnz, 2), generator=replay)
    assert torch.equal(gen.get_state(), replay.get_state())
    model.eval()
    kept = model(adj, inputs.x)
    assert not torch.allclose(dropped, kept)
    model.train()
    again = model(adj, inputs.x, generator=torch.Generator().manual_seed(9))
    assert torch.equal(dropped, again)


def _leaves(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen, dtype=torch.float64,
                        requires_grad=True) for s in shapes]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads,dk,dv", [(2, 32, 32), (2, 47, 47), (3, 4, 6)])
def test_multi_head_op_equals_one_call_a_head(heads, dk, dv, masked):
    g = _graph()
    adj = Adjacency.from_csr(CSR(g.indptr, g.indices, None, (N, N)))
    D1, D2, B = _leaves(((N, heads * dk), (N, heads * dk), (N, heads * dv)),
                        0)
    cot = torch.randn(N, heads * dv, generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    scale = dk ** -0.5
    keep = (torch.rand((adj.nnz, heads),
                       generator=torch.Generator().manual_seed(2)) < 0.7
            if masked else None)
    kw = dict(keep_prob=0.7) if masked else {}
    got = dot_attention_aggregate(adj, D1, D2, B, heads=heads, scale=scale,
                                  edge_keep=keep, **kw)
    g_got = torch.autograd.grad((got * cot).sum(), (D1, D2, B))
    parts = []
    for h in range(heads):
        d, v = slice(h * dk, (h + 1) * dk), slice(h * dv, (h + 1) * dv)
        parts.append(dot_attention_aggregate(
            adj, D1[:, d] * scale, D2[:, d].contiguous(),
            B[:, v].contiguous(),
            edge_keep=None if keep is None else keep[:, h:h + 1].contiguous(),
            **kw))
    want = torch.cat(parts, 1)
    g_want = torch.autograd.grad((want * cot).sum(), (D1, D2, B))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_csc_backward_reads_the_csr_mask_through_perm():
    # The CSC walk takes the mask in CSR edge order with Adjacency.perm, and
    # refuses it without perm.
    g = _graph()
    adj = Adjacency.from_csr(CSR(g.indptr, g.indices, None, (N, N)))
    H, dh = 2, 5
    gen = torch.Generator().manual_seed(6)
    D1, D2, B, cot = (torch.randn(N, H * dh, generator=gen, dtype=torch.float64)
                      for _ in range(4))
    keep = torch.rand((adj.nnz, H), generator=gen) < 0.7
    kw = dict(heads=H, scale=dh ** -0.5, keep=keep, keep_prob=0.7)
    edges = (adj.rows, adj.csr.indices)
    out, mx, den = tref.dot_attention_rows(*edges, D1, D2, B, N, **kw)
    tabs = (D1, D2, B, cot, mx, den, tref.dot_row_dot(cot, out, H))
    want = tref.dot_attention_vjp_cols(*edges, *tabs, **kw)
    kw = dict(heads=H, scale=dh ** -0.5, edge_keep=keep, keep_prob=0.7)
    got = kgat.dot_backward_cols(adj.csc.indptr, adj.csc.indices, *tabs,
                                 perm=adj.perm, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="needs perm"):
        kgat.dot_backward_cols(adj.csc.indptr, adj.csc.indices, *tabs, **kw)


def _old_single_head(rows, cols, D1, D2, B, g, m):
    """The single-head plain arithmetic of the op before heads (identity
    act): out, mx, den, grad_D1, grad_D2, grad_B."""
    r, c = rows.long(), cols.long()
    pre = (D1.index_select(0, r) * D2.index_select(0, c)).sum(-1)
    mx = tref.edge_segment_rows(rows, pre[:, None], m, "max")[:, 0]
    z = torch.exp(torch.clamp(pre - mx.index_select(0, r),
                              min=tref.EXP_FLOOR))
    den = torch.clamp(torch.zeros(m).index_add_(0, r, z), min=tref.DENOM_EPS)
    out = torch.zeros((m, B.shape[1])).index_add_(
        0, r, B.index_select(0, c) * z[:, None]) / den[:, None]
    s = (g * out).sum(-1)
    alpha = (torch.exp(torch.clamp(pre - mx[r], min=tref.EXP_FLOOR))
             / torch.clamp(den, min=tref.DENOM_EPS)[r])
    u = (g.index_select(0, r) * B.index_select(0, c)).sum(-1)
    dpre = alpha * (u - s[r]) * torch.ones_like(pre)
    gD1 = torch.zeros_like(D1).index_add_(0, r, D2.index_select(0, c)
                                          * dpre[:, None])
    gD2 = torch.zeros_like(D2).index_add_(0, c, D1.index_select(0, r)
                                          * dpre[:, None])
    gB = torch.zeros_like(B).index_add_(0, c, g.index_select(0, r)
                                        * alpha[:, None])
    return out, mx, den, gD1, gD2, gB


def test_one_head_without_scale_or_mask_keeps_the_single_head_bits():
    g = _graph()
    rows = torch.repeat_interleave(torch.arange(N, dtype=torch.int32),
                                   g.indptr[1:] - g.indptr[:-1])
    gen = torch.Generator().manual_seed(4)
    D1, D2 = (torch.randn(N, 16, generator=gen) for _ in range(2))
    B, cot = (torch.randn(N, 24, generator=gen) for _ in range(2))
    out, mx, den = tref.dot_attention_rows(rows, g.indices, D1, D2, B, N)
    s = tref.dot_row_dot(cot, out)
    tabs = (D1, D2, B, cot, mx, den, s)
    gD1 = tref.dot_attention_vjp_rows(rows, g.indices, *tabs, N)
    gD2, gB = tref.dot_attention_vjp_cols(rows, g.indices, *tabs)
    for a, b in zip((out, mx, den, gD1, gD2, gB),
                    _old_single_head(rows, g.indices, D1, D2, B, cot, N)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_layer_leaves_and_merges():
    conv = TransformerConv(8, 5, heads=3, concat=False,
                           generator=torch.Generator().manual_seed(0))
    shapes = {k: tuple(p.shape) for k, p in conv.named_parameters()}
    assert shapes == {"query.w": (8, 15), "query.b": (15,), "key.w": (8, 15),
                      "key.b": (15,), "value.w": (8, 15), "value.b": (15,),
                      "skip.w": (8, 5), "skip.b": (5,), "beta.w": (15, 1)}
    g = _graph()
    adj = Adjacency.from_csr(CSR(g.indptr, g.indices, None, (N, N)))
    x = torch.randn(N, 8, generator=torch.Generator().manual_seed(1))
    assert conv(adj, x).shape == (N, 5)
    with pytest.raises(ValueError, match="unknown method"):
        conv(adj, x, method="pallas")
    with pytest.raises(ValueError, match="multiple of heads"):
        UniMP([8, 10, 3], heads=4)


def test_fused_and_composed_routes_agree():
    g = _graph()
    adj = Adjacency.from_csr(CSR(g.indptr, g.indices, None, (N, N)))
    x = torch.randn(N, 12, generator=torch.Generator().manual_seed(1))
    outs = []
    for method in ("auto", "xla"):
        model = UniMP([12, 64, 64, 47], heads=2, method=method,
                      generator=torch.Generator().manual_seed(0))
        out = model(adj, x, generator=torch.Generator().manual_seed(3))
        names = [k for k, _ in model.named_parameters()]
        grads = torch.autograd.grad(out.square().sum(),
                                    list(model.parameters()))
        outs.append((out, dict(zip(names, grads))))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    (_, fused), (_, composed) = outs
    for k, b in composed.items():
        if k.endswith("key.b"):  # rounding: the softmax takes it away
            continue
        torch.testing.assert_close(fused[k], b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
