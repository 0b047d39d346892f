"""The GAT's skip projections (``GAT(..., skip=True)``, PyG's ogbn-products
GAT): off, the model is the one the JAX parity tests hold, bit for bit;
on, a ``Dense`` a layer on the layer's dropped input, added before the ELU.
The plain reference of the benchmark holds the whole model with skips
(``tests/test_gnnbench_gat.py``).

A small SBM graph with self-loops on the CPU (the fused op's plain version).
"""

import pytest
import torch

from gespmm_tpu_torch.models.common import dropout
from gespmm_tpu_torch.models.gat import GAT, GATConv
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops.spmm import Adjacency
from gespmm_tpu_torch.utils import datasets as tds

DIMS = [16, 8, 8, 3]


@pytest.fixture(scope="module")
def problem():
    ds = tds.sbm_graph(n_per_class=20, num_classes=3, p_in=0.15, p_out=0.02,
                       feat_dim=16, seed=0)
    adj = Adjacency.from_csr(tgraph.add_self_loops(ds.csr))
    return adj, torch.as_tensor(ds.features)


def parent_forward(model, adj, x, gen):
    """The GAT's forward before it had skips: dropout, the layer, ELU
    between layers."""
    h = x
    for i in range(model.n_layers):
        last = i == model.n_layers - 1
        h = dropout(h, model.dropout_rate, model.training, gen)
        h = getattr(model, f"layer_{i}")(
            adj, h, negative_slope=model.negative_slope, method=model.method,
            merge="mean" if last else "concat")
        if not last:
            h = torch.nn.functional.elu(h)
    return h


def grads(model, out):
    model.zero_grad(set_to_none=True)
    cot = torch.linspace(-1.0, 1.0, out.numel()).view_as(out)
    (out * cot).sum().backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("heads", [1, 4])
def test_skip_off_keeps_the_model_bit_for_bit(problem, heads):
    adj, x = problem
    model = GAT(DIMS, heads=heads, generator=torch.Generator().manual_seed(3))
    # The parameters the parent drew: one GATConv a layer from one generator.
    gen = torch.Generator().manual_seed(3)
    want = {}
    for i in range(len(DIMS) - 1):
        conv = GATConv(DIMS[i] * (heads if i else 1), DIMS[i + 1], heads,
                       generator=gen)
        want.update({f"layer_{i}.{k}": v
                     for k, v in conv.state_dict().items()})
    got = model.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    model.train()
    out = model(adj, x, generator=torch.Generator().manual_seed(5))
    g = grads(model, out)
    ref = parent_forward(model, adj, x, torch.Generator().manual_seed(5))
    g_ref = grads(model, ref)
    assert torch.equal(out, ref)
    assert all(torch.equal(g[k], g_ref[k]) for k in g)


def test_skip_on_names_widths_and_draws(problem):
    heads = 4
    off = GAT(DIMS, heads=heads, generator=torch.Generator().manual_seed(3))
    on = GAT(DIMS, heads=heads, skip=True,
             generator=torch.Generator().manual_seed(3))
    sd_off, sd_on = off.state_dict(), on.state_dict()
    # The layers draw first, as without skips; the skips after them.
    assert all(torch.equal(sd_on[k], v) for k, v in sd_off.items())
    skips = {k: tuple(v.shape) for k, v in sd_on.items() if k not in sd_off}
    assert skips == {
        "skip_0.w": (16, 32), "skip_0.b": (32,),
        "skip_1.w": (32, 32), "skip_1.b": (32,),
        "skip_2.w": (32, 3), "skip_2.b": (3,)}


def test_skip_is_added_to_the_layer_before_the_elu(problem):
    adj, x = problem
    model = GAT(DIMS, heads=4, skip=True,
                generator=torch.Generator().manual_seed(7)).eval()
    with torch.no_grad():
        for i in range(3):
            model.get_submodule(f"skip_{i}").b.uniform_(
                -1.0, 1.0, generator=torch.Generator().manual_seed(i))
    h = x
    for i in range(3):
        last = i == 2
        out = getattr(model, f"layer_{i}")(
            adj, h, merge="mean" if last else "concat")
        skip = getattr(model, f"skip_{i}")
        out = out + (h @ skip.w + skip.b)
        h = out if last else torch.nn.functional.elu(out)
    assert torch.equal(model(adj, x), h)


def test_skip_shares_the_layers_dropout_draw(problem):
    # Dropout at rate 1 zeroes the input of every layer, so the skip adds
    # its bias alone and the layer attends over zero rows.
    adj, x = problem
    model = GAT([16, 3], heads=2, dropout_rate=1.0, skip=True,
                generator=torch.Generator().manual_seed(0)).train()
    with torch.no_grad():
        model.skip_0.b.fill_(0.25)
    out = model(adj, x, generator=torch.Generator().manual_seed(1))
    want = model.layer_0(adj, torch.zeros_like(x), merge="mean") + 0.25
    assert torch.equal(out, want)
