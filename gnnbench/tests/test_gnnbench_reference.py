"""The plain reference against the program at a tiny size on the CPU, and
the reference's own pieces (the test imports the program; the reference
does not)."""

import pytest
import torch

from gnnbench import calibrate, compare
from gnnbench.reference import common
from gnnbench.tests import tiny_cells

CONFIGS = ["gcn-ogbn-products", "sage-mean-ogbn-products"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cells.make_root(tmp_path_factory.mktemp("gnnbench_ref"))


@pytest.mark.parametrize("config", CONFIGS)
def test_program_steps_match_reference(root, config):
    cell = tiny_cells.tiny_cell(root, config)
    row = calibrate.seed_readings(cell, 31, "cpu", controls=False)
    assert compare.judge(row["program"], cell.limits), row
    assert row["program"]["loss1_gap"] < 1e-5


@pytest.mark.parametrize("config", CONFIGS)
def test_program_forward_matches_reference_forward(config):
    """Logits of the program's model and of the reference from the same
    weights and dropout draws."""
    from gnnbench import harness
    from gnnbench.tests.tiny_cells import TINY_TRAFFIC

    cfg = harness._read(harness.PACKAGE / "configs" / f"{config}.json")
    cell = harness.Cell(name="t", chips=1, config=cfg, traffic=TINY_TRAFFIC,
                        limits={}, metrics={})
    graph, inputs, init = harness.make_inputs(cell, 8, "cpu")
    kind = harness.adapter(cfg)
    model = kind.model(cfg, kind.adjacency(graph, "cpu"), "cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(init[k])
    model.train()
    got = model(kind.adjacency(graph, "cpu"), inputs.x,
                generator=torch.Generator().manual_seed(77))
    edges = common.EdgeGraph.from_csr(graph.n, graph.indptr, graph.indices)
    want = harness.reference(cfg).forward(
        cfg, init, edges, inputs.x, torch.Generator().manual_seed(77),
        torch.matmul)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_blocked_spmm_and_its_gradient_against_dense():
    n = 40
    rows = torch.tensor([0, 0, 1, 5, 5, 5, 39], dtype=torch.int32)
    cols = torch.tensor([1, 7, 0, 2, 3, 39, 5], dtype=torch.int32)
    g = common.EdgeGraph(n=n, rows=rows, cols=cols)
    dense = torch.zeros(n, n)
    dense[rows.long(), cols.long()] = 1.0
    B = torch.randn(n, 9, requires_grad=True)
    old = common.BLOCK_BYTES
    common.BLOCK_BYTES = 2 * 9 * 4  # two edges a block
    try:
        out = common.spmm(g, B)
        (out * torch.arange(9.0)).sum().backward()
    finally:
        common.BLOCK_BYTES = old
    assert torch.allclose(out, dense @ B.detach(), atol=1e-6)
    assert torch.allclose(B.grad, dense.t() @ torch.arange(9.0).expand(n, 9),
                          atol=1e-6)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0])
    got = common.round_tf32(x)
    assert got.tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -3.0]


def test_adam_matches_torch_adam():
    torch.manual_seed(0)
    p0 = torch.randn(5, 3)
    x = torch.randn(7, 5)

    def forward(params, graph, x, gen, mm):
        return mm(x, params["w"])

    labels = torch.tensor([0, 1, 2, 0, 1, 2, 0])
    mask = torch.ones(7, dtype=torch.bool)
    got = common.train(forward, None, x, labels, mask, {"w": p0}, 1, lr=0.01)
    w = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=0.01)
    for _ in range(3):
        opt.zero_grad()
        common.masked_nll(x @ w, labels, torch.arange(7)).backward()
        opt.step()
    assert torch.allclose(got.delta["w"], w.detach() - p0, atol=1e-7)
