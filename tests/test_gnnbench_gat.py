"""The benchmark's GAT configuration (``gnnbench/``) on the CPU at a tiny
size: the program's GAT with skip projections (4 heads, hidden layers
concatenated, the output layer averaged) against the plain reference
``gnnbench/reference/gat.py`` on seeded random weights; a tiny cell of the
configuration through the harness; the reference's blocked attention
against a dense softmax; the adapter's work and the fused walks' bytes
against hand counts.

The graph is the tiny traffic of ``gnnbench/tests/tiny_cells.py`` (300
nodes, 1,500 undirected edges, self-loops), the widths the configuration's
own, [100, 128 x 4, 128 x 4, 47].  Tolerances, each from f32 sums taken
in another order (the fused op's plain version against ``index_add_``,
measured at a fifth of each bound or less):

* logits: 1e-5, relative and absolute;
* every leaf's first gradient: 1e-5 of the leaf's largest entry;
* every leaf after 3 Adam steps: its change within 2e-3 of the
  reference's change, by norm.  Adam divides each entry's gradient by its
  own size, so an entry whose gradient is rounding-sized moves by up to the
  learning rate in either direction (measured 3.4e-4 at most).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gnnbench import attention_roofline, harness
from gnnbench.models import gat as gat_adapter
from gnnbench.reference import common as ref_common
from gnnbench.reference import gat as ref_gat
from gnnbench.tests import tiny_cells

CONFIG = "gat-ogbn-products"
REPO = Path(__file__).resolve().parent.parent
N = 2_449_029
NNZ = 126_167_309


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tiny_cells.make_root(tmp_path_factory.mktemp("gnnbench_gat"))
    return tiny_cells.tiny_cell(root, CONFIG)


def _config():
    return json.loads((harness.PACKAGE / "configs" / f"{CONFIG}.json")
                      .read_text())


def test_configuration_is_pygs_at_its_widths():
    cfg = _config()
    assert cfg["kind"] == "gat" and cfg["reduced"] == []
    assert cfg["dims"] == [100, 128, 128, 47] and cfg["heads"] == 4
    assert cfg["skip"] is True and cfg["self_loops"] is True
    assert (cfg["negative_slope"], cfg["dropout"], cfg["lr"]) == (0.2, 0.5,
                                                                  0.001)
    shapes = ref_gat.param_shapes(cfg)
    assert shapes["layer_1.w"] == (512, 512)
    assert shapes["layer_2.w"] == (512, 188)
    assert shapes["skip_0.w"] == (100, 512) and shapes["skip_2.w"] == (512, 47)


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_program_logits_match_reference(cell, seed):
    cfg = cell.config
    graph, inputs, init = harness.make_inputs(cell, seed, "cpu")
    adapter = harness.adapter(cfg)
    adj = adapter.adjacency(graph, "cpu")
    model = adapter.model(cfg, adj, "cpu")
    named = dict(model.named_parameters())
    assert set(named) == set(init)
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(init[k])
    model.train()
    got = model(adj, inputs.x, generator=torch.Generator().manual_seed(77))
    edges = ref_common.EdgeGraph.from_csr(graph.n, graph.indptr,
                                          graph.indices)
    want = ref_gat.forward(cfg, init, edges, inputs.x,
                           torch.Generator().manual_seed(77), torch.matmul)
    assert got.shape == (300, 47)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [31, 2**31 + 7])
def test_first_gradients_and_three_adam_steps_match_reference(cell, seed):
    graph, inputs, init = harness.make_inputs(cell, seed, "cpu")
    prog = harness.build_program(cell, graph, inputs, init, seed, "cpu",
                                 harness.Clock(torch.device("cpu")))
    got = harness.checked_steps(prog, init)
    want = harness.reference_readings(cell, graph, inputs, init, seed)
    torch.testing.assert_close(got.losses, want.losses, rtol=1e-5, atol=0)
    assert set(got.grad1) == set(want.grad1) == set(init)
    for k in init:
        scale = float(want.grad1[k].abs().max())
        err = float((got.grad1[k] - want.grad1[k]).abs().max())
        assert err <= 1e-5 * scale, (k, err, scale)
        moved = float(want.delta[k].norm())
        assert moved > 0, k
        assert float((got.delta[k] - want.delta[k]).norm()) <= 2e-3 * moved, k


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_gat_cell_through_the_harness(cell, tmp_path, trace):
    result = harness.run(cell, 2**31 + 11, 0.5, trace, "cpu", 0.0,
                         trace_dir=tmp_path / "traces")
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in cell.metrics[kind]}
    assert set(result["metrics"]) <= names
    if trace:
        # The CPU has no device trace: the GAT readers find nothing there.
        assert {"gat_op_ms", "gat_roofline"} <= names
        assert "step_mfu" in result["metrics"]
    else:
        assert {"step_ms", "setup_s"} <= set(result["metrics"])
        # A percentile needs two steps; a loaded CPU may fit one in the
        # window.
        assert ("step_ms_p90" in result["metrics"]) == \
            (result["attempted"] >= 2)


def _dense_attention(n, rows, cols, src, dst, z, heads, slope):
    """The softmax over each row as a dense masked (n, n) matrix a head."""
    dh = z.shape[1] // heads
    mask = torch.zeros(n, n, dtype=torch.bool)
    mask[rows.long(), cols.long()] = True
    outs = []
    for h in range(heads):
        logit = torch.nn.functional.leaky_relu(
            src[:, h, None] + dst[None, :, h], slope)
        alpha = torch.softmax(logit.masked_fill(~mask, float("-inf")), 1)
        alpha = torch.nan_to_num(alpha)  # rows without an edge
        outs.append(alpha @ z[:, h * dh:(h + 1) * dh])
    return torch.cat(outs, 1)


@pytest.mark.parametrize("block_bytes", [4 * 6 * 3, 1 << 31])
def test_reference_attention_against_a_dense_softmax(monkeypatch, block_bytes):
    """Blocks of a few edges' rows (a row longer than a block is one alone)
    or one block; values and autograd's gradients against the dense
    softmax, float64, with empty rows."""
    monkeypatch.setattr(ref_gat, "BLOCK_BYTES", block_bytes)
    n, heads = 7, 2
    rows = torch.tensor([0, 0, 0, 0, 0, 1, 3, 3, 5, 6, 6, 6],
                        dtype=torch.int32)
    cols = torch.tensor([0, 1, 2, 4, 6, 1, 0, 3, 5, 2, 5, 6],
                        dtype=torch.int32)
    graph = ref_common.EdgeGraph(n=n, rows=rows, cols=cols)
    blocks = ref_gat.row_blocks(torch.tensor([0, 5, 6, 6, 8, 8, 9, 12]), 6)
    if block_bytes < 1 << 31:
        assert blocks == [(0, 1), (1, 5), (5, 6), (6, 7)]
    else:
        assert blocks == [(0, 7)]
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(shape, generator=gen, dtype=torch.float64,
                          requires_grad=True)
              for shape in ((n, heads), (n, heads), (n, 6))]
    cot = torch.randn(n, 6, generator=gen, dtype=torch.float64)
    got = ref_gat.attention(graph, *leaves, heads, 0.2)
    g_got = torch.autograd.grad((got * cot).sum(), leaves)
    want = _dense_attention(n, rows, cols, *leaves, heads, 0.2)
    g_want = torch.autograd.grad((want * cot).sum(), leaves)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert torch.equal(got[[2, 4]], torch.zeros(2, 6, dtype=torch.float64))


def test_adapter_counts_the_steps_work():
    cfg = _config()
    proj = (2 * 2 * N * 100 * 512 + 3 * 2 * N * 512 * 512
            + 3 * 2 * N * 512 * 188)
    skip = (2 * 2 * N * 100 * 512 + 3 * 2 * N * 512 * 512
            + 3 * 2 * N * 512 * 47)
    assert gat_adapter.dense_flops(cfg, N) == proj + skip
    assert sorted(k for _, _, k in gat_adapter.spmm_calls(cfg, N, NNZ)) == \
        [188, 188, 512, 512, 512, 512]
    assert gat_adapter.attention_calls(cfg, N, NNZ) == [
        (N, N, NNZ, 512, 4), (N, N, NNZ, 512, 4), (N, N, NNZ, 188, 4)]
    assert gat_adapter.SPMM_SITES == ()


def test_walk_bytes_and_operations_by_hand():
    """A 5-node graph of 9 edges, 2 heads of 3 columns."""
    m = n = 5
    nnz, K, H = 9, 6, 2
    idx = 6 * 4 + 9 * 4          # indptr (or colptr), indices (or rows)
    src = dst = 5 * 2 * 4        # (5, H) f32
    table = 5 * 6 * 4            # B, out, g, grad_B: (5, K) f32
    small = 5 * 2 * 4            # mx, den, s_row, grad_src, grad_dst
    assert attention_roofline.gat_work("fwd", m, n, nnz, K, H) == (
        idx + src + dst + table + table + 2 * small, 9 * (2 * 6 + 6 * 2))
    assert attention_roofline.gat_work("bwd_rows", m, n, nnz, K, H) == (
        idx + src + dst + table + 2 * table + 3 * small + small,
        9 * (2 * 6 + 8 * 2) + 4 * 5 * 6)
    assert attention_roofline.gat_work("bwd_cols", m, n, nnz, K, H) == (
        idx + src + dst + table + table + 3 * small + table + small,
        9 * (4 * 6 + 10 * 2) + 2 * 5 * 6)
    with pytest.raises(ValueError, match="unknown walk"):
        attention_roofline.gat_work("bwd", m, n, nnz, K, H)


def test_a_products_step_is_bound_by_bytes():
    cfg = _config()
    calls = gat_adapter.attention_calls(cfg, N, NNZ)
    for call in calls:
        for kind in attention_roofline.KINDS:
            _, term = attention_roofline.bound(
                *attention_roofline.gat_work(kind, *call))
            assert term == "bytes", (kind, call)
    assert 0.025 < attention_roofline.gat_bound_s(calls) < 0.035


def test_reference_imports_only_torch_and_the_reference():
    path = REPO / "gnnbench" / "reference" / "gat.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] in {"__future__", "typing", "torch"} \
                or mod.startswith("gnnbench.reference"), mod
    code = ("import sys, gnnbench.reference.gat; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gespmm_tpu', 'gespmm_tpu_torch')))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
