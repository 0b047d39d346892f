"""The benchmark's UniMP configuration (``gnnbench/``) on the CPU at a tiny
size: a tiny cell of the configuration through the harness; the reference's
blocked attention against a dense per-head softmax with attention dropout;
the adapter's work and the fused walks' bytes against hand counts; the
metrics' readers; and the reference's imports.  The port against the
reference on seeded weights is ``tests/test_torch_transformer.py``.

The graph is the tiny traffic of ``gnnbench/tests/tiny_cells.py`` (300
nodes, 1,500 undirected edges, no self-loops), the widths the
configuration's own, [100, 32 x 2, 32 x 2, 47 x 2 averaged].
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gnnbench import dot_roofline, harness
from gnnbench.models import unimp as unimp_adapter
from gnnbench.reference import common as ref_common
from gnnbench.reference import unimp as ref_unimp
from gnnbench.tests import tiny_cells

CONFIG = "unimp-ogbn-products"
CELL = "unimp-products.powerlaw"
REPO = Path(__file__).resolve().parent.parent
N = 2_449_029
NNZ = 123_718_280


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tiny_cells.make_root(tmp_path_factory.mktemp("gnnbench_unimp"))
    return tiny_cells.tiny_cell(root, CONFIG)


def _config():
    return json.loads((harness.PACKAGE / "configs" / f"{CONFIG}.json")
                      .read_text())


def test_configuration_is_pygs_at_its_widths():
    cfg = _config()
    assert cfg["kind"] == "unimp" and cfg["reduced"] == []
    assert cfg["dims"] == [100, 64, 64, 47] and cfg["heads"] == 2
    assert cfg["beta"] is True and cfg["layer_norm"] is True
    assert cfg["self_loops"] is False
    assert (cfg["attn_dropout"], cfg["lr"]) == (0.3, 0.001)
    assert cfg["precision"] == "float32, TF32 off"
    assert cfg["source"].endswith("examples/unimp_arxiv.py")
    shapes = ref_unimp.param_shapes(cfg)
    assert shapes["layer_0.query.w"] == (100, 64)
    assert shapes["layer_1.value.w"] == (64, 64)
    assert shapes["layer_2.key.w"] == (64, 94)
    assert shapes["layer_2.skip.w"] == (64, 47)
    assert shapes["layer_0.beta.w"] == (192, 1)
    assert shapes["layer_2.beta.w"] == (141, 1)
    assert shapes["norm_1.w"] == (64,) and "norm_2.w" not in shapes


def test_benchmark_holds_the_cell_and_its_metrics():
    bench = harness.load_bench()
    cell = harness.find_cell(bench, CELL)
    assert cell.chips == 1 and cell.config["name"] == CONFIG
    assert cell.traffic["name"] == "powerlaw"
    names = {m["name"] for m in cell.metrics["per_layer"]}
    assert {"dot_op_ms", "dot_roofline", "dense_ms", "dropout_ms",
            "step_mfu", "device_idle_share", "kernels_per_step",
            "graph_build_s", "unattributed_ms", "step_host_ms"} == names
    assert {m["name"] for m in cell.metrics["end_to_end"]} == {
        "step_ms", "step_ms_p90", "peak_mem_gib", "setup_s"}
    assert set(cell.limits) <= {"loss1_gap", "grad1_gap", "grad1_worst_gap",
                                "update3_gap"}


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_unimp_cell_through_the_harness(cell, tmp_path, trace):
    result = harness.run(cell, 2**31 + 11, 0.5, trace, "cpu", 0.0,
                         trace_dir=tmp_path / "traces")
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in cell.metrics[kind]}
    assert set(result["metrics"]) <= names
    if trace:
        # The CPU has no device trace: the dot readers find nothing there.
        assert {"dot_op_ms", "dot_roofline"} <= names
        assert "step_mfu" in result["metrics"]
    else:
        assert {"step_ms", "setup_s"} <= set(result["metrics"])


def test_a_planted_half_batch_reads_incorrect(cell):
    seed = 2**31 + 13
    graph, inputs, init = harness.make_inputs(cell, seed, "cpu")
    ref = harness.reference_readings(cell, graph, inputs, init, seed)
    half = harness.reference_readings(cell, graph, inputs, init, seed,
                                      half_batch=True)
    from gnnbench import compare

    assert not compare.judge(compare.numbers(half, ref), cell.limits)


def _dense_attention(n, rows, cols, q, k, v, heads, scale, keep, keep_prob):
    """The softmax over each row as a dense masked (n, n) matrix a head,
    then the dropout mask (scattered to the same matrix)."""
    dk, dv = q.shape[1] // heads, v.shape[1] // heads
    mask = torch.zeros(n, n, dtype=torch.bool)
    mask[rows.long(), cols.long()] = True
    outs = []
    for h in range(heads):
        logit = (q[:, h * dk:(h + 1) * dk] @ k[:, h * dk:(h + 1) * dk].t()
                 * scale)
        alpha = torch.softmax(logit.masked_fill(~mask, float("-inf")), 1)
        alpha = torch.nan_to_num(alpha)  # rows without an edge
        if keep is not None:
            drop = torch.zeros(n, n, dtype=alpha.dtype)
            drop[rows.long(), cols.long()] = keep[:, h].to(alpha.dtype)
            alpha = alpha * drop / keep_prob
        outs.append(alpha @ v[:, h * dv:(h + 1) * dv])
    return torch.cat(outs, 1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block_bytes", [4 * 6 * 3, 1 << 31])
def test_reference_attention_against_a_dense_softmax(monkeypatch, block_bytes,
                                                     masked):
    """Blocks of a few edges' rows (a row longer than a block is one alone)
    or one block; values and autograd's gradients against the dense
    softmax, float64, with empty rows, with the dropout mask or without."""
    monkeypatch.setattr(ref_unimp, "BLOCK_BYTES", block_bytes)
    n, heads = 7, 2
    rows = torch.tensor([0, 0, 0, 0, 0, 1, 3, 3, 5, 6, 6, 6],
                        dtype=torch.int32)
    cols = torch.tensor([0, 1, 2, 4, 6, 1, 0, 3, 5, 2, 5, 6],
                        dtype=torch.int32)
    graph = ref_common.EdgeGraph(n=n, rows=rows, cols=cols)
    blocks = ref_unimp.row_blocks(torch.tensor([0, 5, 6, 6, 8, 8, 9, 12]), 6)
    if block_bytes < 1 << 31:
        assert blocks == [(0, 1), (1, 5), (5, 6), (6, 7)]
    else:
        assert blocks == [(0, 7)]
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(shape, generator=gen, dtype=torch.float64,
                          requires_grad=True)
              for shape in ((n, 4), (n, 4), (n, 6))]
    keep = (torch.rand((12, heads), generator=gen) < 0.7) if masked else None
    cot = torch.randn(n, 6, generator=gen, dtype=torch.float64)
    got = ref_unimp.attention(graph, *leaves, heads, 0.5, keep, 0.7)
    g_got = torch.autograd.grad((got * cot).sum(), leaves)
    want = _dense_attention(n, rows, cols, *leaves, heads, 0.5, keep, 0.7)
    g_want = torch.autograd.grad((want * cot).sum(), leaves)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert torch.equal(got[[2, 4]], torch.zeros(2, 6, dtype=torch.float64))


def test_adapter_counts_the_steps_work():
    cfg = _config()
    qkv = (2 * 3 * 2 * N * 100 * 64 + 3 * 3 * 2 * N * 64 * 64
           + 3 * 3 * 2 * N * 64 * 94)
    skip = 2 * 2 * N * 100 * 64 + 3 * 2 * N * 64 * 64 + 3 * 2 * N * 64 * 47
    gate = 3 * 2 * N * (192 + 192 + 141)
    assert unimp_adapter.dense_flops(cfg, N) == qkv + skip + gate
    assert sorted(k for _, _, k in unimp_adapter.spmm_calls(cfg, N, NNZ)) == \
        [64, 64, 64, 64, 94, 94]
    assert unimp_adapter.dot_calls(cfg, N, NNZ) == [
        (N, N, NNZ, 64, 64, 2), (N, N, NNZ, 64, 64, 2),
        (N, N, NNZ, 94, 94, 2)]
    assert unimp_adapter.SPMM_SITES == ()
    # Not the GAT's reader's name: gat_roofline finds nothing here.
    assert not hasattr(unimp_adapter, "attention_calls")


@pytest.mark.parametrize("masked", [False, True])
def test_walk_bytes_and_operations_by_hand(masked):
    """A 5-node graph of 9 edges, 2 heads: D1 and D2 4 wide, B 6 wide."""
    m = n = 5
    nnz, K, Ka, H = 9, 6, 4, 2
    idx = 6 * 4 + 9 * 4          # indptr (or colptr), indices (or rows)
    d = 5 * 4 * 4                # D1, D2, grad_D1, grad_D2: (5, Ka) f32
    table = 5 * 6 * 4            # B, out, g, grad_B: (5, K) f32
    small = 5 * 2 * 4            # mx, den, s_row: (5, H) f32
    mask = 9 * 2 if masked else 0
    perm = 9 * 4 if masked else 0
    assert dot_roofline.dot_work("fwd", m, n, nnz, K, Ka, H, masked) == (
        idx + 2 * d + table + mask + table + 2 * small,
        9 * (2 * 4 + 2 * 6 + 6 * 2))
    assert dot_roofline.dot_work("bwd_rows", m, n, nnz, K, Ka, H, masked) == (
        idx + 2 * d + table + mask + 2 * table + 3 * small + small + d,
        9 * (4 * 4 + 2 * 6 + 10 * 2) + 2 * 5 * 6)
    assert dot_roofline.dot_work("bwd_cols", m, n, nnz, K, Ka, H, masked) == (
        idx + perm + 2 * d + table + mask + table + 3 * small + d + table,
        9 * (4 * 4 + 4 * 6 + 10 * 2))
    with pytest.raises(ValueError, match="unknown walk"):
        dot_roofline.dot_work("bwd", m, n, nnz, K, Ka, H)


def test_a_products_step_is_bound_by_bytes():
    calls = unimp_adapter.dot_calls(_config(), N, NNZ)
    for call in calls:
        for kind in dot_roofline.KINDS:
            _, term = dot_roofline.bound(
                *dot_roofline.dot_work(kind, *call, masked=True))
            assert term == "bytes", (kind, call)
    bound = dot_roofline.dot_bound_s(calls, masked=True)
    assert 0.011 < bound < 0.015
    assert bound > dot_roofline.dot_bound_s(calls)


def _run(config, trace):
    return {"adapter": unimp_adapter, "config": config, "n": N, "nnz": NNZ,
            "trace": trace}


def test_dot_readers_take_the_programs_spans(monkeypatch):
    from gnnbench import spans

    run = _run(_config(), {"steps": 3})
    readers = {k: harness.metric_reader(k) for k in ("dot_op_ms",
                                                     "dot_roofline")}
    monkeypatch.setattr(spans, "from_run", lambda r: None)
    assert readers["dot_op_ms"](run) is None
    assert readers["dot_roofline"](run) is None
    table = {"device_ms": {"op/dot": 60.0, "op/dot.grad": 140.0,
                           "model/dense": 30.0}}
    monkeypatch.setattr(spans, "from_run", lambda r: table)
    assert readers["dot_op_ms"](run) == 200.0
    bound = dot_roofline.dot_bound_s(unimp_adapter.dot_calls(
        _config(), N, NNZ), masked=True)
    assert readers["dot_roofline"](run) == pytest.approx(
        100.0 * bound / 0.2)
    # A program without the dot spans (the parent of this configuration):
    # nothing to read, and no error.
    monkeypatch.setattr(spans, "from_run",
                        lambda r: {"device_ms": {"model/dense": 30.0}})
    assert readers["dot_op_ms"](run) is None
    assert readers["dot_roofline"](run) is None


def test_reference_imports_only_torch_and_the_reference():
    path = REPO / "gnnbench" / "reference" / "unimp.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] in {"__future__", "typing", "math",
                                         "torch"} \
                or mod.startswith("gnnbench.reference"), mod
    code = ("import sys, gnnbench.reference.unimp; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gespmm_tpu', 'gespmm_tpu_torch')))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
