"""The benchmark's GraphSAGE-pool configuration (``gnnbench/``) on the CPU at
a tiny size: the reference against the port's ``GraphSAGE(aggregator=
"pool")`` on seeded weights, on a graph with empty rows, a hub row above
the split length and exact ties; the reference's blocked max against its
unblocked self and a dense float64 max; the adapter's work and the max
walks' bytes against hand counts; the metrics' readers on a hand-made
trace with the max/min spans; a tiny cell through the harness; and the
configuration and limits files as the harness finds them.
"""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gnnbench import compare, graphgen, harness, minmax_roofline, spans
from gnnbench.models import sage_pool as pool_adapter
from gnnbench.reference import common as ref_common
from gnnbench.reference import sage_pool as ref_pool
from gnnbench.tests import tiny_cells
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.sparse.formats import CSR
from gespmm_tpu_torch.sparse.partition import SPLIT_LEN

CONFIG = "sage-pool-ogbn-products"
CELL = "sage-pool-products.powerlaw"
REPO = Path(__file__).resolve().parent.parent
N = 2_449_029
NNZ = 123_718_280


def _config():
    return json.loads((harness.PACKAGE / "configs" / f"{CONFIG}.json")
                      .read_text())


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tiny_cells.make_root(tmp_path_factory.mktemp("gnnbench_pool"))
    return tiny_cells.tiny_cell(root, CONFIG)


def test_configuration_is_ogbs_widths_with_the_pool_aggregator():
    cfg = _config()
    assert cfg["kind"] == "sage_pool" and cfg["aggregator"] == "pool"
    assert cfg["reduced"] == [] and cfg["self_loops"] is False
    assert cfg["dims"] == [100, 256, 256, 47]
    assert cfg["pool_dims"] == cfg["dims"][:-1]
    assert (cfg["dropout"], cfg["lr"]) == (0.5, 0.01)
    assert cfg["precision"] == "float32, TF32 off"
    assert "1706.02216" in cfg["assumed"]["model"]
    assert cfg["source"] == "https://arxiv.org/abs/1706.02216"
    shapes = ref_pool.param_shapes(cfg)
    assert shapes["layer_0.pool.w"] == (100, 100)
    assert shapes["layer_1.pool.w"] == (256, 256)
    assert shapes["layer_2.pool.b"] == (256,)
    assert shapes["layer_2.self.w"] == (256, 47)
    assert shapes["layer_0.neigh.b"] == (256,)
    assert len(shapes) == 15
    with pytest.raises(ValueError, match="aggregator"):
        ref_pool.param_shapes(dict(cfg, aggregator="mean"))


def test_benchmark_holds_the_cell_and_its_metrics():
    cell = harness.find_cell(harness.load_bench(), CELL)
    assert cell.chips == 1 and cell.config["name"] == CONFIG
    assert cell.traffic["name"] == "powerlaw"
    assert {m["name"] for m in cell.metrics["per_layer"]} == {
        "minmax_op_ms", "minmax_roofline", "dense_ms", "dropout_ms",
        "step_mfu", "device_idle_share", "kernels_per_step",
        "graph_build_s", "unattributed_ms", "step_host_ms"}
    assert {m["name"] for m in cell.metrics["end_to_end"]} == {
        "step_ms", "step_ms_p90", "peak_mem_gib", "setup_s"}
    assert set(cell.limits) <= set(compare.NUMBERS)
    limits = json.loads((harness.PACKAGE / "limits" / f"{CELL}.json")
                        .read_text())
    for name, limit in cell.limits.items():
        lower = limits["readings"][name]["lower"]
        upper = limits["readings"][name]["upper"]
        assert lower < limit < upper, name
    layer = {m["layer"] for m in cell.metrics["per_layer"]
             if m["name"].startswith("minmax")}
    assert len(layer) == 1 and "rows 2 and 3" in layer.pop()


def test_the_configuration_is_no_other_configurations_source_and_cut():
    configs = harness.load_bench()["configs"]
    entry = next(c for c in configs if c["name"] == CONFIG)
    assert entry["source"] == _config()["source"]
    assert all((c["source"], c["reduced"]) != (entry["source"], entry["reduced"])
               for c in configs if c["name"] != CONFIG)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_pool_cell_through_the_harness(cell, tmp_path, trace):
    result = harness.run(cell, 2**31 + 11, 0.2, trace, "cpu", 0.0,
                         trace_dir=tmp_path / "traces")
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in cell.metrics[kind]}
    assert set(result["metrics"]) <= names
    if trace:
        # The CPU has no device trace: the max readers find nothing there.
        assert {"minmax_op_ms", "minmax_roofline"} <= names
        assert "step_mfu" in result["metrics"]
    else:
        assert {"step_ms", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("planted", ["half_batch", "tf32"])
def test_the_control_and_a_half_batch_read_incorrect(cell, planted):
    seed = 2**31 + 13
    graph, inputs, init = harness.make_inputs(cell, seed, "cpu")
    ref = harness.reference_readings(cell, graph, inputs, init, seed)
    other = harness.reference_readings(cell, graph, inputs, init, seed,
                                       **{planted: True})
    assert not compare.judge(compare.numbers(other, ref), cell.limits)


def _hub_graph(n=160, hub=3, hub_degree=SPLIT_LEN * 2 + 7, seed=0):
    """Rows of 1-6 edges, rows 0 and 10-14 empty, row ``hub`` with
    ``hub_degree`` edges (above the split length); columns sorted in each
    row, no self-loop."""
    gen = torch.Generator().manual_seed(seed)
    deg = torch.randint(1, 7, (n,), generator=gen)
    deg[0] = 0
    deg[10:15] = 0
    deg[hub] = hub_degree
    indptr = torch.zeros(n + 1, dtype=torch.int32)
    indptr[1:] = torch.cumsum(deg, 0)
    cols = []
    for r in range(n):
        others = torch.cat([torch.arange(r), torch.arange(r + 1, n)])
        pick = others[torch.randperm(n - 1, generator=gen)[:int(deg[r])]]
        cols.append(torch.sort(pick).values)
    return indptr, torch.cat(cols).to(torch.int32)


def _tied_features(n, width, seed=0):
    """Integer-valued rows drawn from 4 distinct rows: nodes that share a
    row give the same pooled row, so a row with two of them among its
    edges ties exactly."""
    gen = torch.Generator().manual_seed(seed)
    base = torch.randint(-2, 3, (4, width), generator=gen).to(torch.float32)
    return base[torch.randint(0, 4, (n,), generator=gen)]


def _tiny_cell(dims, dropout):
    cfg = dict(_config(), dims=dims, pool_dims=dims[:-1], dropout=dropout,
               in_features=dims[0], num_classes=dims[-1])
    return harness.Cell(name="tiny-pool", chips=1, config=cfg, traffic={},
                        limits={}, metrics={})


@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("features", ["gaussian", "tied"])
def test_reference_against_the_ports_graphsage_pool(dropout, features):
    """Three Adam steps of the port's GraphSAGE(aggregator="pool") and of
    the reference from the same seeded weights, inputs and dropout seed:
    the first loss, every leaf's first gradient and its change after the
    third step agree to f32 rounding."""
    dims = [12, 16, 16, 5]
    indptr, indices = _hub_graph()
    n = indptr.shape[0] - 1
    gen = torch.Generator().manual_seed(7)
    x = (_tied_features(n, dims[0]) if features == "tied"
         else torch.randn(n, dims[0], generator=gen))
    graph = graphgen.Graph(n=n, indptr=indptr, indices=indices)
    inputs = graphgen.Inputs(
        x=x, labels=torch.randint(0, dims[-1], (n,), generator=gen),
        train_mask=torch.rand(n, generator=gen) < 0.5)
    cell = _tiny_cell(dims, dropout)
    init = ref_common.init_params(ref_pool.param_shapes(cell.config),
                                  torch.Generator().manual_seed(8), "cpu")
    seed = 2**31 + 17
    prog = harness.build_program(cell, graph, inputs, init, seed, "cpu",
                                 harness.Clock(torch.device("cpu")))
    got = harness.checked_steps(prog, init)
    want = harness.reference_readings(cell, graph, inputs, init, seed)
    values = compare.numbers(got, want)
    assert all(v < 1e-5 for v in values.values()), values
    for a, b in zip(got.losses, want.losses):
        assert a == pytest.approx(b, rel=1e-5)
    for k in init:
        torch.testing.assert_close(got.grad1[k], want.grad1[k], rtol=1e-4,
                                   atol=1e-6)


def _ties_of(p, indptr, indices):
    """The edges achieving each row's maximum, counted per channel."""
    rows = torch.repeat_interleave(torch.arange(indptr.shape[0] - 1),
                                   (indptr[1:] - indptr[:-1]).long())
    src = p[indices.long()]
    a = torch.zeros(indptr.shape[0] - 1, p.shape[1], dtype=p.dtype)
    a.scatter_reduce_(0, rows[:, None].expand_as(src), src, "amax",
                      include_self=False)
    return torch.zeros_like(a).index_add_(0, rows,
                                          (src == a[rows]).to(p.dtype))


def test_max_aggregate_against_the_ports_max_spmm_with_ties():
    """The reference's max and its gradient against the port's ``spmm(
    reduce="max")`` on the hub graph with planted ties: the same maximum
    bit for bit (0 in the empty rows), and the same tie-split gradient."""
    indptr, indices = _hub_graph()
    n = indptr.shape[0] - 1
    p = torch.relu(_tied_features(n, 24) @ torch.randint(
        -1, 2, (24, 24), generator=torch.Generator().manual_seed(3)).float())
    ties = _ties_of(p, indptr, indices)
    assert (ties > 1).any() and int(indptr[4] - indptr[3]) > SPLIT_LEN
    adj = Adjacency.from_csr(CSR(indptr, indices, None, (n, n)))
    assert adj.split.num_segments > 0
    graph = ref_common.EdgeGraph.from_csr(n, indptr, indices)
    g = torch.randn(n, 24, generator=torch.Generator().manual_seed(4))
    a_ref = p.clone().requires_grad_(True)
    a_port = p.clone().requires_grad_(True)
    got = ref_pool.max_aggregate(graph, a_ref)
    want = spmm(adj, a_port, reduce="max")
    assert torch.equal(got, want)
    assert not got[[0, 10, 11, 12, 13, 14]].any()
    (got * g).sum().backward()
    (want * g).sum().backward()
    torch.testing.assert_close(a_ref.grad, a_port.grad, rtol=1e-6,
                               atol=1e-7)


def _dense_max(p, indptr, indices):
    """The max aggregate as a dense masked (n, n, K) maximum in float64,
    its gradient split evenly among ties by hand."""
    n = indptr.shape[0] - 1
    mask = torch.zeros(n, n, dtype=torch.bool)
    rows = torch.repeat_interleave(torch.arange(n),
                                   (indptr[1:] - indptr[:-1]).long())
    mask[rows, indices.long()] = True
    vals = torch.where(mask[:, :, None], p[None, :, :],
                       torch.tensor(-math.inf, dtype=p.dtype))
    a = vals.max(1).values
    a = torch.where(mask.any(1)[:, None], a, torch.zeros((), dtype=p.dtype))
    hit = mask[:, :, None] & (vals == a[:, None, :])
    return a, hit


@pytest.mark.parametrize("block_bytes", [4 * 24 * 9, 1 << 31])
def test_blocked_max_equals_unblocked_and_a_dense_max(monkeypatch,
                                                      block_bytes):
    """Blocks of about 9 edges' rows (the hub row a block alone) or one
    block: the same maximum and gradient bit for bit, and both those of a
    dense float64 maximum with the gradient split evenly among ties."""
    indptr, indices = _hub_graph(n=40, hub=5, hub_degree=30)
    n = indptr.shape[0] - 1
    graph = ref_common.EdgeGraph.from_csr(n, indptr, indices)
    p = torch.relu(_tied_features(n, 24, seed=1).double()
                   @ torch.randn(24, 24, dtype=torch.float64,
                                 generator=torch.Generator().manual_seed(5)))
    p = torch.round(p)  # integer values: ties beyond the zeros
    g = torch.randn(n, 24, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(6))

    def run():
        leaf = p.clone().requires_grad_(True)
        out = ref_pool.max_aggregate(graph, leaf)
        (out * g).sum().backward()
        return out.detach(), leaf.grad

    whole = run()
    monkeypatch.setattr(ref_pool, "BLOCK_BYTES", block_bytes)
    blocks = ref_pool.edge_blocks(graph, 24)
    if block_bytes < 1 << 31:
        assert len(blocks) > 3
        assert (5, int(indptr[5]), int(indptr[6])) in blocks
    else:
        assert blocks == [(0, 0, int(indptr[-1]))]
    assert [b[1] for b in blocks[1:]] == [b[2] for b in blocks[:-1]]
    out, grad = run()
    assert torch.equal(out, whole[0]) and torch.equal(grad, whole[1])
    a, hit = _dense_max(p, indptr, indices)
    assert torch.equal(out, a)
    ties = hit.sum(1)
    assert (ties > 1).any()
    share = g / torch.clamp(ties, min=1)
    want = (hit * share[:, None, :]).sum(0)
    torch.testing.assert_close(grad, want, rtol=1e-12, atol=1e-12)


def test_adapter_counts_the_steps_work():
    cfg = _config()

    def mm(k, m):
        return 2 * N * k * m

    dense = (2 * (mm(100, 100) + mm(100, 256)) + 3 * mm(100, 256)
             + 3 * (mm(256, 256) + mm(256, 256)) + 3 * mm(256, 256)
             + 3 * (mm(256, 256) + mm(256, 47)) + 3 * mm(256, 47))
    assert pool_adapter.dense_flops(cfg, N) == dense
    assert pool_adapter.minmax_calls(cfg, N, NNZ) == [
        (N, NNZ, 100, "fwd"), (N, NNZ, 256, "fwd"), (N, NNZ, 256, "fwd"),
        (N, NNZ, 100, "bwd"), (N, NNZ, 256, "bwd"), (N, NNZ, 256, "bwd")]
    assert sorted(k for _, _, k in pool_adapter.spmm_calls(cfg, N, NNZ)) == \
        [100, 100, 256, 256, 256, 256]
    assert pool_adapter.SPMM_SITES == (("gespmm_tpu_torch.ops.graph",
                                        "spmm"),)
    # Not the other kinds' readers' names: their rooflines find nothing.
    assert not hasattr(pool_adapter, "dot_calls")
    assert not hasattr(pool_adapter, "attention_calls")


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_walk_bytes_and_operations_by_hand(direction):
    """A 5-node graph of 9 nonzeros, K = 6."""
    index = 6 * 4 + 9 * 4          # indptr (or colptr), indices (or rows)
    table = 5 * 6 * 4              # one (5, 6) f32 table
    if direction == "fwd":         # B in; out, ties out
        want = (index + 3 * table, 2 * 9 * 6)
    else:                          # B, out, g, ties in; grad_B out
        want = (index + 5 * table, 3 * 9 * 6)
    assert minmax_roofline.minmax_work(5, 9, 6, direction) == want
    with pytest.raises(ValueError, match="unknown walk"):
        minmax_roofline.minmax_work(5, 9, 6, "both")


def test_a_products_step_is_bound_by_bytes():
    calls = pool_adapter.minmax_calls(_config(), N, NNZ)
    for call in calls:
        _, term = minmax_roofline.bound(*minmax_roofline.minmax_work(*call))
        assert term == "bytes", call
    assert 0.014 < minmax_roofline.minmax_bound_s(calls) < 0.017


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _minmax_trace():
    """One step: a product under model/dense, the max op's walk and carry
    under op/spmm_minmax, and its backward node on thread 2, with the
    backward's walk under op/spmm_minmax.grad and a copy after it (linked
    to op/spmm_minmax by the node's sequence number)."""
    seq = {spans.FWD_THREAD: 0}
    node = {spans.FWD_THREAD: 1}
    ev = [
        _x("user_annotation", "step", 0, 200),
        _x("user_annotation", "model/dense", 2, 10),
        _x("cpu_op", "aten::mm", 3, 8, **{spans.SEQ: 10, **seq}),
        _x("cuda_runtime", "cudaLaunchKernel", 4, 1, correlation=1),
        _x("user_annotation", "op/spmm_minmax", 20, 20),
        _x("cpu_op", "_SpmmMinMax", 21, 18, **{spans.SEQ: 11, **seq}),
        _x("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 24, 1, correlation=3),
        _x("user_annotation", "step/bwd", 70, 100),
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "_SpmmMinMaxBackward", 100, 30, tid=2, **{spans.SEQ: 11, **node}),
        _x("user_annotation", "op/spmm_minmax.grad", 101, 20, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 105, 1, tid=2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 125, 1, tid=2, correlation=5),
        _x("kernel", "gemm", 5, 10, tid=7, correlation=1),
        _x("kernel", "spmm_minmax_kernel", 23, 30, tid=7, correlation=2),
        _x("kernel", "minmax_carry_kernel", 53, 2, tid=7, correlation=3),
        _x("kernel", "spmm_minmax_vjp_kernel", 106, 40, tid=7,
           correlation=4),
        _x("kernel", "copy", 146, 3, tid=7, correlation=5),
    ]
    return {"traceEvents": ev}


def test_minmax_readers_take_the_programs_spans(monkeypatch):
    names = ("step", "step/bwd", "model/dense", "op/spmm", "op/spmm.grad",
             "op/spmm_minmax", "op/spmm_minmax.grad")
    table = spans.table(_minmax_trace(), names)
    ms = table["device_ms"]
    assert ms["op/spmm_minmax"] == pytest.approx(35e-3)   # walk, carry, copy
    assert ms["op/spmm_minmax.grad"] == pytest.approx(40e-3)
    assert "op/spmm" not in ms and "op/spmm.grad" not in ms
    run = {"adapter": pool_adapter, "config": _config(), "n": N, "nnz": NNZ,
           "trace": {"steps": 1}}
    readers = {k: harness.metric_reader(k)
               for k in ("minmax_op_ms", "minmax_roofline", "spmm_op_ms")}
    monkeypatch.setattr(spans, "from_run", lambda r: table)
    assert readers["minmax_op_ms"](run) == pytest.approx(75e-3)
    bound = minmax_roofline.minmax_bound_s(pool_adapter.minmax_calls(
        _config(), N, NNZ))
    assert readers["minmax_roofline"](run) == pytest.approx(
        100.0 * bound / 75e-6)
    # The sum path's reader finds nothing of the max path.
    assert readers["spmm_op_ms"](run) is None
    # A program whose max runs under op/spmm (the parent of these spans),
    # or a run without a device trace: nothing to read, and no error.
    for t in ({"device_ms": {"op/spmm": 60.0, "model/dense": 30.0}}, None):
        monkeypatch.setattr(spans, "from_run", lambda r, t=t: t)
        assert readers["minmax_op_ms"](run) is None
        assert readers["minmax_roofline"](run) is None


def test_minmax_roofline_reads_nothing_for_another_kind(monkeypatch):
    from gnnbench.models import sage as mean_adapter

    monkeypatch.setattr(spans, "from_run", lambda r: {
        "device_ms": {"op/spmm_minmax": 10.0}})
    run = {"adapter": mean_adapter, "config": {}, "n": N, "nnz": NNZ,
           "trace": {"steps": 1}}
    assert harness.metric_reader("minmax_roofline")(run) is None


def test_reference_imports_only_torch_and_the_reference():
    path = REPO / "gnnbench" / "reference" / "sage_pool.py"
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
    code = ("import sys, gnnbench.reference.sage_pool, "
            "gnnbench.minmax_roofline; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gespmm_tpu', 'gespmm_tpu_torch')))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_config_and_limits_files_load_through_find_cell(tmp_path):
    """The cell as the harness finds it by name in a copy of the
    benchmark's files; its limits file names only compared numbers."""
    root = tiny_cells.make_root(tmp_path)
    cell = harness.find_cell(harness.load_bench(root), CELL, root)
    assert dataclasses.asdict(cell)["config"] == _config()
    assert harness.adapter(cell.config) is pool_adapter
    assert harness.reference(cell.config) is ref_pool
