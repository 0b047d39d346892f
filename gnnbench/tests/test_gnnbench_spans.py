"""The program's spans in a trace (``gnnbench/spans.py``): a hand-made
trace with a backward on a second thread linked by sequence number, and a
real CPU trace of the program's steps, with a device operation planted
under every leaf op, which also shows that the program's spans leave
``traceparse``'s layers as they are."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnnbench import spans, traceparse

NAMES = ("step", "step/forward", "step/bwd", "model/dense", "op/spmm",
         "op/spmm.grad", "model/dropout")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _fwd(name, ts, dur, seq):
    return _x("cpu_op", name, ts, dur,
              **{spans.SEQ: seq, spans.FWD_THREAD: 0})


def _node(name, ts, dur, seq, tid=2):
    return _x("cpu_op", name, ts, dur, tid=tid,
              **{spans.SEQ: seq, spans.FWD_THREAD: 1})


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid,
              correlation=corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, tid=7, correlation=corr)


def _trace():
    ev = [
        _x("user_annotation", "step", 0, 200),
        # The previous step's detach makes no node: it carries the number
        # of the next node made, the product's (seq 10).
        _fwd("aten::detach", 0.5, 0.2, 10),
        _x("user_annotation", "step/forward", 1, 60),
        # model/dense: a product (seq 10), its kernel.
        _x("user_annotation", "model/dense", 2, 10),
        _fwd("aten::matmul", 2.5, 9, 10), _fwd("aten::mm", 3, 8, 10),
        _launch(4, 1),
        # op/spmm: the custom Function's op (seq 11) and its kernel.
        _x("user_annotation", "op/spmm", 20, 10),
        _fwd("_SpmmSum", 21, 8, 11), _launch(22, 2),
        # An op under step/forward alone (seq 12).
        _fwd("aten::add", 40, 4, 12), _launch(41, 3),
        # model/dropout, seq 13.
        _x("user_annotation", "model/dropout", 50, 8),
        _fwd("aten::where", 51, 6, 13), _launch(52, 4),
        # The backward on thread 2 inside step/bwd of thread 1.
        _x("user_annotation", "step/bwd", 70, 100),
        _launch(71, 5),  # the seed gradient, under step/bwd
        _node("autograd::engine::evaluate_function: WhereBackward0", 80, 10,
              13),
        _launch(82, 6, tid=2),
        _node("autograd::engine::evaluate_function: _SpmmSumBackward", 100,
              30, 11),
        _x("user_annotation", "op/spmm.grad", 101, 20, tid=2),
        _launch(105, 7, tid=2),
        _launch(125, 8, tid=2),  # after op/spmm.grad: linked to op/spmm
        _node("autograd::engine::evaluate_function: MmBackward0", 140, 10,
              10),
        _launch(142, 9, tid=2),
        # A node whose forward is under no program span, and one with none.
        _node("autograd::engine::evaluate_function: X", 155, 5, 99),
        _launch(156, 10, tid=2),
        # A foreign annotation is no program span.
        _x("user_annotation", "gnnbench.spmm", 300, 20),
        _launch(301, 11),
        # Device operations.
        _kernel("gemm", 5, 10, 1),
        _kernel("walker", 23, 20, 2),
        _kernel("add", 43, 2, 3),
        _kernel("where", 53, 4, 4),
        _kernel("fill", 72, 1, 5),
        _kernel("where_bwd", 83, 4, 6),
        _kernel("walker", 106, 20, 7),
        _kernel("copy", 126, 2, 8),
        _kernel("gemm", 143, 10, 9),
        _kernel("mystery", 157, 3, 10),
        _kernel("outside", 302, 5, 11),
    ]
    return {"traceEvents": ev + [{"ph": "M", "name": "process_name"}]}


def test_spans_forward_and_linked_backward():
    t = spans.table(_trace(), NAMES)
    assert t["steps"] == 1 and t["device_ops"] == 11
    ms = t["device_ms"]
    assert ms["model/dense"] == pytest.approx(20e-3)   # gemm + its backward
    assert ms["op/spmm"] == pytest.approx(22e-3)       # walker + the copy
    assert ms["op/spmm.grad"] == pytest.approx(20e-3)  # inside the node
    assert ms["model/dropout"] == pytest.approx(8e-3)  # where + backward
    assert ms["step/forward"] == pytest.approx(2e-3)
    assert ms["step/bwd"] == pytest.approx(1e-3)
    assert ms[spans.UNATTRIBUTED] == pytest.approx(8e-3)  # mystery, outside
    assert t["bwd_ms"] == pytest.approx({"model/dense": 10e-3,
                                         "op/spmm": 2e-3,
                                         "model/dropout": 4e-3})
    assert sum(ms.values()) == pytest.approx(81e-3)
    assert t["step_host_ms"] == [0.2]


def test_idle_gaps_by_the_step_threads_spans():
    t = spans.table(_trace(), NAMES)
    # Busy: [5, 15], [23, 45], [53, 57], [72, 73], [83, 87], [106, 128],
    # [143, 153], [157, 160], [302, 307].
    assert t["busy_s"] == pytest.approx(81e-6)
    idle = t["idle_ms"]
    assert idle["step/forward"] == pytest.approx(16e-3)  # 15-23, 45-53
    assert idle["step"] == pytest.approx(15e-3)          # 57-72
    assert idle["step/bwd"] == pytest.approx(48e-3)      # 73-83 ... 153-157
    assert idle[spans.BETWEEN_STEPS] == pytest.approx(142e-3)  # 160-302
    assert sum(idle.values()) == pytest.approx((307 - 5 - 81) * 1e-3)
    # By the operation after each gap: walker (op/spmm), where
    # (model/dropout), fill (step/bwd), where_bwd (model/dropout), walker
    # (op/spmm.grad), gemm (model/dense), mystery and outside.
    assert t["idle_before_ms"] == pytest.approx({
        "op/spmm": 8e-3, "model/dropout": 18e-3, "step/bwd": 15e-3,
        "op/spmm.grad": 19e-3, "model/dense": 15e-3,
        spans.UNATTRIBUTED: 146e-3})


def test_no_program_span_reads_nothing():
    trace = _trace()
    assert spans.table(trace, names=()) is None
    no_device = {"traceEvents": [e for e in trace["traceEvents"]
                                 if e.get("cat") != "kernel"]}
    assert spans.table(no_device, NAMES) is None


def test_from_run_without_a_device_trace_reads_nothing():
    assert spans.from_run({"trace": None}) is None


def _with_device_ops(trace):
    """Plant a kernel under every leaf CPU op of ``trace`` (an op with no
    op inside it on its thread), launched from inside it."""
    events = trace["traceEvents"]
    ops = [e for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    by_thread = {}
    for e in ops:
        by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
    added, corr, ts = [], 10**6, 0.0
    for thread_ops in by_thread.values():
        thread_ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        for i, e in enumerate(thread_ops):
            nxt = thread_ops[i + 1] if i + 1 < len(thread_ops) else None
            if nxt is not None and nxt["ts"] < e["ts"] + e["dur"]:
                continue  # not a leaf
            corr += 1
            added.append({"ph": "X", "cat": "cuda_runtime",
                          "name": "cudaLaunchKernel", "pid": e["pid"],
                          "tid": e["tid"], "ts": e["ts"] + e["dur"] / 2,
                          "dur": 0, "args": {"correlation": corr}})
            ts = max(ts, e["ts"] + e["dur"])
            added.append({"ph": "X", "cat": "kernel", "name": e["name"],
                          "pid": 0, "tid": 7, "ts": ts, "dur": 1.0,
                          "args": {"correlation": corr}})
            ts += 2.0
    return {"traceEvents": events + added}


@pytest.fixture(scope="module")
def gcn_trace(tmp_path_factory):
    """A real CPU trace of two steps of the program's GCN, kernels
    planted."""
    from gespmm_tpu_torch.models.gcn import GCN
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.train.loop import make_train_step
    from gespmm_tpu_torch.utils import datasets

    ds = datasets.sbm_graph(n_per_class=20, num_classes=3, p_in=0.2,
                            p_out=0.02, feat_dim=8, seed=0)
    adj = Adjacency.from_csr(ds.csr)
    model = GCN([8, 16, 3], generator=torch.Generator().manual_seed(0)
                ).with_norms(adj)
    step = make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-2), adj,
        torch.as_tensor(ds.features), torch.as_tensor(ds.labels),
        torch.as_tensor(ds.masks["train"]),
        generator=torch.Generator().manual_seed(1))
    step()
    path = tmp_path_factory.mktemp("trace") / "gcn.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        step()
    prof.export_chrome_trace(str(path))
    return _with_device_ops(json.loads(path.read_text()))


def test_program_spans_leave_traceparse_layers_as_they_are(gcn_trace):
    names = set(spans.program_spans())
    bare = {"traceEvents": [e for e in gcn_trace["traceEvents"]
                            if not (e.get("cat") == "user_annotation"
                                    and e.get("name") in names)]}
    assert len(bare["traceEvents"]) < len(gcn_trace["traceEvents"])
    with_spans = traceparse.analyze(gcn_trace, 2)
    without = traceparse.analyze(bare, 2)
    assert with_spans["device_ops"] == without["device_ops"] > 0
    assert with_spans["layer_s"] == without["layer_s"]
    assert with_spans["layer_s"]["dense"] > 0


def test_real_trace_attributes_every_planted_operation(gcn_trace):
    t = spans.table(gcn_trace)
    assert t["steps"] == 2 and len(t["step_host_ms"]) == 2
    ms = t["device_ms"]
    for name in ("model/dense", "model/norm", "model/relu", "model/dropout",
                 "model/log_softmax", "op/spmm", "op/spmm.grad", "step/loss",
                 "step/optimizer"):
        assert ms.get(name, 0) > 0, name
    # On the CPU the backward runs inside step/bwd on the step's thread;
    # ops of nodes linked to a forward span count there, not under step/bwd.
    assert t["bwd_ms"]["model/dense"] > 0
    assert t["bwd_ms"]["model/dropout"] > 0
    assert sum(ms.values()) == pytest.approx(t["device_ops"] * 1e-3 / 2)
    assert ms.get(spans.UNATTRIBUTED, 0) == 0


def test_setup_spans_of_a_tiny_cell(tmp_path):
    """The set-up recording on the CPU: every phase of ``from_csr`` inside
    the harness's own ``graph_build_s``, the degree norms, and the steps."""
    from gnnbench.tests import tiny_cells

    root = tiny_cells.make_root(tmp_path)
    got = spans.setup_spans(tiny_cells.cell_name("gcn-ogbn-products"), 5,
                            device="cpu", root=root)
    phases = got["setup_spans"]
    for name in ("graph_prep", "graph_prep/d2h", "graph_prep/rows",
                 "graph_prep/csc", "graph_prep/inv_perm", "graph_prep/plans",
                 "graph_prep/split", "graph_prep/h2d",
                 "graph_prep/degree_norm", "step", "op/spmm"):
        assert name in phases, name
    assert phases["graph_prep"]["count"] == 1
    assert phases["graph_prep/rows"]["count"] == 2
    assert phases["step"]["count"] == 2
    assert phases["graph_prep"]["s"] <= got["graph_build_s"]
    inner = sum(v["s"] for k, v in phases.items()
                if k.startswith("graph_prep/") and k != "graph_prep/degree_norm")
    assert inner <= phases["graph_prep"]["s"]
