"""``trace`` and the program's spans (``utils/profiling.py``).

``trace`` writes a trace file into its directory.  ``span`` is one shared
``nullcontext`` with the profiler and the host recorder off, a
``user_annotation`` under ``torch.profiler`` and a host-clock record inside
``recording()``; its names keep the rules a trace reader leans on.
``Adjacency.from_csr`` under its phase spans gives the arrays of the code
before the spans, bit for bit.
"""

import contextlib
import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gespmm_tpu_torch.kernels import _build
from gespmm_tpu_torch.models.gat import GAT
from gespmm_tpu_torch.models.gcn import GCN
from gespmm_tpu_torch.models.sage import GraphSAGE
from gespmm_tpu_torch.models.transformer import UniMP
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.sparse.formats import CSR
from gespmm_tpu_torch.sparse.partition import build_row_split
from gespmm_tpu_torch.train.loop import make_train_step
from gespmm_tpu_torch.utils import datasets as tds
from gespmm_tpu_torch.utils import native
from gespmm_tpu_torch.utils import profiling as tprof

STEP_CHILDREN = ("step/zero_grad", "step/forward", "step/loss", "step/bwd",
                 "step/optimizer")
# The spans one training step of each model opens.
STEP_SPANS = {
    "gcn": {"step", *STEP_CHILDREN, "model/dense", "model/norm",
            "model/relu", "model/dropout", "model/log_softmax", "op/spmm",
            "op/spmm.grad"},
    "sage": {"step", *STEP_CHILDREN, "model/dense", "model/relu",
             "model/dropout", "model/log_softmax", "op/spmm",
             "op/spmm.grad"},
    # The max aggregate runs under the max/min op's own spans, not the
    # sum's.
    "sage_pool": {"step", *STEP_CHILDREN, "model/dense", "model/relu",
                  "model/dropout", "model/log_softmax", "op/spmm_minmax",
                  "op/spmm_minmax.grad"},
    "gat": {"step", *STEP_CHILDREN, "model/dense", "model/attn_scores",
            "model/elu", "model/dropout", "model/log_softmax", "op/gat",
            "op/gat.grad"},
    "unimp": {"step", *STEP_CHILDREN, "model/dense", "model/dropout",
              "model/layer_norm", "model/gate", "model/relu",
              "model/log_softmax", "op/dot", "op/dot.grad"},
}
GRAPH_PREP = [n for n in tprof.SPANS
              if n.startswith("graph_prep/") and n != "graph_prep/degree_norm"]


def test_trace_writes_a_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.name for e in prof.events())


@pytest.mark.parametrize("name", tprof.SPANS)
def test_span_names_keep_the_readers_rules(name):
    """``<layer>/<what>`` or a layer alone; "spmm" only where SpMM work
    runs; never "backward", an ``aten::`` op or the ``gespmm`` prefix
    (a reader takes ``*spmm*backward*`` ranges for SpMM work)."""
    layer = name.split("/")[0]
    assert layer in ("step", "model", "op", "graph_prep", "kernel")
    assert name.count("/") <= 1 and name == name.strip()
    assert ("spmm" in name) == name.startswith("op/spmm")
    assert "backward" not in name.lower()
    assert not name.startswith(("aten::", "gespmm"))


def test_span_names_are_distinct():
    assert len(set(tprof.SPANS)) == len(tprof.SPANS)


@pytest.mark.parametrize("name", ["gespmm.step", "aten::mm", "spmm",
                                  "step/backward", "", "model/dense "])
def test_unknown_span_name_raises(name):
    with pytest.raises(ValueError, match="unknown span"):
        tprof.span(name)


def test_span_off_is_the_shared_null_context():
    first = tprof.span("step")
    assert first is tprof.span("op/spmm")
    assert isinstance(first, contextlib.nullcontext)
    with tprof.recording() as rec:
        pass
    with tprof.span("model/dense"):
        torch.ones(3) + 1
    assert rec.spans == []


def test_recording_records_nested_spans_on_the_host_clock():
    with tprof.recording() as rec:
        with tprof.span("step"):
            with tprof.span("step/forward"):
                pass
    assert [s[0] for s in rec.spans] == ["step/forward", "step"]
    (_, s0, e0, t0), (_, s1, e1, t1) = rec.spans
    assert s1 <= s0 <= e0 <= e1 and t0 == t1
    assert set(rec.seconds()) == {"step", "step/forward"}
    assert tprof.span("step") is tprof.span("model/relu")  # off again


def _problem(kind):
    ds = tds.sbm_graph(n_per_class=20, num_classes=3, p_in=0.2, p_out=0.02,
                       feat_dim=8, seed=0)
    adj = Adjacency.from_csr(ds.csr)
    gen = torch.Generator().manual_seed(0)
    if kind == "gcn":
        model = GCN([8, 16, 3], dropout_rate=0.5, generator=gen).with_norms(
            adj)
    elif kind == "gat":
        model = GAT([8, 4, 3], dropout_rate=0.5, heads=2, skip=True,
                    generator=gen)
    elif kind == "unimp":
        model = UniMP([8, 4, 3], heads=2, attn_dropout=0.3, generator=gen)
    else:
        model = GraphSAGE([8, 16, 3], aggregator="pool" if kind == "sage_pool"
                          else "mean", dropout_rate=0.5, generator=gen)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, opt, adj, torch.as_tensor(ds.features),
                           torch.as_tensor(ds.labels),
                           torch.as_tensor(ds.masks["train"]),
                           generator=torch.Generator().manual_seed(1))
    return step, model


@pytest.mark.parametrize("kind", ["gcn", "sage", "sage_pool", "gat", "unimp"])
def test_a_step_shows_every_span_under_the_profiler(kind):
    step, _ = _problem(kind)
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    got = {e.name for e in prof.events()
           if e.name in tprof.SPANS}
    assert got == STEP_SPANS[kind]
    # Off again after the profiler.
    assert isinstance(tprof.span("step"), contextlib.nullcontext)


@pytest.mark.parametrize("kind", ["gcn", "sage", "sage_pool", "gat", "unimp"])
def test_step_holds_its_five_children_in_order(kind):
    step, _ = _problem(kind)
    with tprof.recording() as rec:
        step()
    spans = {}
    for name, start, end, _ in rec.spans:
        spans.setdefault(name, []).append((start, end))
    assert set(spans) == STEP_SPANS[kind]
    (s0, e0), = spans["step"]
    children = [spans[n] for n in STEP_CHILDREN]
    assert all(len(c) == 1 for c in children)
    bounds = [c[0] for c in children]
    assert s0 <= bounds[0][0]
    for (_, end), (start, _) in zip(bounds, bounds[1:]):
        assert end <= start
    assert bounds[-1][1] <= e0


def _parent_from_csr(csr, use_native):
    """The host arrays of ``Adjacency.from_csr`` as computed before its
    phases had spans (plan=False)."""
    indptr_h = csr.indptr.cpu().numpy()
    indices_h = csr.indices.cpu().numpy()
    m, n = csr.shape
    nnz = int(indices_h.shape[0])
    rows_h = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr_h))
    if native.wanted(use_native):
        colptr_h, csc_rows_h, perm_h = native.csr_to_csc_native(
            indptr_h, indices_h, m, n)
        colptr_h = colptr_h.astype(np.int64)
    else:
        order = np.argsort(indices_h, kind="stable")
        colptr_h = np.zeros(n + 1, np.int64)
        colptr_h[1:] = np.cumsum(np.bincount(indices_h, minlength=n))
        perm_h = order.astype(np.int32)
        csc_rows_h = rows_h[order]
    inv_perm_h = np.empty_like(perm_h)
    inv_perm_h[perm_h] = np.arange(nnz, dtype=np.int32)
    t = torch.from_numpy
    return {
        "csr.indptr": csr.indptr, "csr.indices": csr.indices,
        "csc.indptr": t(colptr_h.astype(np.int32)),
        "csc.indices": t(np.ascontiguousarray(csc_rows_h)),
        "perm": t(perm_h), "rows": t(rows_h),
        "rows_t": t(np.repeat(np.arange(n, dtype=np.int32),
                              np.diff(colptr_h))),
        "inv_perm": t(inv_perm_h),
        "split": build_row_split(indptr_h),
        "split_t": build_row_split(colptr_h),
    }


def _same(a, b):
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("use_native", [False, None])
def test_from_csr_phases_are_recorded_and_arrays_unchanged(use_native):
    """A graph with rows and columns above the split's L (a hub of 300
    edges): every phase once (``rows`` twice: the CSR's and the CSC's row
    ids), each inside the call, and every array as before."""
    csr = tds.split_boundary_graph(16, hub=300, n=600)
    with tprof.recording() as rec:
        adj = Adjacency.from_csr(csr, use_native=use_native)
    names = [s[0] for s in rec.spans]
    assert sorted(set(names)) == sorted(["graph_prep", *GRAPH_PREP])
    assert names[-1] == "graph_prep" and names.count("graph_prep") == 1
    assert names.count("graph_prep/rows") == 2
    assert all(names.count(n) == 1 for n in GRAPH_PREP
               if n != "graph_prep/rows")
    (_, start, end, _), = [s for s in rec.spans if s[0] == "graph_prep"]
    assert all(start <= s <= e <= end for _, s, e, _ in rec.spans)
    want = _parent_from_csr(csr, use_native)
    assert want["split"].num_segments > 0 and want["split_t"].num_segments > 0
    got = {"csr.indptr": adj.csr.indptr, "csr.indices": adj.csr.indices,
           "csc.indptr": adj.csc.indptr, "csc.indices": adj.csc.indices,
           "perm": adj.perm, "rows": adj.rows, "rows_t": adj.rows_t,
           "inv_perm": adj.inv_perm, "split": adj.split,
           "split_t": adj.split_t}
    for key, value in want.items():
        assert _same(got[key], value), key
    assert adj.plan is None and adj.plan_t is None


def test_plans_phase_builds_the_plans():
    csr = tds.split_boundary_graph(16, hub=300, n=600)
    with tprof.recording() as rec:
        adj = Adjacency.from_csr(csr, plan="perrow")
    assert adj.plan is not None and adj.plan_t is not None
    (_, s, e, _), = [x for x in rec.spans if x[0] == "graph_prep/plans"]
    assert e > s


def test_degree_norm_span_in_with_norms():
    csr = CSR(torch.tensor([0, 1, 2], dtype=torch.int32),
              torch.tensor([1, 0], dtype=torch.int32), None, (2, 2))
    with tprof.recording() as rec:
        GCN([4, 2]).with_norms(Adjacency.from_csr(csr))
    assert [s[0] for s in rec.spans].count("graph_prep/degree_norm") == 1


@pytest.mark.parametrize("ok", [True, False])
def test_kernel_build_span_around_the_compiler(tmp_path, ok):
    """``compile_library`` runs the compiler under ``kernel/build``, also
    when the compiler fails.  The compiler here is Python writing its
    ``-o`` file (argv: ``-c``, ``-o``, path)."""
    code = ("import sys; open(sys.argv[2], 'w').write('x')" if ok
            else "import sys; sys.exit(3)")
    lib = tmp_path / "libfake.so"
    with tprof.recording() as rec:
        if ok:
            _build.compile_library([sys.executable, "-c", code], lib)
        else:
            with pytest.raises(RuntimeError, match="exit code 3"):
                _build.compile_library([sys.executable, "-c", code], lib)
    assert [s[0] for s in rec.spans] == ["kernel/build"]
    assert lib.exists() == ok


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat", "unimp"])
def test_step_frees_log_probs_during_the_backward(kind):
    """The spanned step holds no name on the log-probabilities through the
    backward: they are freed once their node has run, before the first
    layer's weight gradient (a held n x classes tensor raises the step's
    peak memory)."""
    import weakref

    step, model = _problem(kind)
    refs, alive = [], []
    plain = model.log_probs

    def log_probs(*args, **kw):
        out = plain(*args, **kw)
        refs.append(weakref.ref(out))
        return out

    model.log_probs = log_probs
    layer = model.layer_0
    weight = (layer.neigh.w if kind == "sage" else
              layer.query.w if kind == "unimp" else layer.w)
    weight.register_hook(lambda g: alive.append(refs[-1]() is not None))
    step()
    assert alive == [False]


@pytest.mark.parametrize("reduce,op", [("sum", "op/spmm"), ("mean", "op/spmm"),
                                       ("max", "op/spmm_minmax"),
                                       ("min", "op/spmm_minmax")])
def test_each_reduction_runs_under_its_ops_spans(reduce, op):
    """A sum or mean SpMM and its backward run under ``op/spmm`` and
    ``op/spmm.grad``; a max or min under ``op/spmm_minmax`` and
    ``op/spmm_minmax.grad``, so that a trace tells the two ops apart."""
    ds = tds.sbm_graph(n_per_class=20, num_classes=3, p_in=0.2, p_out=0.02,
                       feat_dim=8, seed=0)
    adj = Adjacency.from_csr(ds.csr)
    B = torch.randn(adj.shape[1], 8, requires_grad=True)
    with tprof.recording() as rec:
        out = spmm(adj, B, reduce=reduce)
        out.sum().backward()
    assert [name for name, *_ in rec.spans] == [op, f"{op}.grad"]
    assert B.grad is not None
