"""Port parity: the stock baselines (``models/baselines.py``) and the benches' ``--impl bcoo|stock``.

A small SBM graph (3 x 20 nodes, 16 features), with self-loops for the GCN
and the GAT, without for SAGE (binary, as the SAGE bench loads it), dims
[16, 8, 3].  Each port baseline, loaded with ``params_from_jax`` of the JAX
baseline's init, is held to the JAX baseline (forward within
1e-5·max|ref| + 1e-6, parameter gradients of sum(logits * G) within
1e-4·max(|ref|, 1)), and to the port's own model at the same parameters
(the JAX package's same-parameter checks).  SAGE-pool's features come from a
palette of three rows in multiples of 0.5, so that neighbours tie in the
row max and its gradient is split among them.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gespmm_tpu.models import baselines as jbase
from gespmm_tpu.ops import graph as jgraph
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.utils import datasets as jds

from gespmm_tpu_torch.bench import gat_bench, gcn_bench, sage_bench
from gespmm_tpu_torch.models import baselines as tbase
from gespmm_tpu_torch.models.common import params_from_jax
from gespmm_tpu_torch.models.gat import GAT
from gespmm_tpu_torch.models.gcn import GCN
from gespmm_tpu_torch.models.sage import GraphSAGE
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.utils import datasets as tds

DIMS = [16, 8, 3]
SBM = dict(n_per_class=20, num_classes=3, p_in=0.15, p_out=0.02, feat_dim=16,
           seed=0)


@pytest.fixture(scope="module")
def graphs():
    jd, td = jds.sbm_graph(**SBM), tds.sbm_graph(**SBM)
    rng = np.random.default_rng(11)
    palette = np.round(rng.standard_normal((3, 16)) * 2) / 2
    x = palette[rng.integers(0, 3, 60)].astype(np.float32)
    return {
        "loops": (JAdjacency.from_csr(jgraph.add_self_loops(jd.csr)),
                  TAdjacency.from_csr(tgraph.add_self_loops(td.csr))),
        "plain": (JAdjacency.from_csr(jd.csr), TAdjacency.from_csr(td.csr)),
        "x": x,
    }


CASES = {
    # name: (JAX model, port model, graph, port operand, JAX operand)
    "gcn": (lambda: jbase.GCNBcoo(DIMS, dropout_rate=0.0),
            lambda: tbase.GCNBcoo(DIMS, dropout_rate=0.0), "loops",
            lambda a: tbase.GCNBcoo.from_adjacency(a),
            lambda a: jbase.GCNBcoo.from_adjacency(a)),
    "gat": (lambda: jbase.GATStock(DIMS, dropout_rate=0.0),
            lambda: tbase.GATStock(DIMS, dropout_rate=0.0), "loops",
            lambda a: tbase.GATStock.from_adjacency(a),
            lambda a: jbase.GATStock.from_adjacency(a)),
    **{f"sage-{agg}": (
        lambda agg=agg: jbase.SAGEStock(DIMS, agg, dropout_rate=0.0),
        lambda agg=agg: tbase.SAGEStock(DIMS, agg, dropout_rate=0.0), "plain",
        lambda a, agg=agg: tbase.SAGEStock.from_adjacency(a, agg),
        lambda a, agg=agg: jbase.SAGEStock.from_adjacency(a, agg))
       for agg in ("mean", "sum", "pool")},
}


def close_fwd(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


def close_grad(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_baseline_matches_jax_forward_and_gradients(graphs, name):
    jmake, tmake, graph, toperand, joperand = CASES[name]
    jadj, tadj = graphs[graph]
    x = graphs["x"]
    jmodel = jmake()
    params = jmodel.init(jax.random.PRNGKey(7))
    G = np.random.default_rng(8).standard_normal((60, 3)).astype(np.float32)
    jop = joperand(jadj)

    def jloss(p):
        return jnp.sum(jmodel.apply(p, jop, jnp.asarray(x)) * G)

    jout = jmodel.apply(params, jop, jnp.asarray(x))
    jgrads = params_from_jax(jax.grad(jloss)(params))
    model = tmake()
    model.load_state_dict(params_from_jax(params))
    out = model(toperand(tadj), torch.from_numpy(x))
    close_fwd(out.detach(), jout)
    (out * torch.from_numpy(G)).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for k, want in jgrads.items():
        close_grad(grads[k], want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_baseline_is_ours_at_the_same_parameters(graphs, name):
    _, tmake, graph, toperand, _ = CASES[name]
    _, tadj = graphs[graph]
    x = torch.from_numpy(graphs["x"])
    if name == "gcn":
        ours = [GCN(DIMS, dropout_rate=0.0)]
    elif name == "gat":
        ours = [GAT(DIMS, dropout_rate=0.0, method=m) for m in ("auto", "xla")]
    else:
        agg = name.split("-")[1]
        ours = [GraphSAGE(DIMS, aggregator=agg, dropout_rate=0.0, method=m)
                for m in ("auto", "xla")]
    stock = tmake()
    # A baseline draws its parameters as the ported model does: the same
    # generator seed gives the same parameters.
    twin = type(ours[0])(DIMS, **({"aggregator": name.split("-")[1]}
                                  if name.startswith("sage") else {}),
                         generator=torch.Generator().manual_seed(3))
    again = type(stock)(DIMS, **({"aggregator": name.split("-")[1]}
                                 if name.startswith("sage") else {}),
                        generator=torch.Generator().manual_seed(3))
    for k, v in again.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
    for model in ours:
        model.load_state_dict(stock.state_dict())
        want = model.eval()(tadj, x)
        got = stock.eval()(toperand(tadj), x)
        close_fwd(got.detach(), want.detach())


def test_gat_stock_keeps_rows_without_edges_at_zero():
    # A row without an edge: its max is the initial 0, its aggregate 0.
    indptr = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    csr = tds.CSR(indptr, torch.tensor([0, 2, 1], dtype=torch.int32), None,
                  (3, 3))
    adj = TAdjacency.from_csr(csr)
    model = tbase.GATStock([4, 2], dropout_rate=0.0,
                           generator=torch.Generator().manual_seed(0))
    out = model(tbase.GATStock.from_adjacency(adj), torch.randn(3, 4))
    assert torch.isfinite(out).all()
    assert torch.equal(out[1], model.layer_0.b.detach())


def test_sage_stock_refuses_other_aggregators():
    with pytest.raises(ValueError, match="SAGEStock supports"):
        tbase.SAGEStock(DIMS, "gcn")


@pytest.mark.parametrize("bench,argv,impl", [
    (gcn_bench, ["--impl", "bcoo"], "bcoo"),
    (gat_bench, ["--impl", "stock"], "stock"),
    (sage_bench, ["--impl", "stock", "--aggregator-type", "pool"], "stock"),
])
def test_bench_impl_prints_one_json_line(capsys, bench, argv, impl):
    bench.main(argv + ["--dataset", "sbm", "--n-epochs", "5", "--device",
                       "cpu", "--log-every", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["impl"] == impl and rec["device"] == "cpu"
    assert rec["mean_epoch_time_ms"] > 0 and 0.0 <= rec["test_acc"] <= 1.0


def test_sage_bench_stock_refuses_gcn():
    with pytest.raises(SystemExit):
        sage_bench.main(["--impl", "stock", "--aggregator-type", "gcn",
                         "--dataset", "sbm", "--device", "cpu"])
