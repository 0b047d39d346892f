"""Port parity: GraphSAGE (mean, gcn, pool, sum), its training steps and its bench, against the JAX package.

A small SBM graph (3 x 50 nodes, 16 features) without self-loops, as the
JAX SAGE bench uses its graph, and dims [16, 8, 3].  ``jax.random`` and
``torch.Generator`` draw different numbers, so the JAX parameters go across
through ``params_from_jax`` and dropout is off.  Tolerances, as in
``test_torch_gcn.py``: forward rtol 1e-5 (f32, summation order differs);
five AdamW steps: losses rtol 1e-5, parameters atol 1e-4.  ``pool`` runs
the max-SpMM forward and backward (the kernels' plain versions here).

The five steps are held to the JAX package's step run in float64.  Its f32
step is itself 1.2e-5 (sum) and 7e-6 (pool) away from that float64 run on
this problem: optax rounds its f32 bias correction (the first update is
0.00999993 for lr 0.01), and gradients near 18 carry that into the loss.
The port's f32 step stays within 3e-7 of it.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gespmm_tpu.models.sage import GraphSAGE as JSAGE
from gespmm_tpu.ops import graph as jgraph
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.train import loop as jloop
from gespmm_tpu.utils import datasets as jds

from gespmm_tpu_torch.bench import sage_bench
from gespmm_tpu_torch.models.common import params_from_jax
from gespmm_tpu_torch.models.gcn import params_from_jax as gcn_params_from_jax
from gespmm_tpu_torch.models.sage import GraphSAGE as TSAGE
from gespmm_tpu_torch.models.sage import SAGEConv
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.train import loop as tloop
from gespmm_tpu_torch.utils import datasets as tds

DIMS = [16, 8, 3]
SBM = dict(n_per_class=50, num_classes=3, p_in=0.08, p_out=0.01, feat_dim=16,
           seed=0)
AGGREGATORS = ["mean", "gcn", "pool", "sum"]


@pytest.fixture(scope="module")
def problem():
    jd, td = jds.sbm_graph(**SBM), tds.sbm_graph(**SBM)
    return jd, td, JAdjacency.from_csr(jd.csr), TAdjacency.from_csr(td.csr)


def jax_params(aggregator):
    return JSAGE(DIMS, aggregator=aggregator).init(jax.random.PRNGKey(0))


def torch_model(params, aggregator, method="auto"):
    model = TSAGE(DIMS, aggregator=aggregator, dropout_rate=0.0, method=method)
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("method", ["auto", "xla"])
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_forward_matches_jax(problem, aggregator, method):
    jd, td, jadj, tadj = problem
    params = jax_params(aggregator)
    jmodel = JSAGE(DIMS, aggregator=aggregator, dropout_rate=0.0)
    model = torch_model(params, aggregator, method).eval()
    np.testing.assert_allclose(
        model(tadj, td.features).detach().numpy(),
        np.asarray(jmodel.apply(params, jadj, jd.features)), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        model.log_probs(tadj, td.features).detach().numpy(),
        np.asarray(jmodel.log_probs(params, jadj, jd.features)), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_parameter_names_and_shapes(aggregator):
    params = jax_params(aggregator)
    flat = params_from_jax(params)
    sd = TSAGE(DIMS, aggregator=aggregator).state_dict()
    assert sorted(sd) == sorted(flat)
    for k, v in flat.items():
        assert sd[k].shape == v.shape
    names = {k.split(".", 1)[1] for k in sd}
    want = {"mean": {"self.w", "neigh.w", "neigh.b"},
            "gcn": {"neigh.w", "neigh.b"},
            "pool": {"self.w", "neigh.w", "neigh.b", "pool.w", "pool.b"},
            "sum": {"self.w", "neigh.w", "neigh.b"}}[aggregator]
    assert names == want


def test_params_from_jax_flattens_nested_dicts_and_keeps_gcn_names():
    params = {"layer_0": {"w": np.ones((2, 3)), "b": np.zeros(3)},
              "layer_1": {"pool": {"w": np.ones((2, 2))}}}
    flat = params_from_jax(params)
    assert sorted(flat) == ["layer_0.b", "layer_0.w", "layer_1.pool.w"]
    assert all(v.dtype == torch.float32 for v in flat.values())
    assert gcn_params_from_jax is params_from_jax


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_five_adamw_steps_match_optax(problem, aggregator):
    jd, td, jadj, tadj = problem
    params = jax_params(aggregator)
    lr, wd = 1e-2, 5e-4
    jmodel = JSAGE(DIMS, aggregator=aggregator, dropout_rate=0.0)
    opt = optax.adamw(lr, weight_decay=wd)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        x64 = jnp.asarray(jd.features, jnp.float64)
        state = jloop.TrainState(p64, opt.init(p64), jnp.zeros((), jnp.int32))
        jstep = jloop.make_train_step(jmodel, opt)
        jlosses = []
        for _ in range(5):
            state, loss = jstep(state, jadj, x64, jd.labels, jd.masks["train"],
                                jax.random.PRNGKey(1))
            jlosses.append(float(loss))
        final = jax.device_get(state.params)

    model = torch_model(params, aggregator)
    tstep = tloop.make_train_step(
        model, torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=wd),
        tadj, td.features, td.labels, td.masks["train"])
    tlosses = [tstep().item() for _ in range(5)]

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    sd = model.state_dict()
    for k, v in params_from_jax(final).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_aggregate_matches_jax(problem, aggregator):
    jd, td, jadj, tadj = problem
    x = np.maximum(np.random.default_rng(9).standard_normal((150, 16)), 0)
    x = x.astype(np.float32)
    ref = jgraph.sage_aggregate(jadj, jnp.asarray(x), aggregator=aggregator)
    out = tgraph.sage_aggregate(tadj, torch.from_numpy(x), aggregator=aggregator)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="aggregator"):
        tgraph.sage_aggregate(tadj, torch.from_numpy(x), aggregator="median")


def test_lstm_and_unknown_aggregators_raise(problem):
    # "lstm" is ported: without a neighbour table it raises JAX's ValueError.
    _, td, _, tadj = problem
    with pytest.raises(ValueError, match="neighbor_table"):
        TSAGE(DIMS, aggregator="lstm")(tadj, td.features)
    with pytest.raises(ValueError, match="neighbor_table"):
        SAGEConv(16, 8, aggregator="lstm")(tadj, td.features)
    with pytest.raises(ValueError, match="aggregator"):
        TSAGE(DIMS, aggregator="median")


def test_dropout_runs_before_the_input_layer(problem):
    # One layer: the GCN's placement (between layers) would drop nothing.
    _, td, _, tadj = problem
    model = TSAGE([16, 3], aggregator="pool", dropout_rate=1.0,
                  generator=torch.Generator().manual_seed(0)).train()
    out = model(tadj, td.features, generator=torch.Generator().manual_seed(1))
    want = model.layer_0(tadj, torch.zeros_like(td.features))
    assert torch.equal(out, want)
    model.eval()
    assert not torch.equal(model(tadj, td.features), want)


def test_sage_pool_learns(problem):
    _, td, _, tadj = problem
    model = TSAGE(DIMS, aggregator="pool", dropout_rate=0.5,
                  generator=torch.Generator().manual_seed(0))
    res = tloop.train_node_classifier(model, tadj, td.features, td.labels,
                                      td.masks, epochs=30, seed=0)
    loss = res["history"]["loss"]
    assert loss[-1] < loss[0] and np.all(np.isfinite(loss))
    assert res["train_acc"] > 1 / 3 + 0.2


def test_sage_bench_cli_prints_json_line(capsys):
    sage_bench.main(["--dataset", "sbm", "--n-epochs", "5", "--device", "cpu",
                     "--aggregator-type", "pool", "--log-every", "0"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_keys = {"dataset", "aggregator", "impl", "dims", "mean_epoch_time_ms",
                "etputs_kteps", "train_acc", "val_acc", "test_acc"}
    assert jax_keys <= set(rec)
    assert rec["dims"] == [64, 16, 4] and rec["aggregator"] == "pool"
    assert rec["impl"] == "ours" and rec["device"] == "cpu"
    assert rec["mean_epoch_time_ms"] > 0 and rec["etputs_kteps"] > 0
    assert 0.0 <= rec["test_acc"] <= 1.0


def test_sage_modules_do_not_pull_in_jax():
    code = ("import sys, gespmm_tpu_torch.models.sage, "
            "gespmm_tpu_torch.bench.sage_bench, "
            "gespmm_tpu_torch.kernels.spmm_minmax; "
            "print('jax' in sys.modules, 'gespmm_tpu' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root).stdout.split()
    assert out == ["False", "False"]
