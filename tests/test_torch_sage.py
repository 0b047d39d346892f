"""Port parity: GraphSAGE (mean, gcn, pool, sum), its training steps and its bench, against the JAX package.

A small SBM graph (3 x 50 nodes, 16 features) without self-loops, as the
JAX SAGE bench uses its graph, and dims [16, 8, 3].  ``jax.random`` and
``torch.Generator`` draw different numbers, so the JAX parameters go across
through ``params_from_jax`` and dropout is off.  Tolerances, as in
``test_torch_gcn.py``: forward rtol 1e-5 (f32, summation order differs);
five AdamW steps: losses rtol 1e-5, parameters atol 1e-4.  ``pool`` runs
the max-SpMM forward and backward (the kernels' plain versions here).

The forward and the five steps are held to the JAX package run in float64,
the forward also to its float32 run but for ``sum``.  The JAX package's f32
step is itself 1.2e-5 (sum) and 7e-6 (pool) away from that float64 run on
this problem: optax rounds its f32 bias correction (the first update is
0.00999993 for lr 0.01), and gradients near 18 carry that into the loss.
The port's f32 step stays within 3e-7 of it.  At these narrowing widths the
port's mean, gcn and sum layers transform before they aggregate, the JAX
package after: two f32 roundings of one function, each within the
tolerance of the float64 forward, but not always of each other (sum's
logits near 16 cancel to 0.3 in one entry, 2 ulps of the terms apart:
1.37e-5 relative).  At widening dims [16, 32, 3] the port's last layer
transforms first where the JAX package's aggregates first.
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
from gespmm_tpu_torch.models.common import dropout, params_from_jax
from gespmm_tpu_torch.models.gcn import params_from_jax as gcn_params_from_jax
from gespmm_tpu_torch.models.sage import GraphSAGE as TSAGE
from gespmm_tpu_torch.models.sage import SAGEConv
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.train import loop as tloop
from gespmm_tpu_torch.utils import datasets as tds
from torch_helpers import (WIDTHS, empty_rows_graph, saved_activations,
                           spmm_widths, step_spmm_counts)

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


def jax_forward(jmodel, params, jadj, features, x64):
    """The JAX model's logits and log-probabilities, in float64 if ``x64``."""
    with jax.enable_x64(x64):
        if x64:
            params = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), params)
            features = jnp.asarray(features, jnp.float64)
        return (np.asarray(jmodel.apply(params, jadj, features)),
                np.asarray(jmodel.log_probs(params, jadj, features)))


@pytest.mark.parametrize("method", ["auto", "xla"])
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sage_forward_matches_jax(problem, aggregator, method):
    """Held to the JAX forward in float64, and in float32 but for ``sum``
    (the module docstring says why)."""
    jd, td, jadj, tadj = problem
    params = jax_params(aggregator)
    jmodel = JSAGE(DIMS, aggregator=aggregator, dropout_rate=0.0)
    model = torch_model(params, aggregator, method).eval()
    out = model(tadj, td.features).detach().numpy()
    lp = model.log_probs(tadj, td.features).detach().numpy()
    for x64 in (True, False) if aggregator != "sum" else (True,):
        ref, ref_lp = jax_forward(jmodel, params, jadj, jd.features, x64)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lp, ref_lp, rtol=1e-5, atol=1e-6)


WIDE = [16, 32, 3]


@pytest.mark.parametrize("aggregator", ["mean", "sum", "gcn"])
def test_widening_sage_matches_jax_in_float64(problem, aggregator):
    """[16, 32, 3]: layer 0 widens and aggregates first, as in the JAX
    package; layer 1 narrows, so the port transforms it first and the JAX
    package does not.  The forward and five AdamW steps are held to the
    JAX package run in float64, at the tolerances above."""
    jd, td, jadj, tadj = problem
    params = JSAGE(WIDE, aggregator=aggregator).init(jax.random.PRNGKey(0))
    jmodel = JSAGE(WIDE, aggregator=aggregator, dropout_rate=0.0)
    ref, _ = jax_forward(jmodel, params, jadj, jd.features, True)
    opt = optax.adamw(1e-2, weight_decay=5e-4)
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

    model = TSAGE(WIDE, aggregator=aggregator, dropout_rate=0.0)
    model.load_state_dict(params_from_jax(params))
    assert [model.layer_0.aggregate_first,
            model.layer_1.aggregate_first] == [True, False]
    np.testing.assert_allclose(model.eval()(tadj, td.features).detach().numpy(),
                               ref, rtol=1e-5, atol=1e-6)
    tstep = tloop.make_train_step(
        model.train(),
        torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=5e-4),
        tadj, td.features, td.labels, td.masks["train"])
    tlosses = [tstep().item() for _ in range(5)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    sd = model.state_dict()
    for k, v in params_from_jax(final).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-4)


def aggregation_matrix(aggregator, adj, dense):
    """The float64 matrix of a linear aggregator: mean's rows over their
    degree (an empty row stays 0), the symmetric norm, or the plain sum."""
    if aggregator == "mean":
        return dense / dense.sum(1, keepdim=True).clamp(min=1.0)
    if aggregator == "gcn":
        out_norm, in_norm = (t.double() for t in tgraph.degree_norm(adj))
        return out_norm[:, None] * dense * in_norm[None, :]
    return dense


@pytest.mark.parametrize("widths", WIDTHS.values(), ids=list(WIDTHS))
@pytest.mark.parametrize("aggregator", ["mean", "sum", "gcn"])
def test_sage_layer_aggregates_at_the_narrower_width(aggregator, widths):
    """A linear aggregator's layer aggregates first unless it narrows; its
    output and every gradient agree with the other order in float64.  The
    bias is nonzero and rows have no edge: agg(x W + b) would read 0 (mean)
    or deg * b (sum) there, where the layer reads b."""
    d_in, d_out = widths
    csr, dense = empty_rows_graph()
    adj = TAdjacency.from_csr(csr)
    layer = SAGEConv(d_in, d_out, aggregator,
                     generator=torch.Generator().manual_seed(2))
    assert layer.aggregate_first == (d_in <= d_out)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        layer.neigh.b.copy_(torch.randn(d_out, generator=gen))
    x = torch.randn(40, d_in, generator=gen, requires_grad=True)
    g = torch.randn(40, d_out, generator=gen)
    layer(adj, x).backward(g)

    m = aggregation_matrix(aggregator, adj, dense)
    x64 = x.detach().double().requires_grad_()
    leaves = {k: v.detach().double().requires_grad_()
              for k, v in layer.named_parameters()}
    w, b = leaves["neigh.w"], leaves["neigh.b"]
    want = m @ (x64 @ w) if layer.aggregate_first else (m @ x64) @ w
    want = want + b
    if aggregator != "gcn":
        want = want + x64 @ leaves["self.w"]
    want.backward(g.double())
    np.testing.assert_allclose(layer(adj, x).detach().numpy(),
                               want.detach().numpy(), rtol=1e-5, atol=1e-6)
    grads = {"x": x.grad, **{k: p.grad for k, p in layer.named_parameters()}}
    refs = {"x": x64.grad, **{k: v.grad for k, v in leaves.items()}}
    assert set(grads) == set(refs) and len(grads) == (3 if aggregator == "gcn"
                                                      else 4)
    for k, got in grads.items():
        np.testing.assert_allclose(got.numpy(), refs[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("aggregator", ["pool", "lstm"])
def test_pool_and_lstm_aggregate_first_at_every_width(problem, aggregator,
                                                      monkeypatch):
    """A max or an LSTM does not commute with W: both orders stay the
    first, and pool's max-SpMM gathers the layer's input width."""
    for d_in, d_out in WIDTHS.values():
        assert SAGEConv(d_in, d_out, aggregator).aggregate_first
    if aggregator == "pool":
        _, td, _, tadj = problem
        widths = spmm_widths(monkeypatch, tgraph)
        SAGEConv(16, 8, "pool")(tadj, td.features)
        assert widths == [16]


def small_sage_mean():
    """GraphSAGE-mean [10, 24, 24, 5] with dropout on a 5 x 20-node SBM
    graph."""
    ds = tds.sbm_graph(n_per_class=20, num_classes=5, p_in=0.2, p_out=0.02,
                       feat_dim=10, seed=0)
    model = TSAGE([10, 24, 24, 5], aggregator="mean", dropout_rate=0.5,
                  generator=torch.Generator().manual_seed(0))
    return model, TAdjacency.from_csr(ds.csr), ds


def test_sage_mean_step_aggregates_its_last_layer_at_its_output_width(
        monkeypatch):
    """[10, 24, 24, 5], mean: the SpMMs gather 10, 24 and 5 columns (the
    last layer narrows, so it transforms first); layer 0's input takes no
    gradient, so the backward runs two grad_B SpMMs."""
    model, adj, ds = small_sage_mean()
    assert [model.get_submodule(f"layer_{i}").aggregate_first
            for i in range(3)] == [True, True, False]
    step = tloop.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-2), adj,
        torch.as_tensor(ds.features), torch.as_tensor(ds.labels),
        torch.as_tensor(ds.masks["train"]),
        generator=torch.Generator().manual_seed(1))
    assert step_spmm_counts(monkeypatch, tgraph, step) == ([10, 24, 5], 3, 2)


def test_sage_relu_after_dropout_saves_each_layer_input_once():
    """[10, 24, 24, 5], mean, training: layer 1 saves its input and its
    mean, layer 2 its input (it transforms first, so no mean of 24
    columns); the ReLU's output is the input saved, not a fourth tensor.
    The numbers are those of ReLU then dropout, bit for bit."""
    model, adj, ds = small_sage_mean()
    x = torch.as_tensor(ds.features)
    assert saved_activations(model, adj, x, 24) == 3
    gen = torch.Generator().manual_seed(1)
    h = x
    for i in range(3):
        h = dropout(h, 0.5, True, gen)
        h = getattr(model, f"layer_{i}")(adj, h)
        if i < 2:
            h = torch.relu(h)
    got = model.train()(adj, x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, h)


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
