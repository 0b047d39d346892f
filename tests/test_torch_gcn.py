"""Port parity: the GCN, its training step and the loop, against the JAX package.

A small SBM graph (3 x 50 nodes, 16 features) with self-loops, dims
[16, 8, 3].  ``jax.random`` and ``torch.Generator`` draw different numbers,
so the JAX parameters go across through ``params_from_jax`` and dropout is
off.  Tolerances: forward rtol 1e-5 (f32, summation order differs); five
AdamW steps: losses rtol 1e-5, parameters atol 1e-4 (Adam's m/sqrt(v)
amplifies order noise on near-zero gradients).  A layer's order (sum-SpMM
at the narrower of its widths) is held to the other order in float64, on a
graph with empty rows and columns; at widening dims [16, 32, 3] the port's
order differs from the JAX package's, and the port is held to the JAX run
in float64.
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

from gespmm_tpu.models.gcn import GCN as JGCN
from gespmm_tpu.ops import graph as jgraph
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.train import loop as jloop
from gespmm_tpu.utils import datasets as jds

from gespmm_tpu_torch.bench import gcn_bench
from gespmm_tpu_torch.models.common import dropout, glorot
from gespmm_tpu_torch.models.gcn import GCN as TGCN
from gespmm_tpu_torch.models.gcn import params_from_jax
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.train import loop as tloop
from gespmm_tpu_torch.models import gcn as tgcn
from gespmm_tpu_torch.utils import datasets as tds
from gespmm_tpu_torch.utils import timing
from torch_helpers import (WIDTHS, empty_rows_graph, saved_activations,
                           step_spmm_counts)

DIMS = [16, 8, 3]
SBM = dict(n_per_class=50, num_classes=3, p_in=0.08, p_out=0.01, feat_dim=16,
           seed=0)


@pytest.fixture(scope="module")
def problem():
    jd, td = jds.sbm_graph(**SBM), tds.sbm_graph(**SBM)
    jadj = JAdjacency.from_csr(jgraph.add_self_loops(jd.csr))
    tadj = TAdjacency.from_csr(tgraph.add_self_loops(td.csr))
    params = JGCN(DIMS).init(jax.random.PRNGKey(0))
    return jd, td, jadj, tadj, params


def torch_model(params, method="auto"):
    model = TGCN(DIMS, dropout_rate=0.0, method=method)
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("method", ["auto", "xla"])
def test_gcn_forward_matches_jax(problem, method):
    jd, td, jadj, tadj, params = problem
    ref = JGCN(DIMS, dropout_rate=0.0).apply(params, jadj, jd.features)
    model = torch_model(params, method).with_norms(tadj).eval()
    out = model(tadj, td.features)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    lp = model.log_probs(tadj, td.features)
    jlp = JGCN(DIMS, dropout_rate=0.0).log_probs(params, jadj, jd.features)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp),
                               rtol=1e-5, atol=1e-6)


WIDE = [16, 32, 3]


def test_widening_gcn_matches_jax_in_float64(problem):
    """[16, 32, 3]: layer 0 widens, so the port takes its W's gradient from
    the aggregate of x.  The forward and five AdamW steps are held to the
    JAX package run in float64, at the tolerances above."""
    jd, td, jadj, tadj, _ = problem
    params = JGCN(WIDE).init(jax.random.PRNGKey(0))
    jmodel = JGCN(WIDE, dropout_rate=0.0)
    opt = optax.adamw(1e-2, weight_decay=5e-4)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        x64 = jnp.asarray(jd.features, jnp.float64)
        ref = np.asarray(jmodel.apply(p64, jadj, x64))
        state = jloop.TrainState(p64, opt.init(p64), jnp.zeros((), jnp.int32))
        jstep = jloop.make_train_step(jmodel, opt)
        jlosses = []
        for _ in range(5):
            state, loss = jstep(state, jadj, x64, jd.labels, jd.masks["train"],
                                jax.random.PRNGKey(1))
            jlosses.append(float(loss))
        final = jax.device_get(state.params)

    model = TGCN(WIDE, dropout_rate=0.0).with_norms(tadj)
    model.load_state_dict(params_from_jax(params))
    assert model.aggregate_input == (True, False)
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


@pytest.mark.parametrize("x_grad", [False, True], ids=["x", "x_grad"])
@pytest.mark.parametrize("widths", WIDTHS.values(), ids=list(WIDTHS))
def test_gcn_layer_gradients_match_float64(widths, x_grad):
    """A layer's output and every gradient (W's, b's, and x's where x takes
    one) agree with float64, whether W's gradient comes from x's aggregate
    (a layer that widens, x without gradient) or from a grad_B SpMM.
    Nonzero bias; rows and columns without an edge."""
    d_in, d_out = widths
    csr, dense = empty_rows_graph()
    adj = TAdjacency.from_csr(csr)
    model = TGCN([d_in, d_out], dropout_rate=0.0,
                 generator=torch.Generator().manual_seed(2)).with_norms(adj)
    assert model.aggregate_input == (d_in < d_out,)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        model.layer_0.b.copy_(torch.randn(d_out, generator=gen))
    x = torch.randn(40, d_in, generator=gen, requires_grad=x_grad)
    g = torch.randn(40, d_out, generator=gen)
    model(adj, x).backward(g)

    out_norm, in_norm = (t.double() for t in tgraph.degree_norm(adj))
    a_hat = out_norm[:, None] * dense * in_norm[None, :]
    x64 = x.detach().double().requires_grad_(x_grad)
    w64 = model.layer_0.w.detach().double().requires_grad_()
    b64 = model.layer_0.b.detach().double().requires_grad_()
    want = a_hat @ x64 @ w64 + b64
    want.backward(g.double())
    np.testing.assert_allclose(model(adj, x).detach().numpy(),
                               want.detach().numpy(), rtol=1e-5, atol=1e-6)
    pairs = [(model.layer_0.w.grad, w64.grad), (model.layer_0.b.grad, b64.grad)]
    if x_grad:
        pairs.append((x.grad, x64.grad))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6)


def small_gcn():
    """GCN [10, 24, 24, 5] with dropout on a 5 x 20-node SBM graph."""
    ds = tds.sbm_graph(n_per_class=20, num_classes=5, p_in=0.2, p_out=0.02,
                       feat_dim=10, seed=0)
    adj = TAdjacency.from_csr(tgraph.add_self_loops(ds.csr))
    model = TGCN([10, 24, 24, 5], dropout_rate=0.5,
                 generator=torch.Generator().manual_seed(0)).with_norms(adj)
    return model, adj, ds


def plain_forward(model, adj, x):
    """The GCN's training forward with autograd through every op: x @ W,
    the degree-norm products and the SpMM, + b, ReLU then dropout (seed
    1)."""
    gen = torch.Generator().manual_seed(1)
    out_norm, in_norm = model.norms
    h = x
    for i in range(model.n_layers):
        layer = getattr(model, f"layer_{i}")
        h = tgcn.spmm(adj, (h @ layer.w) * in_norm[:, None]) * out_norm[:, None]
        h = h + layer.b
        if i < model.n_layers - 1:
            h = dropout(torch.relu(h), 0.5, True, gen)
    return h


def test_gcn_step_runs_no_grad_b_at_layer_0(monkeypatch):
    """[10, 24, 24, 5]: layer 0 widens and its input takes no gradient, so
    x's aggregate gathers 10 columns and its forward 24, and the backward
    runs two grad_B SpMMs (layers 1 and 2), not three."""
    model, adj, ds = small_gcn()
    assert model.aggregate_input == (True, False, False)
    step = tloop.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-2), adj,
        torch.as_tensor(ds.features), torch.as_tensor(ds.labels),
        torch.as_tensor(ds.masks["train"]),
        generator=torch.Generator().manual_seed(1))
    assert step_spmm_counts(monkeypatch, tgcn, step) == ([10, 24, 24, 5], 4,
                                                         2)


def test_gcn_forward_and_gradients_are_those_of_the_plain_order():
    """The forward, and every leaf's gradient but layer 0's W, equal those
    of autograd through every op, bit for bit; layer 0's W, taken from x's
    aggregate, within rtol 1e-5.  With x taking a gradient, layer 0 runs
    the plain order and every gradient is equal."""
    model, adj, ds = small_gcn()
    for x_grad in (False, True):
        x = torch.as_tensor(ds.features).clone().requires_grad_(x_grad)
        want = plain_forward(model, adj, x)
        g = torch.randn(want.shape, generator=torch.Generator().manual_seed(4))
        leaves = dict(model.named_parameters(), **({"x": x} if x_grad else {}))
        refs = dict(zip(leaves, torch.autograd.grad(want, list(leaves.values()),
                                                    g)))
        model.zero_grad()
        got = model.train()(adj, x, generator=torch.Generator().manual_seed(1))
        assert torch.equal(got, want)
        got.backward(g)
        for k, p in model.named_parameters():
            if k == "layer_0.w" and not x_grad:
                np.testing.assert_allclose(p.grad.numpy(), refs[k].numpy(),
                                           rtol=1e-5, atol=1e-7)
            else:
                assert torch.equal(p.grad, refs[k]), k
        if x_grad:
            assert torch.equal(x.grad, refs["x"])


def test_gcn_dropout_before_relu_saves_each_hidden_activation_once():
    """ReLU after dropout: its saved output is the next layer's saved input,
    one tensor a hidden layer (relu then dropout saved two)."""
    model, adj, ds = small_gcn()
    assert saved_activations(model, adj, torch.as_tensor(ds.features),
                             24) == 2


def test_gcn_parameter_names_and_shapes(problem):
    *_, params = problem
    model = TGCN(DIMS)
    sd = model.state_dict()
    assert sorted(sd) == ["layer_0.b", "layer_0.w", "layer_1.b", "layer_1.w"]
    for k, v in params_from_jax(params).items():
        assert sd[k].shape == v.shape


def test_degree_norm_and_gcn_aggregate_match_jax(problem):
    jd, td, jadj, tadj, _ = problem
    for a, b in zip(jgraph.degree_norm(jadj), tgraph.degree_norm(tadj)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    ref = jgraph.gcn_aggregate(jadj, jd.features)
    out = tgraph.gcn_aggregate(tadj, td.features)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_loss_and_accuracy_match_jax(problem):
    jd, td, *_ = problem
    logits = np.random.default_rng(5).standard_normal((150, 3)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    mask = td.masks["train"]
    np.testing.assert_allclose(
        tloop.masked_nll_loss(torch.from_numpy(lp), td.labels, mask).item(),
        float(jloop.masked_nll_loss(jnp.asarray(lp), jd.labels,
                                    jd.masks["train"])), rtol=1e-6)
    assert tloop.accuracy(torch.from_numpy(logits), td.labels, mask).item() == \
        pytest.approx(float(jloop.accuracy(jnp.asarray(logits), jd.labels,
                                           jd.masks["train"])))


def test_five_adamw_steps_match_optax(problem):
    jd, td, jadj, tadj, params = problem
    lr, wd = 1e-2, 5e-4
    jmodel = JGCN(DIMS, dropout_rate=0.0)
    opt = optax.adamw(lr, weight_decay=wd)
    state = jloop.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    jstep = jloop.make_train_step(jmodel, opt)
    jlosses = []
    for _ in range(5):
        state, loss = jstep(state, jadj, jd.features, jd.labels,
                            jd.masks["train"], jax.random.PRNGKey(1))
        jlosses.append(float(loss))

    model = torch_model(params).with_norms(tadj)
    tstep = tloop.make_train_step(
        model, torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=wd),
        tadj, td.features, td.labels, td.masks["train"])
    tlosses = [tstep().item() for _ in range(5)]

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    sd = model.state_dict()
    for k, v in params_from_jax(jax.device_get(state.params)).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-4)


def test_train_node_classifier_learns(problem):
    _, td, _, tadj, _ = problem
    model = TGCN(DIMS, dropout_rate=0.5,
                 generator=torch.Generator().manual_seed(0)).with_norms(tadj)
    res = tloop.train_node_classifier(model, tadj, td.features, td.labels,
                                      td.masks, epochs=30, seed=0)
    loss = res["history"]["loss"]
    assert len(loss) == 30 and loss[-1] < loss[0]
    assert np.all(np.isfinite(loss))
    assert res["train_acc"] > 1 / 3 + 0.2
    # Epochs after the warm-up are timed, as in the JAX loop.
    assert len(res["history"]["epoch_time"]) == 30 - 4
    assert res["mean_epoch_time"] > 0


def test_dropout_and_glorot_use_the_generator():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(glorot((16, 8), generator=g1), glorot((16, 8), generator=g2))
    w = glorot((16, 8), generator=g1)
    assert w.abs().max() <= (6 / 24) ** 0.5
    x = torch.ones(1000, 4)
    a = dropout(x, 0.5, True, torch.Generator().manual_seed(7))
    b = dropout(x, 0.5, True, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and set(a.unique().tolist()) <= {0.0, 2.0}
    assert dropout(x, 0.5, False) is x


def test_gcn_bench_cli_prints_json_line(capsys):
    gcn_bench.main(["--dataset", "sbm", "--n-epochs", "6", "--device", "cpu",
                    "--log-every", "0"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["dims"] == [64, 32, 4] and rec["impl"] == "ours"
    assert rec["device"] == "cpu" and rec["mean_epoch_time_ms"] > 0
    assert 0.0 <= rec["test_acc"] <= 1.0


def test_timing_on_the_cpu_names_its_device():
    x = torch.randn(64, 64)
    res = timing.benchmark(lambda: x @ x, iters=20)
    assert res.device == "cpu" and res.iters >= 20
    assert 0 < res.best_s <= res.median_s and res.mean_s > 0
    assert res.gflops(timing.spmm_flops(10, 4)) == pytest.approx(80 / res.mean_s / 1e9)
    chained = timing.benchmark_chained(lambda v: torch.tanh(v @ x), x, iters=5,
                                       groups=3)
    assert chained.device == "cpu" and chained.iters == 15
    with pytest.raises(ValueError, match="CUDA"):
        timing.device_time(lambda: x @ x)


def test_import_does_not_pull_in_jax():
    code = ("import sys, gespmm_tpu_torch, gespmm_tpu_torch.bench.gcn_bench, "
            "gespmm_tpu_torch.train.loop, gespmm_tpu_torch.utils.timing; "
            "print('jax' in sys.modules, 'gespmm_tpu' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root).stdout.split()
    assert out == ["False", "False"]
