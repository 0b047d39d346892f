"""Port parity: the GCN, its training step and the loop, against the JAX package.

A small SBM graph (3 x 50 nodes, 16 features) with self-loops, dims
[16, 8, 3].  ``jax.random`` and ``torch.Generator`` draw different numbers,
so the JAX parameters go across through ``params_from_jax`` and dropout is
off.  Tolerances: forward rtol 1e-5 (f32, summation order differs); five
AdamW steps: losses rtol 1e-5, parameters atol 1e-4 (Adam's m/sqrt(v)
amplifies order noise on near-zero gradients).
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
from gespmm_tpu_torch.utils import datasets as tds
from gespmm_tpu_torch.utils import timing

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
