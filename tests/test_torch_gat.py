"""Port parity: GAT (single- and multi-head), its training steps and its bench, against the JAX package.

A small SBM graph (3 x 20 nodes, 16 features) with self-loops, as the JAX
GAT bench builds its graph, and dims [16, 8, 3].  ``jax.random`` and
``torch.Generator`` draw different numbers, so the JAX parameters go across
through ``params_from_jax`` and dropout is off.  ``method="auto"`` is held
to the JAX model on a planned ``Adjacency`` (its fused Pallas op, in
interpret mode) at the fused op's forward tolerance, rtol/atol 1e-4;
``"xla"`` to the JAX model's composed chain on an unplanned one at 1e-5.
Five AdamW steps are held to the JAX package's composed-chain step run in
float64 (losses rtol 1e-5, parameters atol 1e-4, as in
``test_torch_sage.py``), through both of the port's routes.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gespmm_tpu.models.gat import GAT as JGAT
from gespmm_tpu.ops import graph as jgraph
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.train import loop as jloop
from gespmm_tpu.utils import datasets as jds

from gespmm_tpu_torch.bench import gat_bench
from gespmm_tpu_torch.kernels import gat_fused as kgat
from gespmm_tpu_torch.models.common import params_from_jax
from gespmm_tpu_torch.models.gat import GAT as TGAT
from gespmm_tpu_torch.models.gat import GATConv
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.train import loop as tloop
from gespmm_tpu_torch.utils import datasets as tds

DIMS = [16, 8, 3]
SBM = dict(n_per_class=20, num_classes=3, p_in=0.15, p_out=0.02, feat_dim=16,
           seed=0)
PLAN = dict(col_tile=1 << 20, rows_per_block=8, chunk_nnz=8)
TOL = {"auto": dict(rtol=1e-4, atol=1e-4), "xla": dict(rtol=1e-5, atol=1e-5)}


@pytest.fixture(scope="module")
def problem():
    jd, td = jds.sbm_graph(**SBM), tds.sbm_graph(**SBM)
    jcsr = jgraph.add_self_loops(jd.csr)
    return (jd, td, {"auto": JAdjacency.from_csr(jcsr, plan=True, **PLAN),
                     "xla": JAdjacency.from_csr(jcsr)},
            TAdjacency.from_csr(tgraph.add_self_loops(td.csr)))


def jax_params(heads):
    return JGAT(DIMS, heads=heads).init(jax.random.PRNGKey(heads))


def torch_model(params, heads, method="auto"):
    model = TGAT(DIMS, dropout_rate=0.0, method=method, heads=heads)
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.fixture(scope="module")
def jax_logits(problem):
    """{(heads, method): JAX logits}: "auto" on the planned adjacency (the
    fused op), "xla" on the unplanned one (the composed chain)."""
    jd, _, jadj, _ = problem
    out = {}
    for heads in (1, 2):
        params = jax_params(heads)
        for method in ("auto", "xla"):
            model = JGAT(DIMS, dropout_rate=0.0, method=method, heads=heads)
            out[(heads, method)] = np.asarray(
                model.apply(params, jadj[method], jd.features))
    return out


@pytest.mark.parametrize("method", ["auto", "xla"])
@pytest.mark.parametrize("heads", [1, 2])
def test_gat_forward_matches_jax(problem, jax_logits, heads, method):
    _, td, _, tadj = problem
    model = torch_model(jax_params(heads), heads, method).eval()
    logits = model(tadj, td.features)
    assert logits.shape == (60, DIMS[-1])
    np.testing.assert_allclose(logits.detach().numpy(),
                               jax_logits[(heads, method)], **TOL[method])
    lp = model.log_probs(tadj, td.features).detach().numpy()
    np.testing.assert_allclose(np.exp(lp).sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("heads", [1, 2])
def test_gat_parameter_names_and_shapes(heads):
    flat = params_from_jax(jax_params(heads))
    sd = TGAT(DIMS, heads=heads).state_dict()
    assert sorted(sd) == sorted(flat)
    for k, v in flat.items():
        assert sd[k].shape == v.shape, k
    assert {k.split(".", 1)[1] for k in sd} == {"w", "a_src", "a_dst", "b"}


@pytest.mark.parametrize("method", ["auto", "xla"])
def test_gat_five_adamw_steps_match_optax(problem, method):
    jd, td, jadj, tadj = problem
    params = jax_params(1)
    lr, wd = 5e-3, 5e-4
    jmodel = JGAT(DIMS, dropout_rate=0.0, method="xla")
    opt = optax.adamw(lr, weight_decay=wd)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        x64 = jnp.asarray(jd.features, jnp.float64)
        state = jloop.TrainState(p64, opt.init(p64), jnp.zeros((), jnp.int32))
        jstep = jloop.make_train_step(jmodel, opt)
        jlosses = []
        for _ in range(5):
            state, loss = jstep(state, jadj["xla"], x64, jd.labels,
                                jd.masks["train"], jax.random.PRNGKey(1))
            jlosses.append(float(loss))
        final = jax.device_get(state.params)

    model = torch_model(params, 1, method)
    tstep = tloop.make_train_step(
        model, torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=wd),
        tadj, td.features, td.labels, td.masks["train"])
    tlosses = [tstep().item() for _ in range(5)]

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    sd = model.state_dict()
    for k, v in params_from_jax(final).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-4)


def test_dropout_runs_before_the_input_layer(problem):
    # One layer: a model without input dropout would drop nothing.
    _, td, _, tadj = problem
    model = TGAT([16, 3], dropout_rate=1.0,
                 generator=torch.Generator().manual_seed(0)).train()
    out = model(tadj, td.features, generator=torch.Generator().manual_seed(1))
    want = model.layer_0(tadj, torch.zeros_like(td.features), merge="mean")
    assert torch.equal(out, want)
    model.eval()
    assert not torch.equal(model(tadj, td.features), want)


def test_gatconv_refuses_an_unknown_method(problem):
    _, td, _, tadj = problem
    with pytest.raises(ValueError, match="unknown method"):
        GATConv(16, 4)(tadj, td.features, method="bogus")
    # "pallas" is a method of the layer; it needs a chunk or grouped plan.
    with pytest.raises(ValueError, match="plan='perrow'"):
        GATConv(16, 4)(tadj, td.features, method="pallas")


@pytest.mark.parametrize("heads", [1, 2])
def test_gat_learns(problem, heads):
    _, td, _, tadj = problem
    model = TGAT(DIMS, heads=heads, generator=torch.Generator().manual_seed(0))
    kgat.reset_launches()
    res = tloop.train_node_classifier(model, tadj, td.features, td.labels,
                                      td.masks, epochs=30, lr=5e-3, seed=0)
    loss = res["history"]["loss"]
    assert loss[-1] < loss[0] and np.all(np.isfinite(loss))
    assert res["train_acc"] > 1 / 3 + 0.2
    assert kgat.launches == 0  # the plain versions on the CPU


def test_gat_bench_cli_prints_json_line(capsys):
    gat_bench.main(["--dataset", "sbm", "--n-epochs", "3", "--device", "cpu",
                    "--log-every", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    jax_keys = {"dataset", "model", "n", "nnz", "dims", "impl", "epochs",
                "mean_epoch_time_ms", "train_acc", "val_acc", "test_acc"}
    assert jax_keys <= set(rec)
    assert rec["model"] == "gat" and rec["dims"] == [64, 64, 4]
    assert rec["impl"] == "ours" and rec["device"] == "cpu"
    assert rec["n"] == 2000 and rec["nnz"] > 2000
    # Three epochs are all warm-up, so none is timed, as in the JAX loop.
    assert math.isnan(rec["mean_epoch_time_ms"])
    assert 0.0 <= rec["test_acc"] <= 1.0


def test_gat_modules_do_not_pull_in_jax():
    code = ("import sys, gespmm_tpu_torch, gespmm_tpu_torch.models.gat, "
            "gespmm_tpu_torch.bench.gat_bench; "
            "print('jax' in sys.modules, 'gespmm_tpu' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root).stdout.split()
    assert out == ["False", "False"]
