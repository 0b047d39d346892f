"""Port parity: the LSTM aggregator (``models/sage_lstm.py``) and ``GraphSAGE(aggregator="lstm")``.

``build_neighbor_table`` must return arrays equal to the JAX package's (the
same NumPy generator calls), on a graph with rows above and below
``max_neighbors`` and an empty row.  ``lstm_aggregate`` and the model, at
``params_from_jax`` of the JAX init, are held to JAX: forward within
1e-5·max|ref| + 1e-6, gradients within 1e-4·max(|ref|, 1).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.models import sage_lstm as jlstm
from gespmm_tpu.models.sage import GraphSAGE as JSAGE
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.sparse.formats import csr_from_scipy as jcsr_from_scipy

from gespmm_tpu_torch.bench import sage_bench
from gespmm_tpu_torch.models import sage_lstm as tlstm
from gespmm_tpu_torch.models.common import params_from_jax
from gespmm_tpu_torch.models.sage import GraphSAGE as TSAGE
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.sparse.formats import csr_from_scipy as tcsr_from_scipy

MAXN = 6
DIMS = [8, 6, 3]


def close_fwd(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


def close_grad(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


@pytest.fixture(scope="module")
def graph():
    """A binary 40 x 40 graph with degrees 0..15 (row 3 empty), and both
    packages' CSR of it."""
    rng = np.random.default_rng(21)
    deg = rng.integers(0, 16, 40)
    deg[3] = 0
    deg[5] = MAXN
    deg[6] = MAXN + 1
    rows = np.repeat(np.arange(40), deg)
    cols = np.concatenate([np.sort(rng.choice(40, d, replace=False))
                           for d in deg])
    mat = sp.csr_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)),
                        shape=(40, 40))
    return mat, jcsr_from_scipy(mat).with_data(None), \
        tcsr_from_scipy(mat).with_data(None)


@pytest.mark.parametrize("seed", [0, 5])
def test_neighbor_table_equals_jax(graph, seed):
    mat, jcsr, tcsr = graph
    jn, jm = jlstm.build_neighbor_table(jcsr, max_neighbors=MAXN, seed=seed)
    tn, tm = tlstm.build_neighbor_table(tcsr, max_neighbors=MAXN, seed=seed)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.dtype == torch.bool and tn.shape == (40, MAXN)
    deg = np.diff(mat.indptr)
    assert (tm.sum(1).numpy() == np.minimum(deg, MAXN)).all()
    assert not tm[3].any()


def test_lstm_aggregate_matches_jax(graph):
    _, jcsr, tcsr = graph
    params = jlstm.lstm_cell_init(jax.random.PRNGKey(1), 8, 8)
    cell = tlstm.LSTM(8, 8)
    cell.load_state_dict(params_from_jax(params))
    assert sorted(cell.state_dict()) == ["b", "wh", "wi"]
    assert cell.wi.shape == (8, 32) and cell.wh.shape == (8, 32)
    x = np.random.default_rng(2).standard_normal((40, 8)).astype(np.float32)
    G = np.random.default_rng(3).standard_normal((40, 8)).astype(np.float32)
    jn, jm = jlstm.build_neighbor_table(jcsr, max_neighbors=MAXN)
    tn, tm = tlstm.build_neighbor_table(tcsr, max_neighbors=MAXN)

    def jloss(p, x):
        return jnp.sum(jlstm.lstm_aggregate(p, x, jn, jm) * G)

    jout = jlstm.lstm_aggregate(params, jnp.asarray(x), jn, jm)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = cell(tx, tn, tm)
    close_fwd(out.detach(), jout)
    # The empty row keeps the zero state.
    assert torch.equal(out[3], torch.zeros(8))
    (out * torch.from_numpy(G)).sum().backward()
    close_grad(tx.grad, jgx)
    for k, want in params_from_jax(jgp).items():
        close_grad(getattr(cell, k).grad, want)


def test_graphsage_lstm_matches_jax(graph):
    _, jcsr, tcsr = graph
    jtable = jlstm.build_neighbor_table(jcsr, max_neighbors=MAXN)
    ttable = tlstm.build_neighbor_table(tcsr, max_neighbors=MAXN)
    jmodel = JSAGE(DIMS, aggregator="lstm", dropout_rate=0.0,
                   neighbor_table=jtable)
    params = jmodel.init(jax.random.PRNGKey(4))
    x = np.random.default_rng(5).standard_normal((40, 8)).astype(np.float32)
    G = np.random.default_rng(6).standard_normal((40, 3)).astype(np.float32)
    jadj = JAdjacency.from_csr(jcsr)

    def jloss(p):
        return jnp.sum(jmodel.apply(p, jadj, jnp.asarray(x)) * G)

    jout = jmodel.apply(params, jadj, jnp.asarray(x))
    jgrads = params_from_jax(jax.grad(jloss)(params))
    model = TSAGE(DIMS, aggregator="lstm", dropout_rate=0.0)
    model.load_state_dict(params_from_jax(params))
    tadj = TAdjacency.from_csr(tcsr)
    # The table per call, and at construction.
    out = model(tadj, torch.from_numpy(x), neighbor_table=ttable)
    close_fwd(out.detach(), jout)
    model.neighbor_table = ttable
    close_fwd(model(tadj, torch.from_numpy(x)).detach(), jout)
    (out * torch.from_numpy(G)).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for k, want in jgrads.items():
        close_grad(grads[k], want)


def test_missing_table_raises_jax_error(graph):
    _, _, tcsr = graph
    model = TSAGE(DIMS, aggregator="lstm")
    with pytest.raises(ValueError, match="needs a neighbor_table"):
        model(TAdjacency.from_csr(tcsr), torch.zeros(40, 8))


def test_sage_bench_lstm_prints_one_json_line(capsys):
    sage_bench.main(["--aggregator-type", "lstm", "--dataset", "sbm",
                     "--device", "cpu", "--n-epochs", "5", "--max-neighbors",
                     "8", "--log-every", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["aggregator"] == "lstm" and rec["impl"] == "ours"
    assert rec["mean_epoch_time_ms"] > 0 and 0.0 <= rec["test_acc"] <= 1.0
