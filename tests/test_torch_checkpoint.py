"""Checkpoint and resume: ``train/checkpoint.py`` and ``train_node_classifier(checkpoint_dir=...)``.

The JAX package's checks (``tests/test_models.py``'s structure-mismatch
test) on the port's state dicts, with the JAX package's ``restore`` held to
the same refusals; a run checkpointed every 3 epochs and resumed at epoch 3
must equal the uninterrupted 6-epoch run bit for bit on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from gespmm_tpu.train import checkpoint as jckpt

from gespmm_tpu_torch.bench import gcn_bench
from gespmm_tpu_torch.models.gcn import GCN
from gespmm_tpu_torch.ops.graph import add_self_loops
from gespmm_tpu_torch.ops.spmm import Adjacency
from gespmm_tpu_torch.train import checkpoint as tckpt
from gespmm_tpu_torch.train import loop as tloop
from gespmm_tpu_torch.utils.datasets import sbm_graph

DIMS = [16, 8, 3]


@pytest.fixture(scope="module")
def problem():
    ds = sbm_graph(n_per_class=50, num_classes=3, p_in=0.08, p_out=0.01,
                   feat_dim=16, seed=0)
    return ds, Adjacency.from_csr(add_self_loops(ds.csr))


def model_and_state(adj, dims=DIMS, seed=0):
    model = GCN(dims, generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    gen = torch.Generator().manual_seed(seed)
    return model, opt, gen


def test_round_trip(tmp_path, problem):
    _, adj = problem
    model, opt, gen = model_and_state(adj)
    state = tloop.train_state(model, opt, gen)
    path = tckpt.save(str(tmp_path), state, epoch=4)
    assert os.path.basename(path) == "ckpt_00000004.pt"
    other, oopt, ogen = model_and_state(adj, seed=1)
    got, epoch = tckpt.restore(path, tloop.train_state(other, oopt, ogen))
    assert epoch == 4
    for k, v in state["model"].items():
        assert torch.equal(got["model"][k], v)
    assert torch.equal(got["generator"], state["generator"])
    assert got["optimizer"]["param_groups"] == state["optimizer"]["param_groups"]
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert manifest["epoch"] == 4
    assert manifest["num_leaves"] == 4 + 3 * 4 + 1  # params, AdamW, generator
    assert "layer_0.w" in manifest["treedef"]


def test_latest_checkpoint_skips_tmp_and_takes_the_highest(tmp_path, problem):
    _, adj = problem
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    assert tckpt.latest_checkpoint(str(tmp_path)) is None
    state = tloop.train_state(*model_and_state(adj))
    for epoch in (2, 10, 7):
        tckpt.save(str(tmp_path), state, epoch)
    # A write cut short leaves its .tmp file: never taken.
    open(tmp_path / "ckpt_00000099.pt.tmp", "wb").close()
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt_00000010.pt")


@pytest.mark.parametrize("change", ["shape", "key", "dtype"])
def test_restore_rejects_a_changed_structure(tmp_path, problem, change):
    _, adj = problem
    path = tckpt.save(str(tmp_path), tloop.train_state(*model_and_state(adj)),
                      epoch=1)
    if change == "shape":
        template = tloop.train_state(*model_and_state(adj, [16, 9, 3]))
        match = "leaf model.layer_0.w"
    elif change == "key":
        template = tloop.train_state(*model_and_state(adj, [16, 8, 8, 3]))
        match = "structure"
    else:
        model, opt, gen = model_and_state(adj)
        model.double()
        template = tloop.train_state(model, opt, gen)
        match = "leaf"
    with pytest.raises(ValueError, match=match):
        tckpt.restore(path, template)
    # The JAX package refuses the same change.
    jstate = {"w": np.ones((4, 3), np.float32), "b": np.zeros(3, np.float32)}
    jpath = jckpt.save(str(tmp_path / "jax"), jstate, epoch=1)
    bad = {"shape": {"w": np.ones((3, 4), np.float32), "b": jstate["b"]},
           "key": {"u": jstate["w"], "v": jstate["b"]},
           "dtype": {"w": jstate["w"].astype(np.float64),
                     "b": jstate["b"]}}[change]
    with pytest.raises(ValueError):
        jckpt.restore(jpath, bad)


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, problem):
    ds, adj = problem

    def run(epochs, **kw):
        model = GCN(DIMS, dropout_rate=0.5,
                    generator=torch.Generator().manual_seed(0)).with_norms(adj)
        res = tloop.train_node_classifier(model, adj, ds.features, ds.labels,
                                          ds.masks, epochs=epochs, seed=0,
                                          **kw)
        return model, res

    straight, full = run(6)
    half, first = run(3, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.pt",
                                            "manifest.json"]
    resumed, rest = run(6, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    assert sorted(os.listdir(tmp_path))[:2] == ["ckpt_00000003.pt",
                                                "ckpt_00000006.pt"]
    assert first["history"]["loss"] + rest["history"]["loss"] == \
        full["history"]["loss"]
    for k, v in straight.state_dict().items():
        assert torch.equal(resumed.state_dict()[k], v), k
    # Warm-up counts from the start epoch, as in the JAX loop: it ends at
    # epoch 3 + min(3, 6 - 3 - 1) = 5, so none of epochs 3-5 is timed.
    assert len(rest["history"]["epoch_time"]) == 0


def test_gcn_bench_checkpoint_dir(tmp_path, capsys):
    argv = ["--dataset", "sbm", "--device", "cpu", "--log-every", "0",
            "--checkpoint-dir", str(tmp_path)]
    gcn_bench.main(argv + ["--n-epochs", "50"])
    assert "ckpt_00000050.pt" in os.listdir(tmp_path)
    gcn_bench.main(argv + ["--n-epochs", "55"])  # resumes at 50
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[1])
    assert rec["epochs"] == 55 and 0.0 <= rec["test_acc"] <= 1.0
