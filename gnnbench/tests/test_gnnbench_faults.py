"""``correct`` must come out false when the timed path is broken: a run
driven past the look for a card, on the CPU at a tiny size, with a fault
planted under it (a step that leaves the state unchanged, half the batch
left out, a wrong grad_B in one layer); and the control (the reference in TF32 in the program's
place) must fail the cell's limits."""

import pytest
import torch

from gespmm_tpu_torch.train import loop

from gnnbench import calibrate, compare, faults, harness
from gnnbench.tests import tiny_cells

REAL_STEP = loop.make_train_step

CONFIGS = ["gcn-ogbn-products", "sage-mean-ogbn-products"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cells.make_root(tmp_path_factory.mktemp("gnnbench_faults"))


def _run(cell):
    return harness.run(cell, 2**31 + 99, 0.1, False, "cpu", 0.0)


def _unchanged_state(model, optimizer, adj, x, labels, mask, *, generator):
    """A step that computes the loss and leaves the state unchanged."""
    def step():
        loss = torch.nn.functional.nll_loss(
            model.log_probs(adj, x, generator=generator)[mask], labels[mask])
        return loss.detach()
    return step


def _half_batch(model, optimizer, adj, x, labels, mask, *, generator):
    """The port's step with half of the training nodes left out."""
    keep = torch.nonzero(mask).flatten()
    half = torch.zeros_like(mask)
    half[keep[:keep.shape[0] // 2]] = True
    return REAL_STEP(model, optimizer, adj, x, labels, half,
                     generator=generator)


@pytest.mark.parametrize("config", CONFIGS)
def test_sound_run_is_correct(root, config):
    assert _run(tiny_cells.tiny_cell(root, config))["correct"]


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
@pytest.mark.parametrize("config", CONFIGS)
def test_broken_step_is_not_correct(root, config, fault, monkeypatch):
    monkeypatch.setattr(loop, "make_train_step", fault)
    result = _run(tiny_cells.tiny_cell(root, config))
    assert result["correct"] is False
    failed = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    assert failed


@pytest.mark.parametrize("config", CONFIGS)
def test_wrong_grad_b_in_one_layer_is_not_correct(root, config):
    """Half of grad_B in the first SpMM that takes a gradient: layer 0's
    weight in the GCN, layer 0's leaves in GraphSAGE.  Adam's steps scale
    it away, and the median leaf hardly moves; the worst leaf sees it."""
    cell = tiny_cells.tiny_cell(root, config)
    sites = harness.adapter(cell.config).SPMM_SITES
    with faults.halved_grad_b(sites, len(cell.config["dims"]) - 1):
        result = _run(cell)
    assert result["correct"] is False
    checks = result["checks"]["grad1_worst_gap"]
    assert checks["value"] > checks["limit"]


@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_the_limits(root, config):
    """The reference computed in TF32 in the program's place."""
    cell = tiny_cells.tiny_cell(root, config)
    graph, inputs, init = harness.make_inputs(cell, 5, "cpu")
    ref = harness.reference_readings(cell, graph, inputs, init, 5)
    low = harness.reference_readings(cell, graph, inputs, init, 5, tf32=True)
    values = compare.numbers(low, ref)
    assert not compare.judge(values, cell.limits), values


def test_calibration_reads_all_three(root):
    row = calibrate.seed_readings(tiny_cells.tiny_cell(root), 3, "cpu", True)
    assert set(row) >= {"program", "control", "half_batch", "grad_b_halved"}
    assert (row["grad_b_halved"]["grad1_worst_gap"]
            > 100 * row["program"]["grad1_worst_gap"])
    assert row["half_batch"]["loss1_gap"] > row["program"]["loss1_gap"]
