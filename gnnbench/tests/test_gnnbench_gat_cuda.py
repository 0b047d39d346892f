"""On a card: a tiny cell of the GAT configuration driven through a whole
traced run, the fused attention kernels included, and the program's spans
of its step read from the trace.  Run with ``python -m pytest
gnnbench/tests/test_gnnbench_gat_cuda.py -q`` on a machine with a card;
elsewhere every test skips."""

import json

import pytest
import torch

from gnnbench import harness, spans
from gnnbench.tests import tiny_cells

pytestmark = pytest.mark.cuda

CONFIG = "gat-ogbn-products"
# The spans a GAT step opens, beside the step's own.
GAT_SPANS = {"op/gat", "op/gat.grad", "model/attn_scores", "model/elu",
             "model/dense", "model/dropout", "model/log_softmax"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def test_traced_tiny_gat_cell_on_the_card(card, tmp_path, monkeypatch):
    root = tiny_cells.make_root(tmp_path)
    cell = tiny_cells.tiny_cell(root, CONFIG)
    trace = tmp_path / "traces" / f"{cell.name}.json"
    # The readers look for the trace of a cell of the repository's
    # benchmark; this one is the tiny cell's.
    monkeypatch.setattr(spans, "_trace_files", lambda run: [trace])
    result = harness.run(cell, 2**31 + 11, 1.0, True, card, 0.0,
                         trace_dir=tmp_path / "traces")
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    metrics = result["metrics"]
    assert {"gat_op_ms", "gat_roofline", "dense_ms", "kernels_per_step",
            "step_mfu", "dropout_ms", "unattributed_ms"} <= set(metrics)
    assert "spmm_ms" not in metrics and "spmm_op_ms" not in metrics
    assert 0 < metrics["gat_roofline"]["value"] <= 100
    with open(trace) as f:
        table = spans.table(json.load(f))
    assert GAT_SPANS <= set(table["device_ms"])
    assert table["bwd_ms"].get("model/attn_scores", 0) > 0
    assert metrics["gat_op_ms"]["value"] == pytest.approx(
        table["device_ms"]["op/gat"] + table["device_ms"]["op/gat.grad"])
