"""On a card: a tiny cell driven through a whole traced run, the port's CUDA
kernels included.  Run with ``python -m pytest
gnnbench/tests/test_gnnbench_cuda.py -q`` on a machine with a card;
elsewhere every test skips."""

import pytest
import torch

from gnnbench import harness
from gnnbench.tests import tiny_cells

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("config", ["gcn-ogbn-products",
                                    "sage-mean-ogbn-products"])
def test_traced_tiny_cell_on_the_card(card, config, tmp_path):
    root = tiny_cells.make_root(tmp_path)
    cell = tiny_cells.tiny_cell(root, config)
    result = harness.run(cell, 2**31 + 11, 1.0, True, card, 0.0,
                         trace_dir=tmp_path / "traces")
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert {"spmm_ms", "dense_ms", "kernels_per_step", "step_mfu",
            "spmm_roofline"} <= set(result["metrics"])
    assert 0 < result["metrics"]["spmm_roofline"]["value"] <= 100
    assert result["breakdown"]["device_ops"]
