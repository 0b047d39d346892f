"""``trace`` and ``op_cost_table`` of the port against the JAX package's.

``op_cost_table`` of a matmul counts XLA's ``"flops"`` for the same matmul
(2·m·k·n), and ``trace`` writes a trace file into its directory.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gespmm_tpu.utils import profiling as jprof
from gespmm_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (33, 7, 65)])
def test_op_cost_table_flops_match_jax(m, k, n):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = jprof.op_cost_table(lambda x, y: x @ y, jnp.asarray(a),
                               jnp.asarray(b))
    got = tprof.op_cost_table(lambda x, y: x @ y, torch.from_numpy(a),
                              torch.from_numpy(b))
    assert got["flops"] == float(want["flops"]) == 2.0 * m * k * n
    assert sum(v for key, v in got.items() if key != "flops") == got["flops"]


def test_op_cost_table_of_a_dense_layer():
    from gespmm_tpu_torch.models.common import Dense

    layer = Dense(16, 8, generator=torch.Generator().manual_seed(0))
    table = tprof.op_cost_table(layer, torch.ones(10, 16))
    assert table["flops"] == 2.0 * 10 * 16 * 8


def test_trace_writes_a_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.name for e in prof.events())
