"""The weak-scaling benchmark of the port against the JAX package's.

``gespmm_tpu_torch.bench.dist_bench.bench_weak_scaling`` (one process, the
shards on the CPU) and ``gespmm_tpu.bench.dist_bench.bench_weak_scaling``
(the virtual 8-device mesh) at 1 and 2 shards on an R-MAT graph of 2^8
nodes a shard: every row has the JAX keys, and the graph (nodes, nnz) and
the footprint fractions (the partitioned halo exchange's and the naive
slab split's) are equal; only the times differ.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gespmm_tpu.bench import dist_bench as jbench
from gespmm_tpu_torch.bench import dist_bench as tbench

ARGS = dict(devices_list=[1, 2], scale=8, k=8, edge_factor=8, iters=2)


@pytest.mark.parametrize("partition", ["none", "auto", "fennel", "random"])
@pytest.mark.parametrize("method", ["halo-tiled", "halo", "allgather"])
def test_rows_match_jax(method, partition, capsys):
    want = jbench.bench_weak_scaling(method=method, partition=partition,
                                     **ARGS)
    capsys.readouterr()
    got = tbench.bench_weak_scaling(method=method, partition=partition,
                                    device="cpu", **ARGS)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"warning": "one device holds every shard: efficiency "
                        "numbers measure contention, not scaling"}
    assert lines[1:] == got
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("devices", "nodes", "nnz", "k", "halo_footprint_frac",
                    "naive_footprint_frac", "partition"):
            assert g.get(key) == w.get(key), key
        assert g["ms"] > 0 and np.isfinite(g["nnz_per_s"])
    assert got[0]["weak_scaling_efficiency"] == 1.0


def test_main_prints_rows_and_launches(capsys):
    tbench.main(["--devices", "1", "2", "--scale", "7", "--k", "4",
                 "--iters", "2", "--method", "halo-tiled", "--partition",
                 "auto", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert "warning" in lines[0]
    assert [r["devices"] for r in lines[1:3]] == [1, 2]
    assert lines[2]["partition"] == "auto"
    assert lines[2]["halo_footprint_frac"] <= lines[2]["naive_footprint_frac"]
    # The CPU runs the kernels' plain versions: no launch.
    assert lines[3] == {"kernel_launches": {"halo_spmm": 0,
                                            "halo_spmm_carry": 0,
                                            "spmm_csr": 0,
                                            "spmm_csr_carry": 0}}


def test_new_modules_do_not_pull_in_jax():
    code = ("import sys, gespmm_tpu_torch.utils.native, "
            "gespmm_tpu_torch.sparse.reorder, "
            "gespmm_tpu_torch.bench.dist_bench, "
            "gespmm_tpu_torch.utils.profiling, gespmm_tpu_torch.parallel.mesh; "
            "print('jax' in sys.modules, 'gespmm_tpu' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root).stdout.split()
    assert out == ["False", "False"]
