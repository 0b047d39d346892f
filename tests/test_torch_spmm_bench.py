"""Port parity: the synthetic graph corpus, the SpMM/SDDMM sweep, and the
roofline arithmetic, against the JAX package.

``synth_graph`` draws from NumPy with the same seed and the same calls as
the JAX package, so its arrays must be equal.  The sweep runs here with
``device="cpu"`` on tiny graphs: its rows must carry the JAX package's
column names (``gespmm_tpu/bench/spmm_bench.py``), a forced validation
failure must be recorded as a cell error, and a foreign or malformed CSV
must not lose a run (the guard the JAX ``_append_csv`` lacks for a row
with extra fields).  Timings from a CPU run are the host's and are not
checked.
"""

import csv
import json

import numpy as np
import pytest
import torch

from gespmm_tpu.bench.spmm_bench import bench_graph as jbench_graph
from gespmm_tpu.utils.datasets import synth_graph as jsynth

from gespmm_tpu_torch.bench import spmm_bench as sb
from gespmm_tpu_torch.utils import profiling, timing
from gespmm_tpu_torch.utils.datasets import synth_graph

NAMES = ["rmat8", "banded200", "banded150-3", "rect120x90", "rect60x200-5",
         "cl300", "cl400-6", "grid12", "grid10-9", "hub300", "hub200-2",
         "sbm20"]
ALL_METHODS = ("xla", "tiled", "pallas", "scatter", "dense", "bcoo")


@pytest.mark.parametrize("name", NAMES)
def test_synth_graph_matches_jax(name):
    j, t = jsynth(name, seed=3), synth_graph(name, seed=3)
    assert tuple(t.shape) == tuple(j.shape) and t.data is None
    np.testing.assert_array_equal(t.indptr.numpy(), np.asarray(j.indptr))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))


def test_synth_graph_unknown_name():
    assert synth_graph("karate") is None and jsynth("karate") is None
    with pytest.raises(ValueError, match="stencil"):
        synth_graph("grid8-7")


@pytest.fixture(scope="module")
def cpu_sweep():
    return sb.bench_graph("rmat7", [8, 33], iters=4,
                          methods=ALL_METHODS + ("tiled-hilo", "tiled-fast"),
                          validate=True,
                          device="cpu")


def test_bench_graph_row_has_the_jax_columns(cpu_sweep):
    row, results = cpu_sweep
    j_row, _ = jbench_graph("rmat7", [8], iters=2, methods=("xla",))
    assert set(j_row) <= set(row)
    for K in (8, 33):
        for method in ALL_METHODS + ("tiled-hilo", "tiled-fast"):
            assert "error" not in results[(K, method)], results[(K, method)]
            assert results[(K, method)]["ms"] > 0
            assert results[(K, method)]["timer"] == "host"
            assert not np.isnan(row[f"K={K}-{method}-gflops"])
    assert (row["m"], row["n"], row["device"]) == (128, 128, "cpu")


def test_bench_sddmm_row(capsys):
    row, results = sb.bench_sddmm_graph("rmat7", [16], iters=4,
                                        validate=True, device="cpu")
    assert set(row) >= {"data", "m", "n", "nnz", "K=16-sddmm-xla-gflops",
                        "K=16-sddmm-tiled-gflops"}
    assert not any("error" in v for v in results.values())


def test_forced_validation_failure_is_a_cell_error():
    row, results = sb.bench_graph("rmat6", [4], iters=2,
                                  methods=("xla", "pallas"), validate=True,
                                  tol=-1.0, device="cpu")
    for method in ("xla", "pallas"):
        assert results[(4, method)]["error"].startswith("VALIDATION FAILED")
        assert np.isnan(row[f"K=4-{method}-gflops"])


def test_main_prints_one_json_row(tmp_path, capsys):
    out_csv = tmp_path / "sweep.csv"
    sb.main(["--graphs", "grid8", "--k", "4", "--methods", "xla", "pallas",
             "--iters", "2", "--validate", "--device", "cpu", "--csv",
             str(out_csv)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["data"] == "grid8" and not np.isnan(row["K=4-pallas-gflops"])
    with open(out_csv) as f:
        assert [r["data"] for r in csv.DictReader(f)] == ["grid8"]


@pytest.mark.parametrize("content", [
    # A row with more fields than the header (the JAX merge then fails on
    # the extra key), and a row without a data value.
    "data,m\nold,1,EXTRA\n,2\nkeep,3\n",
    # A foreign file: no data column.
    "name,value\nx,1\n",
    # Not text at all.
    b"\xff\xfe\x00garbage\x00",
])
def test_append_csv_survives_a_foreign_or_malformed_file(tmp_path, content):
    path = tmp_path / "sweep.csv"
    if isinstance(content, bytes):
        path.write_bytes(content)
    else:
        path.write_text(content)
    sb._append_csv(str(path), {"data": "new", "m": 5, "K=4-xla-gflops": 1.5})
    with open(path) as f:
        rows = {r["data"]: r for r in csv.DictReader(f)}
    assert rows["new"]["K=4-xla-gflops"] == "1.5"
    if "keep" in str(content):
        assert rows["keep"]["m"] == "3" and "old" not in rows
    sb._append_csv(str(path), {"data": "new", "m": 6})  # a re-run replaces
    with open(path) as f:
        assert [r["m"] for r in csv.DictReader(f) if r["data"] == "new"] == ["6"]


def test_roofline_arithmetic():
    # sbm-pubmed K=32, binary: 19,719 rows, 102,707 nonzeros.
    b = profiling.spmm_bytes(102_707, 19_719, 32)
    assert b == 78_880 + 410_828 + 2 * 2_524_032
    rf = profiling.spmm_roofline(102_707, 19_719, 32, 7.28e-6)
    assert rf["bound_by"] == "bytes"
    assert rf["speed_of_light_s"] == pytest.approx(b / 3.35e12)
    assert rf["fraction_of_roofline"] == pytest.approx(b / 3.35e12 / 7.28e-6)
    assert profiling.spmm_bytes(10, 4, 2, n=3, valued=True) == \
        5 * 4 + 10 * 8 + 3 * 2 * 4 + 4 * 2 * 4
    t, by = profiling.bound(1.0, 1e9)
    assert by == "operations" and t == pytest.approx(1e9 / 67e12)
    assert timing.sddmm_flops(10, 4) == timing.spmm_flops(10, 4) == 80.0


def test_host_runs_refuse_device_metrics():
    with pytest.raises(ValueError, match="CUDA"):
        profiling.measure_hbm_bandwidth(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            sb.bench_graph("rmat6", [4], device="cuda")
