"""The harness finds everything by name: a cell built from a traffic file
added beside the others runs with no existing file edited; and the
benchmark's files keep to the contract's names and shapes."""

import json
import re

import pytest

from gnnbench import harness
from gnnbench.tests import tiny_cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("trace", [False, True])
def test_added_traffic_file_makes_a_cell(tmp_path, trace):
    root = tiny_cells.make_root(tmp_path)
    data = root / "gnnbench"
    added = {data / "traffic" / "tiny.json"} | {
        data / "limits" / f"{tiny_cells.cell_name(c)}.json"
        for c in ("gcn-ogbn-products", "sage-mean-ogbn-products")}
    for path in data.rglob("*.json"):
        if path not in added:
            original = harness.PACKAGE / path.relative_to(data)
            assert path.read_bytes() == original.read_bytes(), path
    cell = tiny_cells.tiny_cell(root)
    result = harness.run(cell, 17, 1.0, trace, "cpu", 0.0,
                         trace_dir=tmp_path / "traces")
    assert result["correct"] is True and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in cell.metrics[kind]}
    assert set(result["metrics"]) <= names
    if not trace:  # the CPU has no device trace to read
        assert {"step_ms", "step_ms_p90", "setup_s"} <= set(result["metrics"])


def test_unknown_workload_names_the_cells():
    with pytest.raises(KeyError, match="gcn-products.powerlaw"):
        harness.find_cell(harness.load_bench(), "no-such-cell")


def test_benchmark_json_keeps_to_the_contract():
    bench = harness.load_bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gnnbench"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and set(c) == {
            "name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gnnbench/")
        assert (harness.REPO / c["file"]).is_file()
        assert json.loads((harness.REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        cell = harness.find_cell(bench, w["name"])
        assert cell.limits and set(cell.limits) <= {
            "loss1_gap", "grad1_gap", "grad1_worst_gap", "update3_gap"}
        reported = {m["name"] for m in cell.metrics["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.metrics["per_layer"]
        for m in cell.metrics["per_layer"]:
            assert m["moves"] in reported, (w["name"], m["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (harness.PACKAGE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(json.dumps(bench)) < 64 * 1024
    for path in harness.PACKAGE.rglob("*"):
        if "__pycache__" in path.parts or "_traces" in path.parts:
            continue
        rel = path.relative_to(harness.REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
