"""A copy of the benchmark's data files in a temporary root, with a tiny
traffic mix and one cell of it for each configuration, added as new files
and new entries alone, so that the harness runs on the CPU in a test."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from gnnbench import harness

TINY_TRAFFIC = {
    "name": "tiny",
    "about": "a test's graph: 300 nodes, 1,500 undirected edges",
    "nodes": 300,
    "undirected_edges": 1500,
    "train_nodes": 60,
    "degree_law": {"kind": "chung_lu", "gamma": 2.3, "hub_offset": 5},
}
# The cell whose limits the tiny cells take.
LIMITS_OF = "gcn-products.powerlaw"


def cell_name(config: str) -> str:
    return f"{config}.tiny"


def make_root(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and ``gnnbench/{configs,traffic,
    limits}`` as the repository has them, plus the tiny traffic file, a
    tiny cell a configuration and its limits file."""
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(harness.PACKAGE / sub, tmp / "gnnbench" / sub)
    (tmp / "gnnbench" / "traffic" / "tiny.json").write_text(
        json.dumps(TINY_TRAFFIC))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    limits = (harness.PACKAGE / "limits" / f"{LIMITS_OF}.json").read_text()
    added = []
    for config in bench["configs"]:
        name = cell_name(config["name"])
        bench["workloads"].append({"name": name, "config": config["name"],
                                   "traffic": "tiny", "chips": 1,
                                   "why": "a test's tiny cell"})
        (tmp / "gnnbench" / "limits" / f"{name}.json").write_text(limits)
        added.append(name)
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"] = m["workloads"] + added
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def tiny_cell(root: Path, config: str = "gcn-ogbn-products") -> harness.Cell:
    return harness.find_cell(harness.load_bench(root), cell_name(config), root)
