"""No JAX in a run, no program in the reference, and no result without a
card or without the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from gnnbench import harness, importcheck

REF_DIR = harness.PACKAGE / "reference"


def _python(code, cwd=harness.REPO):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_forbidden_compares_whole_top_level_names():
    names = ["gespmm_tpu_torch", "gespmm_tpu_torch.ops.spmm", "jaxtyping",
             "gespmm_tpu", "gespmm_tpu.ops", "jax.numpy", "jaxlib", "flax.linen",
             "torch"]
    assert importcheck.forbidden(names) == [
        "flax.linen", "gespmm_tpu", "gespmm_tpu.ops", "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    """A whole run of a tiny cell on the CPU, in a fresh process."""
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from gnnbench import harness, importcheck\n"
        "from gnnbench.tests import tiny_cells\n"
        f"root = tiny_cells.make_root(Path({str(tmp_path)!r}))\n"
        "r = harness.run(tiny_cells.tiny_cell(root), 1, 0.1, False, 'cpu', 0.0)\n"
        "print(json.dumps({'correct': r['correct'], "
        "'forbidden': importcheck.forbidden(), "
        "'program': 'gespmm_tpu_torch' in sys.modules}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "program": True}


def test_reference_loads_no_program():
    code = (
        "import sys\n"
        "import gnnbench.reference.common, gnnbench.reference.gcn, "
        "gnnbench.reference.sage\n"
        "from gnnbench import importcheck\n"
        "banned = importcheck.FORBIDDEN | {'gespmm_tpu_torch'}\n"
        "print(importcheck.forbidden(banned=banned))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(REF_DIR.glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch_and_the_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top in {"__future__", "dataclasses", "math", "typing",
                           "torch"} or mod.startswith("gnnbench.reference"), mod


def test_no_card_no_result():
    """On a machine without a card the run exits 2 and prints nothing."""
    code = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from gnnbench import run\n"
        "sys.exit(run.main(['--workload', 'gcn-products.powerlaw', "
        "'--seed', '1', '--seconds', '1', '--trace', '0']))\n")
    out = _python(code)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A checkout of BENCHMARK.json and gnnbench/ alone."""
    import shutil

    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PACKAGE, tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_traces"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "gnnbench.run", "--workload",
         "gcn-products.powerlaw", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
