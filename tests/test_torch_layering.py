"""The port's layering, read from each module's imports with ``ast``.

A kernel wrapper (``gespmm_tpu_torch/kernels/``) launches kernels and routes
a CPU tensor to the plain reference; it imports no op (``ops.spmm``,
``ops.graph``) and no model.  A model (``gespmm_tpu_torch/models/``) reaches
the kernels only through ``ops/``.  Nothing is imported to check this.
"""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "gespmm_tpu_torch"
# What a module of each layer may not import: the module, or any under it.
BANNED = {
    "kernels": ("gespmm_tpu_torch.ops.spmm", "gespmm_tpu_torch.ops.graph",
                "gespmm_tpu_torch.models"),
    "models": ("gespmm_tpu_torch.kernels",),
}
MODULES = sorted(p for layer in BANNED for p in (PKG / layer).glob("*.py"))


def imported(path: Path, package: str):
    """Every module ``path`` imports, and each name it takes from a module
    as ``module.name``; relative imports resolved against ``package``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                parts = parts[:len(parts) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_layer_imports_only_what_it_may(path):
    layer = path.parent.name
    bad = [mod for mod in imported(path, f"gespmm_tpu_torch.{layer}")
           for banned in BANNED[layer]
           if mod == banned or mod.startswith(banned + ".")]
    assert not bad, f"{layer}/{path.name} imports {bad}"


def test_the_reader_sees_every_form_of_import(tmp_path):
    # The check above is only as good as ``imported``: each way of writing
    # an import of ops.spmm must be seen.
    forms = ("import gespmm_tpu_torch.ops.spmm\n",
             "from gespmm_tpu_torch.ops.spmm import Adjacency\n",
             "from gespmm_tpu_torch.ops import spmm\n",
             "from ..ops import spmm\n",
             "def f():\n    from ..ops.spmm import spmm\n")
    for i, src in enumerate(forms):
        path = tmp_path / f"m{i}.py"
        path.write_text(src)
        assert "gespmm_tpu_torch.ops.spmm" in set(
            imported(path, "gespmm_tpu_torch.kernels")), src
