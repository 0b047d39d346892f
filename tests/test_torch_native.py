"""The port's native graph-IO loader against the JAX package's and the
port's NumPy paths.

``gespmm_tpu_torch/utils/native.py`` builds its own library from
``native/graphio.cpp`` into ``gespmm_tpu_torch/_build/``; the JAX package's
loader builds ``native/libgespmm_io.so``.  Both come from one source, so the
parser, COO -> CSR, CSR -> CSC and Fennel must give equal arrays; and the
port's native paths (``read_mtx``, ``Adjacency.from_csr``'s CSC transform)
must give exactly what its NumPy paths give.  ``use_native=True`` without a
library raises instead of taking the NumPy path.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.sparse import io as jio
from gespmm_tpu.utils import native as jnative
from gespmm_tpu_torch.ops.spmm import Adjacency
from gespmm_tpu_torch.sparse import io as tio
from gespmm_tpu_torch.sparse import reorder as treorder
from gespmm_tpu_torch.sparse.formats import csr_from_scipy
from gespmm_tpu_torch.utils import datasets as tds
from gespmm_tpu_torch.utils import native as tnative

pytestmark = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="a native library is unavailable (no g++?)")


def _mtx(tmp_path, kind):
    """A symmetric file with a duplicate and a self-loop, a general one with
    duplicates, or a pattern one."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / f"{kind}.mtx")
    if kind == "symmetric":
        row = np.array([1, 2, 2, 0, 3, 2, 5])
        col = np.array([0, 0, 1, 0, 3, 0, 4])
        val = np.array([1.0, 2.0, 3.0, 9.0, 4.0, 7.5, -0.25], np.float32)
        tio.write_mtx(path, row, col, val, (6, 6), symmetry="symmetric")
    elif kind == "general":
        row = rng.integers(0, 40, 120)
        col = rng.integers(0, 30, 120)
        row[-5:], col[-5:] = row[:5], col[:5]  # duplicates
        val = rng.standard_normal(120).astype(np.float32)
        tio.write_mtx(path, row, col, val, (40, 30))
    else:
        tio.write_mtx(path, rng.integers(0, 20, 50), rng.integers(0, 20, 50),
                      None, (20, 20))
    return path


@pytest.mark.parametrize("kind", ["symmetric", "general", "pattern"])
def test_native_reader_matches_jax_and_numpy(tmp_path, kind):
    path = _mtx(tmp_path, kind)
    for kw in ({}, {"symmetrize": True}, {"symmetrize": False,
                                          "remove_self_loops": False}):
        t_nat = tnative.read_mtx_native(path, **kw)
        j_nat = jnative.read_mtx_native(path, **kw)
        for got, want in zip(t_nat[:3], j_nat[:3]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert t_nat[3] == j_nat[3]
        nat = tio.read_mtx(path, use_native=True, **kw)
        py = tio.read_mtx(path, use_native=False, **kw)
        default = tio.read_mtx(path, **kw)
        assert nat.shape == py.shape == default.shape == t_nat[3]
        for f in ("row", "col", "data"):
            np.testing.assert_array_equal(getattr(nat, f).numpy(),
                                          getattr(py, f).numpy())
            np.testing.assert_array_equal(getattr(default, f).numpy(),
                                          getattr(py, f).numpy())
            assert getattr(nat, f).dtype == getattr(py, f).dtype


def test_native_coo_to_csr_and_csr_to_csc_match_jax():
    csr = tds.rmat_graph(9, edge_factor=8, seed=1)
    indptr, indices = csr.indptr.numpy(), csr.indices.numpy()
    rows = np.repeat(np.arange(csr.shape[0], dtype=np.int32), np.diff(indptr))
    got = tnative.coo_to_csr_native(rows, csr.shape[0])
    np.testing.assert_array_equal(got, jnative.coo_to_csr_native(rows,
                                                                 csr.shape[0]))
    np.testing.assert_array_equal(got, indptr)
    m, n = csr.shape
    for got, want in zip(tnative.csr_to_csc_native(indptr, indices, m, n),
                         jnative.csr_to_csc_native(indptr, indices, m, n)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["rmat", "rect"])
def test_adjacency_csc_native_equals_numpy(name):
    if name == "rmat":
        csr = tds.rmat_graph(9, edge_factor=8, seed=2)
    else:  # rectangular, valued, with empty rows and columns
        mat = sp.random(50, 70, density=0.05, format="csr",
                        random_state=np.random.default_rng(4),
                        dtype=np.float32)
        mat.sort_indices()
        csr = csr_from_scipy(mat)
    a = Adjacency.from_csr(csr, device="cpu", use_native=True)
    b = Adjacency.from_csr(csr, device="cpu", use_native=False)
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a.csc, f), getattr(b.csc, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype
            assert torch.equal(x, y), f
    for f in ("perm", "inv_perm", "rows_t"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.split_t.seg_row, b.split_t.seg_row)


@pytest.mark.parametrize("parts", (2, 4, 8))
def test_native_fennel_matches_jax(parts):
    csr = tds.rmat_graph(9, edge_factor=8, seed=0)
    indptr, indices = csr.indptr.numpy(), csr.indices.numpy()
    for kw in ({}, {"slack": 0.0}, {"gamma": 1.3, "passes": 2}):
        got = tnative.fennel_partition_native(indptr, indices, parts, **kw)
        np.testing.assert_array_equal(
            got, jnative.fennel_partition_native(indptr, indices, parts, **kw))
        np.testing.assert_array_equal(
            got, treorder.fennel_partition(csr, parts, use_native=True, **kw))


def test_library_lives_under_the_ports_build_dir():
    lib = tnative.library_path()
    assert lib.parent == tnative.PKG_DIR / "_build"
    assert lib.parent.name == "_build" and lib.parent.parent.name == \
        "gespmm_tpu_torch"
    assert tnative.build() == lib and lib.exists()
    assert tnative.SOURCE.name == "graphio.cpp"
    assert tnative.SOURCE.parent.name == "native"
    assert tnative.error() is None


def test_use_native_true_without_the_library_raises(tmp_path, monkeypatch):
    path = _mtx(tmp_path, "general")
    csr = tds.rmat_graph(6, edge_factor=4, seed=0)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    monkeypatch.setattr(tnative, "_ERROR", "g++: not here")
    assert not tnative.available()
    for call in (lambda: tio.read_mtx(path, use_native=True),
                 lambda: Adjacency.from_csr(csr, device="cpu",
                                            use_native=True),
                 lambda: treorder.fennel_partition(csr, 2, use_native=True)):
        with pytest.raises(tnative.NativeUnavailable, match="g\\+\\+: not here"):
            call()
    # None takes the NumPy path without the library.
    py = tio.read_mtx(path, use_native=False)
    assert torch.equal(tio.read_mtx(path).row, py.row)
    np.testing.assert_array_equal(
        treorder.fennel_partition(csr, 2),
        treorder.fennel_partition(csr, 2, use_native=False))


def test_failed_build_reports_the_compiler_stderr(tmp_path, monkeypatch):
    bad = tmp_path / "graphio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(tnative.NativeUnavailable, match="g\\+\\+ failed"):
        tnative.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_bad_file_native_true_raises_mtx_format_error(tmp_path):
    path = str(tmp_path / "bad.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    with pytest.raises(tio.MtxFormatError, match="banner"):
        tio.read_mtx(path, use_native=True)
    with pytest.raises(tio.MtxFormatError):  # the NumPy reader's refusal
        tio.read_mtx(path)
