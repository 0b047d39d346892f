"""Port parity: the sharded tier's partition pre-pass, against the JAX package.

``fennel_partition``, ``partition_order``, ``halo_need_stats`` and
``bandwidth_stats`` of ``gespmm_tpu_torch/sparse/reorder.py`` against
``gespmm_tpu/sparse/reorder.py`` on an SBM graph and an R-MAT graph.  Labels
and permutations must be equal exactly, on both paths: the NumPy loops
against each other (the JAX package's native entry patched to None, so that
it takes its loop; its source is not touched), and the native loops against
each other (both libraries are built from ``native/graphio.cpp``).
"""

import numpy as np
import pytest
import torch

from gespmm_tpu.sparse import reorder as jreorder
from gespmm_tpu.utils import datasets as jds
from gespmm_tpu.utils import native as jnative

from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse import reorder as treorder
from gespmm_tpu_torch.utils import native as tnative

SBM = dict(n_per_class=40, num_classes=3, p_in=0.1, p_out=0.01, feat_dim=4,
           seed=0)
GRAPHS = {
    "sbm": lambda: jds.sbm_graph(**SBM).csr,
    "rmat": lambda: jds.rmat_graph(scale=8, edge_factor=8, seed=0),
}
PARTS = (2, 4, 8)

needs_native = pytest.mark.skipif(
    not (jnative.available() and tnative.available()),
    reason="a native library is unavailable (no g++?)")


def to_port(jcsr) -> tf.CSR:
    return tf.CSR(torch.tensor(np.asarray(jcsr.indptr)),
                  torch.tensor(np.asarray(jcsr.indices)),
                  None if jcsr.data is None
                  else torch.tensor(np.asarray(jcsr.data)), jcsr.shape)


@pytest.fixture
def jax_loop(monkeypatch):
    """The JAX package's Fennel takes its NumPy loop."""
    monkeypatch.setattr(jnative, "fennel_partition_native",
                        lambda *a, **k: None)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fennel_loop_labels_match_jax(name, parts, jax_loop):
    jcsr = GRAPHS[name]()
    for kw in ({}, {"slack": 0.0, "seed": 3}, {"passes": 1, "gamma": 1.2}):
        want = jreorder.fennel_partition(jcsr, parts, **kw)
        got = treorder.fennel_partition(to_port(jcsr), parts, use_native=False,
                                        **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


@needs_native
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fennel_native_labels_match_jax(name, parts):
    jcsr = GRAPHS[name]()
    for kw in ({}, {"slack": 0.0}, {"passes": 1, "gamma": 1.2}):
        want = jreorder.fennel_partition(jcsr, parts, **kw)
        got = treorder.fennel_partition(to_port(jcsr), parts, **kw)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
        np.testing.assert_array_equal(
            treorder.fennel_partition(to_port(jcsr), parts, use_native=True,
                                      **kw), want)


@pytest.mark.parametrize("method", ["auto", "fennel", "random", "none"])
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_order_matches_jax(name, parts, method):
    """The default paths (native Fennel on both sides where available)."""
    jcsr = GRAPHS[name]()
    want = jreorder.partition_order(jcsr, parts, method=method, seed=1)
    got = treorder.partition_order(to_port(jcsr), parts, method=method, seed=1)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(jcsr.shape[0]))


@pytest.mark.parametrize("method", ["auto", "fennel"])
@pytest.mark.parametrize("parts", (2, 4))
def test_partition_order_loop_matches_jax(parts, method, jax_loop):
    """The NumPy loop on both sides, through the balancing pass."""
    jcsr = GRAPHS["sbm"]()
    want = jreorder.partition_order(jcsr, parts, method=method)
    got = treorder.partition_order(to_port(jcsr), parts, method=method,
                                   use_native=False)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_stats_match_jax(name, parts):
    jcsr = GRAPHS[name]()
    perm = jreorder.partition_order(jcsr, parts, method="random")
    for j, t in ((jcsr, to_port(jcsr)),
                 (jreorder.apply_permutation(jcsr, perm),
                  treorder.apply_permutation(to_port(jcsr), perm))):
        want = jreorder.halo_need_stats(j, parts)
        got = treorder.halo_need_stats(t, parts)
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got.pop("need"), want.pop("need"))
        assert got == want
        for rows in (16, 64):
            assert treorder.bandwidth_stats(t, rows) == \
                jreorder.bandwidth_stats(j, rows)


def test_attachment_matches_the_per_node_count():
    """The vectorised attachment of the balancing pass against JAX's
    per-node generator."""
    jcsr = GRAPHS["rmat"]()
    indptr = np.asarray(jcsr.indptr).astype(np.int64)
    indices = np.asarray(jcsr.indices)
    labels = np.random.default_rng(0).integers(0, 4, jcsr.shape[0])
    for p in range(4):
        cand = np.flatnonzero(labels == (p + 1) % 4)
        want = [int(np.count_nonzero(labels[indices[indptr[v]:indptr[v + 1]]]
                                     == p)) for v in cand]
        np.testing.assert_array_equal(
            treorder._attachment(indptr, indices, labels, cand, p), want)


def test_refusals_match_jax():
    rect = jds.bipartite_graph(6, 9, row_degree=2, seed=0)
    for fn in ("fennel_partition",):
        with pytest.raises(ValueError) as je:
            getattr(jreorder, fn)(rect, 2)
        with pytest.raises(ValueError) as te:
            getattr(treorder, fn)(to_port(rect), 2)
        assert str(te.value) == str(je.value)
    sq = GRAPHS["sbm"]()
    with pytest.raises(ValueError) as je:
        jreorder.partition_order(sq, 2, method="metis")
    with pytest.raises(ValueError) as te:
        treorder.partition_order(to_port(sq), 2, method="metis")
    assert str(te.value) == str(je.value)
    np.testing.assert_array_equal(treorder.fennel_partition(to_port(sq), 1),
                                  jreorder.fennel_partition(sq, 1))
