"""Port parity: RCM/degree/BFS reordering, against the JAX package.

The same graphs (``tests/conftest.py``'s ``random_csr`` and
``powerlaw_csr``, made square, and a small SBM graph) go through
``gespmm_tpu.sparse.reorder`` and ``gespmm_tpu_torch.sparse.reorder``; the
permutations and the permuted CSR arrays must be equal exactly (both run
the same NumPy and scipy code on the host).
"""

import numpy as np
import pytest
import torch

from gespmm_tpu.sparse import reorder as jreorder
from gespmm_tpu.utils import datasets as jds
from tests.conftest import powerlaw_csr, random_csr

from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse import reorder as treorder
from gespmm_tpu_torch.utils import datasets as tds

SBM = dict(n_per_class=40, num_classes=3, p_in=0.1, p_out=0.01, feat_dim=4,
           seed=0)
GRAPHS = {
    "random": lambda: random_csr(60, 60, density=0.05, seed=1)[0],
    "binary": lambda: random_csr(50, 50, density=0.04, seed=2, binary=True)[0],
    "powerlaw": lambda: powerlaw_csr(64, 64, avg_deg=6, seed=3)[0],
    "sbm": lambda: jds.sbm_graph(**SBM).csr,
}


def to_port(jcsr) -> tf.CSR:
    return tf.CSR(torch.tensor(np.asarray(jcsr.indptr)),
                  torch.tensor(np.asarray(jcsr.indices)),
                  None if jcsr.data is None
                  else torch.tensor(np.asarray(jcsr.data)), jcsr.shape)


@pytest.mark.parametrize("method", ["rcm", "degree", "bfs"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_permutation_and_permuted_csr_match_jax(name, method):
    jcsr = GRAPHS[name]()
    tcsr = to_port(jcsr)
    jperm = np.asarray(jreorder.reorder_permutation(jcsr, method))
    tperm = treorder.reorder_permutation(tcsr, method)
    np.testing.assert_array_equal(tperm, jperm)
    assert sorted(tperm.tolist()) == list(range(jcsr.shape[0]))
    jr, jp = jreorder.reorder(jcsr, method)
    tr, tp = treorder.reorder(tcsr, method)
    np.testing.assert_array_equal(tp, jp)
    assert tr.shape == jr.shape and tr.indptr.dtype == torch.int32
    np.testing.assert_array_equal(tr.indptr.numpy(), np.asarray(jr.indptr))
    np.testing.assert_array_equal(tr.indices.numpy(), np.asarray(jr.indices))
    if jr.data is None:
        assert tr.data is None
    else:
        np.testing.assert_array_equal(tr.data.numpy(), np.asarray(jr.data))
    np.testing.assert_array_equal(treorder.inverse_permutation(tp),
                                  jreorder.inverse_permutation(jp))


def test_sbm_generator_matches_jax():
    # The SBM graph above is the JAX generator's; the port's is the same.
    jcsr, tcsr = GRAPHS["sbm"](), tds.sbm_graph(**SBM).csr
    np.testing.assert_array_equal(tcsr.indices.numpy(), np.asarray(jcsr.indices))


def test_reorder_permutes_the_matrix():
    jcsr = GRAPHS["random"]()
    tcsr = to_port(jcsr)
    dense = tcsr.todense().numpy()
    tr, perm = treorder.reorder(tcsr, "rcm")
    np.testing.assert_array_equal(tr.todense().numpy(), dense[perm][:, perm])
    inv = treorder.inverse_permutation(perm)
    np.testing.assert_array_equal(tr.todense().numpy()[inv][:, inv], dense)


@pytest.mark.parametrize("case", ["non-square", "unknown method"])
def test_refusals_match_jax(case):
    if case == "non-square":
        jcsr, method, match = random_csr(30, 20, seed=4)[0], "rcm", "square"
    else:
        jcsr, method, match = GRAPHS["random"](), "metis", "unknown"
    with pytest.raises(ValueError, match=match):
        treorder.reorder_permutation(to_port(jcsr), method)
    with pytest.raises(ValueError, match=match):
        jreorder.reorder_permutation(jcsr, method)
