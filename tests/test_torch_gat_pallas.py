"""Port parity: ``GAT(method="pallas"|"scatter"|"dense")``, the composed chain.

Any method other than ``auto``/``tiled`` runs the composed attention chain,
as in the JAX package: additive logits, leaky ReLU and edge softmax on the
edge ops' ``auto`` tier, then ``spmm(adj.with_data(alpha), h,
method=method)``: for ``"pallas"`` over a ``plan="perrow"`` adjacency (the
chunk kernel's plain version on the CPU), for ``"scatter"`` and ``"dense"``
their plain tiers.  The reference is the JAX GAT's composed chain on
``method="xla"``, the same function (the JAX ``"pallas"`` tier runs only on
a TPU).  A small SBM graph
(3 x 20 nodes, 16 features) with self-loops, dims [16, 8, 3], 1 and 2 heads,
a small chunk plan (R, E) = (8, 8) so that rows span chunks.  Logits within
1e-5·max|ref| + 1e-6, parameter gradients within 1e-4·max(|ref|, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gespmm_tpu.models.gat import GAT as JGAT
from gespmm_tpu.ops import graph as jgraph
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.utils import datasets as jds

from gespmm_tpu_torch.models.common import params_from_jax
from gespmm_tpu_torch.models.gat import GAT as TGAT
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.utils import datasets as tds

DIMS = [16, 8, 3]
SBM = dict(n_per_class=20, num_classes=3, p_in=0.15, p_out=0.02, feat_dim=16,
           seed=0)


@pytest.fixture(scope="module")
def problem():
    jd, td = jds.sbm_graph(**SBM), tds.sbm_graph(**SBM)
    jadj = JAdjacency.from_csr(jgraph.add_self_loops(jd.csr))
    tadj = TAdjacency.from_csr(tgraph.add_self_loops(td.csr), plan="perrow",
                               rows_per_block=8, chunk_nnz=8)
    return jd, td, jadj, tadj


@pytest.mark.parametrize("method", ["pallas", "scatter", "dense"])
@pytest.mark.parametrize("heads", [1, 2])
def test_gat_pallas_matches_jax_composed_chain(problem, heads, method):
    jd, td, jadj, tadj = problem
    jmodel = JGAT(DIMS, dropout_rate=0.0, method="xla", heads=heads)
    params = jmodel.init(jax.random.PRNGKey(heads))
    G = np.random.default_rng(heads).standard_normal((60, 3)).astype(
        np.float32)

    def jloss(p):
        return jnp.sum(jmodel.apply(p, jadj, jd.features) * G)

    want = jmodel.apply(params, jadj, jd.features)
    jgrads = params_from_jax(jax.grad(jloss)(params))
    model = TGAT(DIMS, dropout_rate=0.0, method=method, heads=heads)
    model.load_state_dict(params_from_jax(params))
    out = model(tadj, td.features)
    got, ref = out.detach().numpy().astype(np.float64), np.asarray(want)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max() + 1e-6
    (out * torch.from_numpy(G)).sum().backward()
    for k, p in model.named_parameters():
        ref = jgrads[k].numpy().astype(np.float64)
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1.0), k


def test_gat_pallas_needs_a_chunk_plan(problem):
    _, td, _, _ = problem
    plain = TAdjacency.from_csr(tgraph.add_self_loops(td.csr))
    with pytest.raises(ValueError, match="plan='perrow'"):
        TGAT(DIMS, method="pallas")(plain, td.features)
