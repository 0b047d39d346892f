"""The generator: exact node and nonzero counts, symmetry, no repeats,
determinism from the seed, and the inputs' sizes."""

import json

import pytest
import torch

from gnnbench import graphgen, harness
from gnnbench.tests.tiny_cells import TINY_TRAFFIC

CONFIG = {"in_features": 100, "num_classes": 47}


def _pairs(g):
    deg = (g.indptr[1:] - g.indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(g.n), deg), g.indices.long()


@pytest.mark.parametrize("self_loops", [False, True])
def test_counts_symmetry_and_no_repeats(self_loops):
    g = graphgen.make_graph(TINY_TRAFFIC, 2**31 + 7, "cpu", self_loops)
    n, e = TINY_TRAFFIC["nodes"], TINY_TRAFFIC["undirected_edges"]
    assert g.n == n and g.indptr.shape == (n + 1,)
    assert g.nnz == 2 * e + (n if self_loops else 0)
    assert g.indptr.dtype == g.indices.dtype == torch.int32
    rows, cols = _pairs(g)
    keys = rows * n + cols
    assert torch.all(keys[1:] > keys[:-1])  # sorted rows, no repeats
    assert int((rows == cols).sum()) == (n if self_loops else 0)
    transposed = torch.sort(cols * n + rows).values
    assert torch.equal(transposed, keys)  # symmetric


def test_same_seed_same_graph_other_seed_other_graph():
    a = graphgen.make_graph(TINY_TRAFFIC, 123, "cpu", False)
    b = graphgen.make_graph(TINY_TRAFFIC, 123, "cpu", False)
    c = graphgen.make_graph(TINY_TRAFFIC, 124, "cpu", False)
    assert torch.equal(a.indptr, b.indptr) and torch.equal(a.indices, b.indices)
    assert not torch.equal(a.indices, c.indices)


def test_degrees_are_heavy_tailed():
    traffic = dict(TINY_TRAFFIC, nodes=4000, undirected_edges=40000)
    g = graphgen.make_graph(traffic, 5, "cpu", False)
    deg = (g.indptr[1:] - g.indptr[:-1]).float()
    assert float(deg.max()) > 8 * float(deg.median())


def test_inputs_sizes_and_determinism():
    n = TINY_TRAFFIC["nodes"]
    a = graphgen.make_inputs(TINY_TRAFFIC, CONFIG, n, 99, "cpu")
    b = graphgen.make_inputs(TINY_TRAFFIC, CONFIG, n, 99, "cpu")
    assert a.x.shape == (n, 100) and a.labels.shape == (n,)
    assert int(a.labels.max()) < 47 and int(a.labels.min()) >= 0
    assert int(a.train_mask.sum()) == TINY_TRAFFIC["train_nodes"]
    assert torch.equal(a.x, b.x) and torch.equal(a.train_mask, b.train_mask)


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40, -3])
def test_sub_seeds_take_any_whole_number(seed):
    s = graphgen.sub_seed(seed, "graph")
    assert 0 <= s < 2**63 and s != graphgen.sub_seed(seed, "inputs")
    torch.Generator().manual_seed(s)


@pytest.mark.parametrize("name,nnz,loops", [
    ("powerlaw", 123_718_280, 126_167_309),
])
def test_traffic_files_state_the_published_sizes(name, nnz, loops):
    t = json.loads((harness.PACKAGE / "traffic" / f"{name}.json").read_text())
    assert 2 * t["undirected_edges"] == nnz
    assert 2 * t["undirected_edges"] + t["nodes"] == loops
