"""Port parity: the grouped plan, ``spmm`` over it and the GCN on a reordered
graph, against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
``spmm_grouped`` runs in interpret mode, as ``tests/test_pallas.py`` runs
it, once per case in a module fixture; JAX's ``spmm(method="pallas")``
itself cannot run on the CPU (it launches the TPU kernel), so the port's op
is held to the JAX kernel over ``plan`` and, for grad_B, over ``plan_t``.
The port runs on the CPU here, i.e. through the grouped kernel's plain
version, which walks the plan's group ids and slots; a pure-Python walk of
the kernel's work list (``tests/test_torch_pallas.py``'s, reading B through
the slots) checks the row lists and carry slots, which only the CUDA kernel
reads.  The kernel itself is checked in
``tests/test_torch_cuda.py``.

Tolerance: rtol/atol 1e-5 (both sides accumulate in f32, in different
orders), 1e-4 on the power-law graph (rows of hundreds of edges), as in
``tests/test_pallas.py``; the GCN's logits within 1e-4 x max |ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gespmm_tpu.kernels.spmm_grouped import spmm_grouped as jspmm_grouped
from gespmm_tpu.models.gcn import GCN as JGCN
from gespmm_tpu.ops import graph as jgraph
from gespmm_tpu.ops.sddmm import sddmm as jsddmm
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.sparse import reorder as jreorder
from gespmm_tpu.sparse.partition import build_grouped_plan as jbuild
from gespmm_tpu.utils import datasets as jds
from tests.conftest import powerlaw_csr, random_csr
from tests.test_torch_pallas import walk as chunk_walk

import gespmm_tpu_torch.ops.spmm as tops
from gespmm_tpu_torch.kernels import spmm_grouped as kg
from gespmm_tpu_torch.models.gcn import GCN as TGCN
from gespmm_tpu_torch.models.gcn import params_from_jax
from gespmm_tpu_torch.ops import graph as tgraph
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.ops.spmm import spmm as tspmm
from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse.partition import (GroupedSpmmPlan,
                                                build_grouped_plan)
from gespmm_tpu_torch.sparse.reorder import reorder
from gespmm_tpu_torch.utils import datasets as tds

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_POWERLAW = dict(rtol=1e-4, atol=1e-4)
SMALL = (8, 16, 8, 8)  # tests/test_pallas.py's (R, E, NG, G)
SBM = dict(n_per_class=100, num_classes=3, p_in=0.05, p_out=0.005,
           feat_dim=16, seed=0)


def to_port(jcsr) -> tf.CSR:
    return tf.CSR(torch.tensor(np.asarray(jcsr.indptr)),
                  torch.tensor(np.asarray(jcsr.indices)),
                  None if jcsr.data is None
                  else torch.tensor(np.asarray(jcsr.data)), jcsr.shape)


def hub_csr():
    """One row of 500 edges among short rows: many chunks, one cut row."""
    from gespmm_tpu.sparse.formats import csr_from_scipy
    import scipy.sparse as sp

    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(0, 4, 12), 500, rng.integers(0, 4, 12)]
    n = 1200
    cols = np.concatenate([np.sort(rng.choice(n, d, replace=False))
                           for d in deg])
    indptr = np.r_[0, np.cumsum(deg)]
    mat = sp.csr_matrix((rng.standard_normal(cols.shape[0]).astype(np.float32),
                         cols, indptr), shape=(deg.shape[0], n))
    return csr_from_scipy(mat), mat


def empty_block_csr():
    """Rows 8-23 without edges: with R = 8, two blocks of one empty chunk."""
    jcsr, mat = random_csr(40, 30, density=0.2, seed=6)
    mat = mat.tolil()
    mat[8:24, :] = 0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    from gespmm_tpu.sparse.formats import csr_from_scipy

    return csr_from_scipy(mat), mat


def sbm_loops():
    from gespmm_tpu.sparse.formats import csr_from_scipy
    import scipy.sparse as sp

    c = jgraph.add_self_loops(jds.sbm_graph(**SBM).csr)
    mat = sp.csr_matrix((np.asarray(c.data), np.asarray(c.indices),
                         np.asarray(c.indptr)), shape=c.shape)
    return csr_from_scipy(mat), mat


GRAPHS = {
    "random": (lambda: random_csr(60, 50, density=0.12, seed=1), SMALL),
    "binary": (lambda: random_csr(60, 50, density=0.12, seed=1, binary=True),
               SMALL),
    "powerlaw": (lambda: powerlaw_csr(80, 64, avg_deg=8, seed=2), SMALL),
    "narrow": (lambda: random_csr(40, 40, density=0.15, seed=3), (8, 16, 4, 8)),
    "hub": (hub_csr, SMALL),
    "empty_block": (empty_block_csr, SMALL),
    "sbm_defaults": (sbm_loops, (64, 64, 32, 8)),
    "sbm_g1": (sbm_loops, (64, 64, 64, 1)),
}


def plan_kw(sizes):
    R, E, NG, G = sizes
    return dict(rows_per_block=R, edges_per_chunk=E, groups_per_chunk=NG,
                group_rows=G)


def staged_row(plan: GroupedSpmmPlan, c: int, slot: int) -> int:
    """The B row that staged row ``slot`` of chunk c holds."""
    G = plan.group_rows
    assert slot // G < int(plan.group_count[c])
    return int(plan.groups[c, slot // G]) * G + slot % G


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_matches_jax(name):
    make, sizes = GRAPHS[name]
    jcsr, _ = make()
    jp = jbuild(jcsr, **plan_kw(sizes))
    tp = build_grouped_plan(to_port(jcsr), **plan_kw(sizes))
    R = sizes[0]
    assert (tp.num_chunks, tp.num_blocks, tp.groups_per_chunk) == (
        jp.num_chunks, jp.num_blocks, jp.groups_per_chunk)
    assert tp.dedup_factor == pytest.approx(jp.dedup_factor, rel=1e-12)
    np.testing.assert_array_equal(tp.block_ids.numpy(), np.asarray(jp.block_ids))
    np.testing.assert_array_equal(tp.first.numpy(), np.asarray(jp.first))
    # Both pad a chunk's group list with group 0.
    np.testing.assert_array_equal(tp.groups.numpy(), np.asarray(jp.groups))
    src, lr = np.asarray(jp.src), np.asarray(jp.local_rows)
    jslots = np.asarray(jp.slots)
    starts, counts = tp.chunk_start.numpy(), tp.chunk_count.numpy()
    slots, gcount = tp.slots.numpy(), tp.group_count.numpy()
    for c in range(tp.num_chunks):
        real = lr[c] < R
        edges = np.arange(starts[c], starts[c] + counts[c])
        np.testing.assert_array_equal(edges, src[c][real])
        np.testing.assert_array_equal(slots[edges], jslots[c][real])
        # The chunk's own groups: exactly those its edges read.
        assert gcount[c] == len(np.unique(slots[edges] // sizes[3]))
    assert int(tp.chunk_count.max()) <= sizes[1]
    assert tp.staged_rows == int(gcount.sum()) * sizes[3]
    cols = tp.indices.numpy()
    for c in range(tp.num_chunks):
        for e in range(starts[c], starts[c] + counts[c]):
            assert staged_row(tp, c, int(slots[e])) == cols[e]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_referenced_rows_match_a_numpy_recount(name):
    """The rows the kernel stages: each chunk's distinct columns, in the
    order of their slots, and every edge's index among them."""
    make, sizes = GRAPHS[name]
    tp = build_grouped_plan(to_port(make()[0]), **plan_kw(sizes))
    cols, slots = tp.indices.numpy(), tp.slots.numpy()
    starts, counts = tp.chunk_start.numpy(), tp.chunk_count.numpy()
    ptr, rows = tp.ref_ptr.numpy(), tp.ref_rows.numpy()
    ref_slot = tp.ref_slot.numpy()
    assert ptr[0] == 0 and ptr[-1] == tp.referenced_rows == rows.shape[0]
    for c in range(tp.num_chunks):
        e = np.arange(starts[c], starts[c] + counts[c])
        distinct = np.unique(slots[e])  # slot order
        want = [staged_row(tp, c, int(q)) for q in distinct]
        np.testing.assert_array_equal(rows[ptr[c]:ptr[c + 1]], want)
        np.testing.assert_array_equal(ref_slot[e],
                                      np.searchsorted(distinct, slots[e]))
        np.testing.assert_array_equal(rows[ptr[c] + ref_slot[e]], cols[e])
    assert tp.max_refs == np.diff(ptr).max(initial=0) <= sizes[1]
    # Whole groups stage at least the referenced rows.
    assert tp.referenced_rows <= tp.staged_rows


def test_hub_row_and_empty_block_shapes():
    hub = build_grouped_plan(to_port(hub_csr()[0]), **plan_kw(SMALL))
    j = hub.cut_rows.tolist().index(12)
    assert int(hub.cut_ptr[j + 1] - hub.cut_ptr[j]) >= 500 // 16
    empty = build_grouped_plan(to_port(empty_block_csr()[0]), **plan_kw(SMALL))
    blocks = empty.block_ids.numpy()
    for b in (1, 2):
        assert (blocks == b).sum() == 1
        c = int(np.flatnonzero(blocks == b)[0])
        assert int(empty.chunk_count[c]) == int(empty.group_count[c]) == 0
        assert (int(empty.row_lo[c]), int(empty.row_hi[c])) == (8 * b,
                                                                 8 * b + 7)


def walk(plan: GroupedSpmmPlan, B: np.ndarray):
    """The CUDA kernel's walk (csrc/spmm_grouped.cu) in Python: the chunk
    kernel's walk, each edge reading the B row its slot stages."""
    slots = plan.slots.numpy()
    return chunk_walk(plan, B, lambda c, e: staged_row(plan, c, int(slots[e])))


@pytest.mark.parametrize("sizes", [SMALL, (8, 1, 1, 1), (16, 5, 2, 3),
                                   (64, 64, 32, 8)])
@pytest.mark.parametrize("name", ["powerlaw", "hub", "empty_block"])
def test_plan_walk_writes_every_row_once(name, sizes):
    jcsr, mat = GRAPHS[name][0]()
    plan = build_grouped_plan(to_port(jcsr), **plan_kw(sizes))
    B = np.random.default_rng(1).standard_normal((mat.shape[1], 3))
    out, wrow, wslot = walk(plan, B)
    assert (wrow == 1).all() and (wslot == 1).all()
    np.testing.assert_allclose(out, (mat != 0).astype(np.float64) @ B,
                               rtol=1e-12, atol=1e-12)


def dense_B(rows, K, seed=1):
    return np.random.default_rng(seed).standard_normal((rows, K)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_grouped():
    """JAX spmm_grouped in interpret mode, once per case: {case: (K, B, g,
    out over plan, grad_B over plan_t)}."""
    res = {}
    for name, K in (("random", 40), ("binary", 300), ("powerlaw", 300)):
        make, sizes = GRAPHS[name]
        jcsr, _ = make()
        m, n = jcsr.shape
        jadj = JAdjacency.from_csr(jcsr, plan="grouped", **plan_kw(sizes))
        B, g = dense_B(n, K), dense_B(m, K, seed=2)
        out = jspmm_grouped(jadj.plan, jcsr.data, jnp.asarray(B), m,
                            interpret=True)
        t_data = None if jcsr.data is None else jcsr.data[jadj.perm]
        gB = jspmm_grouped(jadj.plan_t, t_data, jnp.asarray(g), n,
                           interpret=True)
        res[name] = (K, B, g, np.asarray(out), np.asarray(gB))
    return res


@pytest.mark.parametrize("name", ["random", "binary", "powerlaw"])
def test_spmm_grouped_matches_jax_kernel(jax_grouped, name):
    K, B, g, j_out, j_gB = jax_grouped[name]
    make, sizes = GRAPHS[name]
    jcsr, mat = make()
    tol = TOL_POWERLAW if name == "powerlaw" else TOL
    tadj = TAdjacency.from_csr(to_port(jcsr), plan="grouped", **plan_kw(sizes))
    out = kg.spmm_grouped(tadj.plan, tadj.data, torch.from_numpy(B),
                          jcsr.shape[0])
    np.testing.assert_allclose(out.numpy(), j_out, **tol)
    Bt = torch.from_numpy(B).requires_grad_(True)
    tspmm(tadj, Bt, method="pallas").backward(torch.from_numpy(g))
    np.testing.assert_allclose(Bt.grad.numpy(), j_gB, **tol)
    np.testing.assert_allclose(j_out, mat @ B, **tol)  # JAX against scipy


@pytest.mark.parametrize("method", ["pallas", "auto"])
def test_grad_values_match_jax_sddmm(method):
    jcsr, _ = GRAPHS["random"][0]()
    m, n = jcsr.shape
    B, g = dense_B(n, 12), dense_B(m, 12, seed=3)
    tadj = TAdjacency.from_csr(to_port(jcsr), plan="grouped", **plan_kw(SMALL))
    d = tadj.data.clone().requires_grad_(True)
    Bt = torch.from_numpy(B).requires_grad_(True)
    tspmm(tadj.with_data(d), Bt, method=method).backward(torch.from_numpy(g))
    want = jsddmm(JAdjacency.from_csr(jcsr), jnp.asarray(g), jnp.asarray(B))
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want), **TOL)


def count_calls(monkeypatch, name):
    calls, wrapper = [], getattr(tops, name)

    def counted(*a, **k):
        calls.append(a[-1] if name == "spmm_grouped" else a[0].shape[0] - 1)
        return wrapper(*a, **k)

    monkeypatch.setattr(tops, name, counted)
    return calls


@pytest.mark.parametrize("plan,method,grouped,csr", [
    # "auto" takes the CSR kernel on every adjacency, a grouped one too
    # (the rule the card measured, PERF.md PR 7); "pallas" keeps the
    # grouped kernel: forward over plan, grad_B over plan_t.
    ("grouped", "auto", [], [60, 50]),
    ("grouped", "pallas", [60, 50], []),
    ("grouped", "tiled", [], [60, 50]),     # "tiled" is the CSR kernel
    ("perrow", "auto", [], [60, 50]),
    (False, "auto", [], [60, 50]),
])
def test_auto_on_a_grouped_adjacency_takes_the_grouped_route(
        monkeypatch, plan, method, grouped, csr):
    """The route each (plan, method) takes, by the wrappers it calls."""
    g_calls = count_calls(monkeypatch, "spmm_grouped")
    c_calls = count_calls(monkeypatch, "spmm_csr")
    jcsr, mat = GRAPHS["random"][0]()
    tadj = TAdjacency.from_csr(to_port(jcsr), plan=plan, **plan_kw(SMALL))
    B = torch.from_numpy(dense_B(50, 4)).requires_grad_(True)
    out = tspmm(tadj, B, method=method)
    out.backward(torch.ones_like(out))
    assert (g_calls, c_calls) == (grouped, csr)
    np.testing.assert_allclose(out.detach().numpy(), mat @ B.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(B.grad.numpy(), mat.T @ np.ones((60, 4)), **TOL)


def test_grouped_without_transposed_plan_takes_the_csr_kernel_backward(
        monkeypatch):
    g_calls = count_calls(monkeypatch, "spmm_grouped")
    c_calls = count_calls(monkeypatch, "spmm_csr")
    jcsr, mat = GRAPHS["random"][0]()
    tadj = TAdjacency.from_csr(to_port(jcsr), plan="grouped",
                               plan_transpose=False, **plan_kw(SMALL))
    assert isinstance(tadj.plan, GroupedSpmmPlan) and tadj.plan_t is None
    B = torch.from_numpy(dense_B(50, 4)).requires_grad_(True)
    tspmm(tadj, B, method="pallas").sum().backward()
    assert (g_calls, c_calls) == ([60], [50])
    np.testing.assert_allclose(B.grad.numpy(), mat.T @ np.ones((60, 4)), **TOL)


def test_from_csr_grouped_plans_and_kwargs():
    jcsr, _ = GRAPHS["random"][0]()
    tadj = TAdjacency.from_csr(to_port(jcsr), plan="grouped",
                               rows_per_block=16, edges_per_chunk=5,
                               groups_per_chunk=3, group_rows=4,
                               chunk_nnz=99)  # unknown kw ignored
    p = tadj.plan
    assert (p.rows_per_block, p.edges_per_chunk, p.group_rows) == (16, 5, 4)
    assert p.groups_per_chunk <= 3 and p.shape == (60, 50)
    assert tadj.plan_t.shape == (50, 60)
    assert p.indptr is tadj.csr.indptr and tadj.plan_t.indptr is tadj.csc.indptr
    t = tadj.transpose()
    assert t.plan is tadj.plan_t and t.plan_t is tadj.plan
    defaults = TAdjacency.from_csr(to_port(jcsr), plan="grouped").plan
    assert (defaults.rows_per_block, defaults.edges_per_chunk,
            defaults.group_rows) == (64, 64, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        build_grouped_plan(to_port(jcsr), rows_per_block=12)
    with pytest.raises(ValueError, match="at least 1"):
        build_grouped_plan(to_port(jcsr), group_rows=0)


def test_bf16_in_bf16_out_and_mean():
    jcsr, mat = GRAPHS["random"][0]()
    tadj = TAdjacency.from_csr(to_port(jcsr), plan="grouped", **plan_kw(SMALL))
    B = torch.from_numpy(dense_B(50, 16))
    Bh = B.to(torch.bfloat16)
    out = tspmm(tadj, Bh, method="pallas")
    assert out.dtype == torch.bfloat16
    # One output rounding to bf16: 2**-8 relative.
    np.testing.assert_allclose(out.float().numpy(), mat @ Bh.float().numpy(),
                               rtol=8e-3, atol=8e-3)
    deg = np.maximum(np.diff(mat.indptr), 1)[:, None]
    np.testing.assert_allclose(
        tspmm(tadj, B, method="auto", reduce="mean").numpy(),
        (mat @ B.numpy()) / deg, **TOL)


def test_plain_version_reads_b_through_the_plan():
    # A wrong group id in the plan must change the plain version's answer:
    # it reads B through the plan, not through the CSR's columns.
    jcsr, mat = GRAPHS["random"][0]()
    plan = build_grouped_plan(to_port(jcsr), **plan_kw(SMALL))
    B = torch.from_numpy(dense_B(50, 3))
    rows = tf.expand_indptr(plan.indptr, plan.nnz)
    args = (plan.chunk_count, plan.groups, plan.group_count, plan.slots,
            plan.group_rows)
    good = tref.spmm_grouped_chunks(*args, None, B, rows, 60)
    np.testing.assert_allclose(good.numpy(), (mat != 0) @ B.numpy(), **TOL)
    groups = plan.groups.clone()
    groups[0, 0] += 1
    bad = tref.spmm_grouped_chunks(plan.chunk_count, groups, plan.group_count,
                                   plan.slots, plan.group_rows, None, B, rows,
                                   60)
    assert not torch.allclose(bad, good)


def test_gcn_on_a_reordered_grouped_graph_matches_jax():
    dims = [16, 8, 3]
    jd, td = jds.sbm_graph(**SBM), tds.sbm_graph(**SBM)
    jr, perm = jreorder.reorder(jgraph.add_self_loops(jd.csr), "rcm")
    tr, tperm = reorder(tgraph.add_self_loops(td.csr), "rcm")
    np.testing.assert_array_equal(tperm, perm)
    params = JGCN(dims).init(jax.random.PRNGKey(0))
    jx = jnp.asarray(np.asarray(jd.features)[perm])
    ref = np.asarray(JGCN(dims, dropout_rate=0.0, method="xla").apply(
        params, JAdjacency.from_csr(jr), jx))
    tadj = TAdjacency.from_csr(tr, plan="grouped")
    model = TGCN(dims, dropout_rate=0.0)
    model.load_state_dict(params_from_jax(params))
    model.with_norms(tadj).eval()
    out = model(tadj, td.features[torch.from_numpy(tperm)])
    scale = float(np.abs(ref).max())
    assert float(np.abs(out.detach().numpy() - ref).max()) <= 1e-4 * scale
    # Un-permuted, the same model on the original graph gives the same logits.
    orig = TAdjacency.from_csr(tgraph.add_self_loops(td.csr))
    model.with_norms(orig)
    want = model(orig, td.features).detach().numpy()
    np.testing.assert_allclose(out.detach().numpy()[np.argsort(perm)], want,
                               rtol=1e-5, atol=1e-4 * scale)


@pytest.mark.parametrize("K,vec,S,itemsize", [
    (1, 1, 256, 4), (3, 1, 256, 4), (32, 1, 256, 4), (33, 1, 512, 4),
    (128, 4, 256, 4), (130, 2, 512, 4), (512, 4, 512, 4), (512, 4, 512, 2),
    (512, 4, 2, 4), (4096, 4, 64, 4), (128, 4, 64, 4), (32, 4, 64, 4)])
def test_k_tile_fits_two_ctas_an_sm(K, vec, S, itemsize):
    """Two stages of S staged rows of the tile (a multiple of the copy's
    ``vec`` columns, at most MAX_COLS) fit the shared memory of two CTAs an
    SM; the ring then takes a third stage where that fits too."""
    header = kg.header_bytes(64, 64)
    kt = kg.k_tile(K, vec, S, itemsize, header)
    assert kt % vec == 0 and 1 <= kt <= kg.MAX_COLS
    sb = kg.stage_bytes(header, S, kt, itemsize)
    assert kg.BARRIER_BYTES + 2 * sb <= kg.SMEM_TWO_PER_SM
    ns = kg.stages(kt, S, itemsize, header)
    assert ns in (2, 3) and kg.BARRIER_BYTES + ns * sb <= kg.SMEM_TWO_PER_SM
    assert ns == 3 or kg.BARRIER_BYTES + 3 * sb > kg.SMEM_TWO_PER_SM
    tiles = -(-K // kt)
    assert (tiles - 1) * kt < K <= tiles * kt
    # The tiles are balanced: none is a sliver beside the others.
    assert K - (tiles - 1) * kt > kt - tiles * vec


def test_k_tile_refuses_a_staged_tile_beyond_shared_memory():
    # Two stages of 25,000 rows fit one CTA an SM (the opt-in), as two.
    kt = kg.k_tile(8, 1, 25_000, 4, 1024)
    assert kt >= 1 and kg.stages(kt, 25_000, 4, 1024) == 2
    assert kg.BARRIER_BYTES + 2 * kg.stage_bytes(1024, 25_000, kt,
                                                 4) <= kg.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        kg.k_tile(8, 1, 40_000, 4, 1024)


def test_main_shapes_stage_three_deep():
    """At the timed shapes (E = 64 referenced rows at most, R = 64) the ring
    holds three stages of one 32-column tile (K=128 in four tiles); with a
    tile as wide as the kernel takes, K=128 f32 is one tile of 128 columns
    and three stages, K=512 three tiles of 172 columns and two stages."""
    header = kg.header_bytes(64, 64)
    for K, KT, NS in ((128, 32, 3), (32, 32, 3), (512, 32, 3), (3, 4, 3)):
        kt = kg.k_tile(K, 4, 64, 4, header)
        assert (kt, kg.stages(kt, 64, 4, header)) == (KT, NS)
    widest = kg.MAX_COLS
    try:
        kg.MAX_COLS = 256
        for K, KT, NS in ((128, 128, 3), (512, 172, 2)):
            kt = kg.k_tile(K, 4, 64, 4, header)
            assert (kt, kg.stages(kt, 64, 4, header)) == (KT, NS)
    finally:
        kg.MAX_COLS = widest
