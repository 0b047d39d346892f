"""Port parity: the per-row chunk plan, ``spmm(method="pallas")`` and the
``scatter``/``dense`` tiers, against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
``spmm_pallas`` runs in interpret mode, as ``tests/test_pallas.py`` runs it,
once per case in a module fixture; JAX's ``spmm(method="pallas")`` itself
cannot run on the CPU (it launches the TPU kernel), so the port's op is held
to the JAX kernel forward and over the transposed plan, and to the JAX XLA
tier.  The port runs on the CPU here, i.e. through the chunk kernel's plain
version; pure-Python walks of the plan's row lists and carry slots (which
the grouped kernel reads) and of its pieces (each row's part in each chunk,
which the chunk kernel reads) check what only the CUDA kernels read.  The
kernel itself is checked in ``tests/test_torch_cuda.py``.

Tolerance: rtol/atol 1e-5 (both sides accumulate in f32, in different
orders), 1e-4 on the power-law graph (rows of hundreds of edges), as in
``tests/test_pallas.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gespmm_tpu.kernels.spmm_pallas import spmm_pallas as jspmm_pallas
from gespmm_tpu.ops import reference as jref
from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.ops.spmm import spmm as jspmm
from gespmm_tpu.sparse.partition import build_spmm_plan as jbuild
from tests.conftest import powerlaw_csr, random_csr

from gespmm_tpu_torch.kernels import spmm_pallas as kp
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.ops.spmm import spmm as tspmm
from gespmm_tpu_torch.sparse import formats as tf
from gespmm_tpu_torch.sparse.partition import (SpmmPlan, build_grouped_plan,
                                                build_spmm_plan)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_POWERLAW = dict(rtol=1e-4, atol=1e-4)
PLAN_SIZES = [(8, 16), (8, 8), (16, 3), (64, 64), (128, 256)]


def to_port(jcsr) -> tf.CSR:
    return tf.CSR(torch.tensor(np.asarray(jcsr.indptr)),
                  torch.tensor(np.asarray(jcsr.indices)),
                  None if jcsr.data is None
                  else torch.tensor(np.asarray(jcsr.data)), jcsr.shape)


GRAPHS = {
    "random": lambda: random_csr(50, 40, density=0.15, seed=1),
    "binary": lambda: random_csr(40, 40, density=0.1, seed=2, binary=True),
    "powerlaw": lambda: powerlaw_csr(64, 48, avg_deg=10, seed=3),
    "empty_rows": lambda: random_csr(90, 30, density=0.02, seed=4),
}


def dense_B(rows, K, seed=1):
    return np.random.default_rng(seed).standard_normal((rows, K)).astype(np.float32)


def walk(plan: SpmmPlan, B: np.ndarray, b_row=None):
    """The walk of the plan's row lists (csrc/spmm_grouped.cu's, and the
    chunk kernel's as first ported) in Python: per chunk, its rows in order,
    each row's sum written to out or to its carry slot; then the carry.
    Edge e of chunk c reads B row ``b_row(c, e)`` (default: its column; the
    grouped kernel's walk passes the row its slot stages).  Returns (out,
    writes per row, writes per slot)."""
    ip = plan.indptr.numpy().astype(np.int64)
    ix = plan.indices.numpy()
    if b_row is None:
        def b_row(c, e):
            return ix[e]
    (m, _), K = plan.shape, B.shape[1]
    out = np.full((m, K), np.nan)
    partial = np.full((plan.num_slots, K), np.nan)
    wrow, wslot = np.zeros(m, int), np.zeros(plan.num_slots, int)
    for c in range(plan.num_chunks):
        s = int(plan.chunk_start[c])
        t = s + int(plan.chunk_count[c])
        r, r_hi = int(plan.row_lo[c]), int(plan.row_hi[c])
        rs, re, acc = ip[r], ip[r + 1], np.zeros(K)

        def flush(r, rs, re, acc):
            if rs < s or re > t:
                slot = int(plan.head_slot[c] if rs < s else plan.tail_slot[c])
                assert slot >= 0
                partial[slot] = acc
                wslot[slot] += 1
            else:
                out[r] = acc
                wrow[r] += 1

        for e in range(s, t):
            while e >= re:
                flush(r, rs, re, acc)
                r, rs, re, acc = r + 1, re, ip[r + 2], np.zeros(K)
            acc = acc + B[b_row(c, e)]
        while True:
            flush(r, rs, re, acc)
            r += 1
            if r > r_hi:
                break
            rs, re, acc = re, ip[r + 1], np.zeros(K)
    cut_ptr = plan.cut_ptr.numpy()
    for j, row in enumerate(plan.cut_rows.numpy()):
        out[row] = partial[cut_ptr[j]:cut_ptr[j + 1]].sum(0)
        wrow[row] += 1
    return out, wrow, wslot


def piece_walk(plan: SpmmPlan, B: np.ndarray):
    """The chunk kernel's walk (csrc/spmm_chunk.cu) in Python: each piece's
    edges summed and written to its out row or its carry slot; then the
    carry.  Returns (out, writes per row, writes per slot)."""
    ix = plan.indices.numpy()
    ptr, prow = plan.piece_ptr.numpy(), plan.piece_row.numpy()
    pslot = plan.piece_slot.numpy()
    (m, _), K = plan.shape, B.shape[1]
    out = np.full((m, K), np.nan)
    partial = np.full((plan.num_slots, K), np.nan)
    wrow, wslot = np.zeros(m, int), np.zeros(plan.num_slots, int)
    for p in range(plan.num_pieces):
        acc = B[ix[ptr[p]:ptr[p + 1]]].sum(0)
        if pslot[p] >= 0:
            partial[pslot[p]] = acc
            wslot[pslot[p]] += 1
        else:
            out[prow[p]] = acc
            wrow[prow[p]] += 1
    cut_ptr = plan.cut_ptr.numpy()
    for j, row in enumerate(plan.cut_rows.numpy()):
        out[row] = partial[cut_ptr[j]:cut_ptr[j + 1]].sum(0)
        wrow[row] += 1
    return out, wrow, wslot


@pytest.mark.parametrize("R,E", PLAN_SIZES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_matches_jax(name, R, E):
    jcsr, _ = GRAPHS[name]()
    jp = jbuild(jcsr, rows_per_block=R, chunk_nnz=E)
    tp = build_spmm_plan(to_port(jcsr), rows_per_block=R, chunk_nnz=E)
    assert tp.num_chunks == jp.num_chunks and tp.num_blocks == jp.num_blocks
    np.testing.assert_array_equal(tp.block_ids.numpy(), np.asarray(jp.block_ids))
    np.testing.assert_array_equal(tp.first.numpy(), np.asarray(jp.first))
    src, lr = np.asarray(jp.src), np.asarray(jp.local_rows)
    starts, counts = tp.chunk_start.numpy(), tp.chunk_count.numpy()
    for c in range(tp.num_chunks):
        np.testing.assert_array_equal(
            np.arange(starts[c], starts[c] + counts[c]), src[c][lr[c] < R])
    assert int(tp.chunk_count.max()) <= E


@pytest.mark.parametrize("R,E", PLAN_SIZES + [(8, 1)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_walk_writes_every_row_once(name, R, E):
    _, mat = GRAPHS[name]()
    plan = build_spmm_plan(to_port(GRAPHS[name]()[0]), rows_per_block=R,
                           chunk_nnz=E)
    B = dense_B(mat.shape[1], 3).astype(np.float64)
    out, wrow, wslot = walk(plan, B)
    assert (wrow == 1).all() and (wslot == 1).all()
    np.testing.assert_allclose(out, (mat != 0).astype(np.float64) @ B,
                               rtol=1e-12, atol=1e-12)


def check_pieces(plan: SpmmPlan):
    """The pieces tile the CSR edges in chunk order, each inside its row and
    its chunk; a cut row's pieces write its carry slots in chunk order (the
    chunk's head slot where the row began earlier, else its tail slot), any
    other row has one piece, which writes out."""
    ip = plan.indptr.numpy().astype(np.int64)
    ptr, prow = plan.piece_ptr.numpy(), plan.piece_row.numpy()
    pslot = plan.piece_slot.numpy()
    assert ptr[0] == 0 and ptr[-1] == plan.nnz and (np.diff(ptr) >= 0).all()
    # Chunk c holds the pieces of its rows row_lo[c] .. row_hi[c], in order.
    lo, hi = plan.row_lo.numpy(), plan.row_hi.numpy()
    chunk = np.repeat(np.arange(plan.num_chunks), hi - lo + 1)
    np.testing.assert_array_equal(
        prow, np.concatenate([np.arange(a, b + 1) for a, b in zip(lo, hi)]))
    cs = plan.chunk_start.numpy()[chunk]
    ce = cs + plan.chunk_count.numpy()[chunk]
    assert ((ptr[:-1] >= np.maximum(ip[prow], cs))
            & (ptr[1:] <= np.minimum(ip[prow + 1], ce))).all()
    head, tail = plan.head_slot.numpy()[chunk], plan.tail_slot.numpy()[chunk]
    began = ptr[:-1] > ip[prow]
    goes_on = ptr[1:] < ip[prow + 1]
    np.testing.assert_array_equal(
        pslot, np.where(began, head, np.where(goes_on, tail, -1)))
    cut_ptr = plan.cut_ptr.numpy()
    for j, row in enumerate(plan.cut_rows.numpy()):
        np.testing.assert_array_equal(pslot[prow == row],
                                      np.arange(cut_ptr[j], cut_ptr[j + 1]))
    whole = ~np.isin(prow, plan.cut_rows.numpy())
    assert (pslot[whole] == -1).all()
    assert (np.bincount(prow[whole], minlength=plan.shape[0])[
        np.setdiff1d(np.arange(plan.shape[0]), plan.cut_rows.numpy())] == 1).all()


@pytest.mark.parametrize("R,E", PLAN_SIZES + [(8, 1)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pieces_cover_each_edge_once_in_chunk_order(name, R, E):
    plan = build_spmm_plan(to_port(GRAPHS[name]()[0]), rows_per_block=R,
                           chunk_nnz=E)
    check_pieces(plan)


@pytest.mark.parametrize("R,E", PLAN_SIZES + [(8, 1)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_piece_walk_writes_every_row_once(name, R, E):
    _, mat = GRAPHS[name]()
    plan = build_spmm_plan(to_port(GRAPHS[name]()[0]), rows_per_block=R,
                           chunk_nnz=E)
    B = dense_B(mat.shape[1], 3).astype(np.float64)
    out, wrow, wslot = piece_walk(plan, B)
    assert (wrow == 1).all() and (wslot == 1).all()
    np.testing.assert_allclose(out, (mat != 0).astype(np.float64) @ B,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_only_the_chunk_plan_carries_pieces(name):
    # The grouped kernel walks the row lists; its plan builds no pieces.
    csr = to_port(GRAPHS[name]()[0])
    plan = build_spmm_plan(csr, rows_per_block=8, chunk_nnz=16).to("cpu")
    assert plan.piece_ptr is not None and plan.num_pieces > 0
    grouped = build_grouped_plan(csr, rows_per_block=8,
                                 edges_per_chunk=16).to("cpu")
    assert (grouped.piece_ptr, grouped.piece_row, grouped.piece_slot) == (
        None, None, None)


def test_hub_row_spreads_over_chunks():
    # One row of 1,000 edges between short rows: many chunks, one cut row.
    rng = np.random.default_rng(5)
    deg = np.r_[rng.integers(0, 4, 20), 1000, rng.integers(0, 4, 20)]
    n = 1200
    indices = np.concatenate([np.sort(rng.choice(n, d, replace=False))
                              for d in deg]).astype(np.int32)
    indptr = np.r_[0, np.cumsum(deg)].astype(np.int32)
    csr = tf.CSR(torch.from_numpy(indptr), torch.from_numpy(indices), None,
                 (deg.shape[0], n))
    plan = build_spmm_plan(csr, rows_per_block=8, chunk_nnz=64)
    assert 20 in plan.cut_rows.tolist()
    B = torch.from_numpy(dense_B(n, 5))
    out = kp.spmm_pallas(plan, None, B, deg.shape[0])
    want = tref.spmm_rows(csr.row_ids(), csr.indices, None, B, deg.shape[0])
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    _, wrow, _ = walk(plan, B.double().numpy())
    assert (wrow == 1).all()
    # The hub's pieces: one a chunk it touches, each at most E edges.
    check_pieces(plan)
    hub = plan.piece_row.numpy() == 20
    j = plan.cut_rows.tolist().index(20)
    assert hub.sum() == int(plan.cut_ptr[j + 1] - plan.cut_ptr[j]) >= 1000 // 64
    assert np.diff(plan.piece_ptr.numpy())[hub].max() <= 64
    got, wrow, _ = piece_walk(plan, B.double().numpy())
    assert (wrow == 1).all()
    np.testing.assert_allclose(got, want.double().numpy(), **TOL)


@pytest.fixture(scope="module")
def jax_pallas():
    """JAX spmm_pallas in interpret mode, once per case: {case: (out, grad_B
    over the transposed plan)}."""
    res = {}
    for name, K, (R, E) in (("random", 32, (8, 16)), ("binary", 16, (8, 16)),
                            ("powerlaw", 8, (8, 8))):
        jcsr, _ = GRAPHS[name]()
        m, n = jcsr.shape
        jadj = JAdjacency.from_csr(jcsr, plan="perrow", rows_per_block=R,
                                   chunk_nnz=E)
        B, g = dense_B(n, K), dense_B(m, K, seed=2)
        out = jspmm_pallas(jadj.plan, jcsr.data, jnp.asarray(B), m,
                           k_tile=128, interpret=True)
        t_data = None if jcsr.data is None else jcsr.data[jadj.perm]
        gB = jspmm_pallas(jadj.plan_t, t_data, jnp.asarray(g), n, k_tile=128,
                          interpret=True)
        res[name] = (K, (R, E), B, g, np.asarray(out), np.asarray(gB))
    return res


@pytest.mark.parametrize("name", ["random", "binary", "powerlaw"])
def test_spmm_pallas_matches_jax_kernel(jax_pallas, name):
    K, (R, E), B, g, j_out, j_gB = jax_pallas[name]
    jcsr, _ = GRAPHS[name]()
    tol = TOL_POWERLAW if name == "powerlaw" else TOL
    tadj = TAdjacency.from_csr(to_port(jcsr), plan="perrow", rows_per_block=R,
                               chunk_nnz=E)
    out = kp.spmm_pallas(tadj.plan, tadj.data, torch.from_numpy(B),
                         jcsr.shape[0])
    np.testing.assert_allclose(out.numpy(), j_out, **tol)
    Bt = torch.from_numpy(B).requires_grad_(True)
    tspmm(tadj, Bt, method="pallas").backward(torch.from_numpy(g))
    np.testing.assert_allclose(Bt.grad.numpy(), j_gB, **tol)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 3, 33, 130])
def test_method_pallas_matches_xla_tier(K, binary):
    jcsr, _ = GRAPHS["binary" if binary else "empty_rows"]()
    m, n = jcsr.shape
    tcsr = to_port(jcsr)
    B, W = dense_B(n, K), dense_B(m, K, seed=3)

    jadj = JAdjacency.from_csr(jcsr)

    def jloss(d, b):
        a = jadj if d is None else jadj.with_data(d)
        return jnp.sum(jspmm(a, b, method="xla") * W)

    if binary:
        jB = jax.grad(lambda b: jloss(None, b))(jnp.asarray(B))
    else:
        jd, jB = jax.grad(jloss, argnums=(0, 1))(jcsr.data, jnp.asarray(B))
    tadj = TAdjacency.from_csr(tcsr, plan="perrow", rows_per_block=8,
                               chunk_nnz=4)
    Bt = torch.from_numpy(B).requires_grad_(True)
    d = None if binary else tcsr.data.clone().requires_grad_(True)
    a = tadj if binary else tadj.with_data(d)
    out = tspmm(a, Bt, method="pallas")
    ref = tspmm(TAdjacency.from_csr(tcsr), torch.from_numpy(B), method="xla")
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), **TOL)
    out.backward(torch.from_numpy(W))
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(jB), **TOL)
    if not binary:
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(jd), **TOL)
    mean = tspmm(tadj, torch.from_numpy(B), method="pallas", reduce="mean")
    np.testing.assert_allclose(
        mean.numpy(), np.asarray(jspmm(JAdjacency.from_csr(jcsr), jnp.asarray(B),
                                       reduce="mean", method="xla")), **TOL)


def test_pallas_without_transposed_plan_takes_the_csr_kernel_backward(
        monkeypatch):
    import gespmm_tpu_torch.ops.spmm as tops

    jcsr, mat = GRAPHS["random"]()
    tadj = TAdjacency.from_csr(to_port(jcsr), plan="perrow",
                               plan_transpose=False, rows_per_block=8,
                               chunk_nnz=8)
    assert tadj.plan is not None and tadj.plan_t is None
    calls, csr_wrapper = [], tops.spmm_csr

    def counted(indptr, *a, **k):
        calls.append(indptr.shape[0] - 1)
        return csr_wrapper(indptr, *a, **k)

    monkeypatch.setattr(tops, "spmm_csr", counted)
    B = torch.from_numpy(dense_B(40, 4)).requires_grad_(True)
    tspmm(tadj, B, method="pallas").sum().backward()
    assert calls == [40]  # grad_B only: the CSR wrapper over the CSC
    np.testing.assert_allclose(B.grad.numpy(), mat.T @ np.ones((50, 4)), **TOL)


def test_from_csr_plans_follow_transpose_and_with_data():
    jcsr, _ = GRAPHS["random"]()
    tadj = TAdjacency.from_csr(to_port(jcsr), plan="perrow", rows_per_block=16,
                               chunk_nnz=5, k_hint=128)  # unknown kw ignored
    assert (tadj.plan.rows_per_block, tadj.plan.chunk_nnz) == (16, 5)
    assert tadj.plan.shape == (50, 40) and tadj.plan_t.shape == (40, 50)
    assert tadj.plan.indices is tadj.csr.indices
    assert tadj.plan_t.indices is tadj.csc.indices
    t = tadj.transpose()
    assert t.plan is tadj.plan_t and t.plan_t is tadj.plan
    w = tadj.with_data(torch.ones(tadj.nnz))
    assert w.plan is tadj.plan and w.plan_t is tadj.plan_t
    Bt = torch.from_numpy(dense_B(50, 6))
    np.testing.assert_allclose(
        tspmm(t, Bt, method="pallas").numpy(),
        tspmm(t, Bt, method="xla").numpy(), **TOL)
    for kind in (True, "auto", "tiled", False):
        a = TAdjacency.from_csr(to_port(jcsr), plan=kind)
        assert a.plan is None and a.plan_t is None
    with pytest.raises(ValueError, match="unknown plan kind"):
        TAdjacency.from_csr(to_port(jcsr), plan="blocked")


@pytest.mark.parametrize("R,E", [(12, 64), (0, 64), (64, 0)])
def test_plan_sizes_refused(R, E):
    jcsr, _ = GRAPHS["random"]()
    with pytest.raises(ValueError):
        build_spmm_plan(to_port(jcsr), rows_per_block=R, chunk_nnz=E)
    if R % 8:
        with pytest.raises(ValueError, match="multiple of 8"):
            jbuild(jcsr, rows_per_block=R, chunk_nnz=E)


@pytest.mark.parametrize("method", ["scatter", "dense"])
@pytest.mark.parametrize("binary", [False, True])
def test_scatter_and_dense_match_jax(method, binary):
    jcsr, _ = GRAPHS["binary" if binary else "empty_rows"]()
    m, n = jcsr.shape
    K = 7
    B, W = dense_B(n, K), dense_B(m, K, seed=4)

    jadj = JAdjacency.from_csr(jcsr)

    def jloss(d, b):
        a = jadj if d is None else jadj.with_data(d)
        return jnp.sum(jspmm(a, b, method=method) * W)

    jout = jspmm(JAdjacency.from_csr(jcsr), jnp.asarray(B), method=method)
    if binary:
        jgB = jax.grad(lambda b: jloss(None, b))(jnp.asarray(B))
    else:
        jgd, jgB = jax.grad(jloss, argnums=(0, 1))(jcsr.data, jnp.asarray(B))
    tcsr = to_port(jcsr)
    d = None if binary else tcsr.data.clone().requires_grad_(True)
    Bt = torch.from_numpy(B).requires_grad_(True)
    adj = TAdjacency.from_csr(tcsr)
    out = tspmm(adj if binary else adj.with_data(d), Bt, method=method)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    out.backward(torch.from_numpy(W))
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(jgB), **TOL)
    if not binary:
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgd), **TOL)


def test_dense_guard(monkeypatch):
    jcsr, _ = GRAPHS["random"]()
    monkeypatch.setattr(tref, "DENSE_BYTES_LIMIT", 1000)
    monkeypatch.setattr(jref, "DENSE_BYTES_LIMIT", 1000)
    B = dense_B(40, 4)
    with pytest.raises(ValueError, match="guard"):
        tspmm(TAdjacency.from_csr(to_port(jcsr)), torch.from_numpy(B),
              method="dense")
    with pytest.raises(ValueError, match="guard"):
        jspmm(JAdjacency.from_csr(jcsr), jnp.asarray(B), method="dense")


def test_bf16_in_bf16_out():
    jcsr, _ = GRAPHS["random"]()
    tadj = TAdjacency.from_csr(to_port(jcsr), plan="perrow", rows_per_block=8,
                               chunk_nnz=8)
    B = torch.from_numpy(dense_B(40, 16)).to(torch.bfloat16)
    out = tspmm(tadj, B, method="pallas")
    assert out.dtype == torch.bfloat16
    ref = jspmm(JAdjacency.from_csr(jcsr), jnp.asarray(B.float().numpy()))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), rtol=8e-3,
                               atol=8e-3)


def test_chunk_plain_version_sums_each_row_in_chunk_order():
    # The plain version adds a cut row's partials in chunk order, as the
    # carry pass does: equal to summing chunk-sized pieces one by one.
    jcsr, _ = GRAPHS["powerlaw"]()
    plan = build_spmm_plan(to_port(jcsr), rows_per_block=8, chunk_nnz=8)
    B = torch.from_numpy(dense_B(48, 4))
    out = tref.spmm_chunks(plan.chunk_start, plan.chunk_count, plan.indices,
                           None, B, tf.expand_indptr(plan.indptr, plan.nnz), 64)
    np.testing.assert_allclose(out.numpy(), walk(plan, B.numpy())[0], **TOL)
