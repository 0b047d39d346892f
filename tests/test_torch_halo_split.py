"""Kernel row 7's split over all local shards, on the CPU.

The sharded tier's row 7 (``kernels/halo_spmm.py::halo_spmm_stacked``) runs
one launch over the stacked blocks of every shard a process holds, and cuts
each row of more than L joint edges (its diag edges, then its halo edges)
into segments of L (``sparse/partition.py::build_shard_split``).  On the CPU
it runs the plain split walk (``ops/reference.py::halo_spmm_split_rows``),
which reduces each segment apart and then carries: sums added, max/min
(extremum, count) pairs folded in segment order.

* The split lists of the joint blocks and of both transposes are held to a
  NumPy recount at L in {1, 4, 64} and P in {1, 2, 4}, on a hub graph built
  to have rows of exactly L and L + 1 joint edges, a segment that crosses
  from the diag block into the halo block, and a row whose edges are all
  halo.
* The port's ``halo_spmm`` over a partition split at L = 4 (so most rows
  are split) is held to the JAX package's ``halo_spmm`` (its tiled tier in
  interpret mode, as ``tests/test_torch_halo.py`` runs it) for sum, mean,
  max and min, one value an edge, per-head values for sum and binary, with
  gradients in B and in the edge values.  Edge values are multiples of 1/4
  and B multiples of 1/2, so products and most sums are exact and max/min
  meet ties.  Values within 1e-5 * max |ref| + 1e-6 (max/min exactly),
  gradients within 1e-5 * max(|ref|, 1).
* The split walk against float64: the sum equals scipy's float64 product to
  rounding, and max/min ``out`` and ``ties`` equal the unsplit plain walk
  (``reference.halo_spmm_rows``) exactly: the pair fold loses nothing.
* The all-shards autograd op against the same op run one shard at a time
  (the launch a rank makes with one shard a process), values and gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gespmm_tpu.parallel.halo import build_halo_partition as jax_build
from gespmm_tpu.parallel.halo import halo_spmm as jax_halo_spmm
from gespmm_tpu.parallel.halo import pad_for_halo as jax_pad
from gespmm_tpu.parallel.halo import split_edge_values as jax_split
from gespmm_tpu.parallel.mesh import make_mesh as jax_mesh
from gespmm_tpu.sparse.formats import csr_from_scipy as jax_csr
from gespmm_tpu_torch.kernels import halo_spmm as khalo
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.parallel import (build_halo_partition, halo_spmm,
                                       make_mesh, pad_for_halo)
from gespmm_tpu_torch.parallel.halo import (_HaloShards, make_exchange,
                                            split_edge_values)
from gespmm_tpu_torch.sparse.formats import csr_from_scipy
from gespmm_tpu_torch.sparse.partition import SPLIT_LEN

N = 256
L_WALK = 4  # the walk tests' segment length: most rows are split


@functools.lru_cache(maxsize=None)
def hub_graph():
    """A 256-node graph whose row 0 has 80 edges, all in columns 128-255
    (halo at P = 2 and 4), row 1 3 diag + 10 halo edges, row 2 40 + 40
    (at P = 4: shard 0 owns columns 0-63), rows 3-8 of joint degree 1, 2,
    4, 5, 64 and 65, hubs of 150 and 90 edges in other shards, empty rows,
    and values in multiples of 1/4."""
    rng = np.random.default_rng(11)
    cols = {0: rng.choice(np.arange(128, N), 80, replace=False),
            1: np.r_[0:3, 200:210],
            2: np.r_[0:40, 160:200]}
    for r, d in zip(range(3, 9), (1, 2, 4, 5, 64, 65)):
        cols[r] = rng.choice(N, d, replace=False)
    cols[100] = rng.choice(N, 150, replace=False)
    cols[200] = rng.choice(N, 90, replace=False)
    for r in range(9, N):
        if r not in cols and r % 7:
            cols[r] = rng.choice(N, int(rng.integers(1, 12)), replace=False)
    rows = np.concatenate([np.full(len(c), r) for r, c in cols.items()])
    cc = np.concatenate(list(cols.values()))
    vals = rng.integers(1, 9, rows.shape[0]) / 4.0
    mat = sp.csr_matrix((vals, (rows, cc)), shape=(N, N)).astype(np.float32)
    mat.sort_indices()
    return mat


def recount(d_indptr, h_indptr, L):
    """The joint split by a plain loop over shards and rows."""
    seg_row, seg_start, long_rows, seg_ptr = [], [], [], [0]
    P, rows = d_indptr.shape[0], d_indptr.shape[1] - 1
    for p in range(P):
        for r in range(rows):
            deg = d_indptr[p, r + 1] - d_indptr[p, r]
            if h_indptr is not None:
                deg += h_indptr[p, r + 1] - h_indptr[p, r]
            if deg <= L:
                continue
            long_rows.append(p * rows + r)
            for j in range(0, deg, L):
                seg_row.append(p * rows + r)
                seg_start.append(j)
            seg_ptr.append(len(seg_row))
    return seg_row, seg_start, long_rows, seg_ptr


@pytest.mark.parametrize("L", [1, 4, 64])
@pytest.mark.parametrize("parts", [1, 2, 4])
def test_joint_split_matches_a_numpy_recount(parts, L):
    hp = build_halo_partition(csr_from_scipy(hub_graph()), parts,
                              device="cpu", seg_len=L)
    d_ptr, h_ptr = hp.diag_indptr.numpy(), hp.halo_indptr.numpy()
    for split, d, h in ((hp.joint_split, d_ptr, h_ptr),
                        (hp.diag_t_split, hp.diag_t_indptr.numpy(), None),
                        (hp.halo_t_split, hp.halo_t_indptr.numpy(), None)):
        want = recount(d, h, L)
        got = split.split
        for g, w in zip((got.seg_row, got.seg_start, got.long_rows,
                         got.seg_ptr), want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))
        assert got.seg_len == L and split.rows == d.shape[1] - 1
        bounds = np.arange(parts + 1) * split.rows
        assert split.seg_off == tuple(np.searchsorted(want[0], bounds))
        assert split.long_off == tuple(np.searchsorted(want[2], bounds))
    # The cases the kernel must meet, in the joint split of shard 0.
    deg_d, deg_h = np.diff(d_ptr[0]), np.diff(h_ptr[0])
    joint = deg_d + deg_h
    assert (joint == L).any() and (joint == L + 1).any()
    split = hp.joint_split.split
    starts = split.seg_start.numpy()
    seg_rows = split.seg_row.numpy()
    if parts > 1:
        # A row of halo edges only, and (L > 1) a segment across the blocks.
        assert ((deg_d == 0) & (deg_h > L)).any()
    if parts > 1 and L > 1:
        on0 = seg_rows < hp.rpp
        d_of = deg_d[seg_rows[on0]]
        assert ((starts[on0] < d_of) & (starts[on0] + L > d_of)
                & (d_of > 0)).any()
    # Every joint edge lies in exactly one segment of at most L.
    all_joint = np.diff(d_ptr, axis=1) + np.diff(h_ptr, axis=1)
    lens = np.minimum(starts + L, all_joint.reshape(-1)[seg_rows]) - starts
    assert lens.sum() == all_joint[all_joint > L].sum()
    assert lens.max(initial=1) <= L


def test_default_split_length_is_the_csr_kernels():
    hp = build_halo_partition(csr_from_scipy(hub_graph()), 2, device="cpu")
    assert hp.joint_split.split.seg_len == SPLIT_LEN
    assert hp.joint_split.split.num_segments > 0
    # Shards [1, 2): the lists of shard 1 alone, rows and slots rebased.
    lists, row0, slot0 = hp.joint_split.local(1, 2)
    assert row0 == hp.rpp and slot0 == hp.joint_split.seg_off[1]
    assert (lists.seg_row.numpy() >= row0).all()
    assert int(lists.seg_ptr[0]) == slot0


# (parts, reduce, values): "vals" one value an edge, "binary" none,
# "heads<H>" per-head values over K = 12.
CASES = [
    (1, "max", "vals"), (2, "sum", "vals"), (4, "sum", "vals"),
    (4, "mean", "vals"), (2, "max", "binary"), (4, "max", "vals"),
    (4, "min", "vals"), (4, "sum", "heads2"), (2, "sum", "binary"),
]


def _inputs(case):
    parts, reduce, kind = case
    rng = np.random.default_rng(parts * 10 + len(reduce) + len(kind))
    mat = hub_graph()
    heads = int(kind[5:]) if kind.startswith("heads") else 0
    K = 12 if heads else 8
    B = (np.round(rng.standard_normal((N, K)) * 2) / 2).astype(np.float32)
    g = (np.round(rng.standard_normal((N, K)) * 4) / 4).astype(np.float32)
    vals = None
    if kind != "binary":
        shape = (mat.nnz, heads) if heads else (mat.nnz,)
        vals = (rng.integers(-8, 9, shape) / 4.0).astype(np.float32)
    return mat, B, g, vals


@functools.lru_cache(maxsize=None)
def _jax_result(case):
    """(out, grad_B, grad_vals) of the JAX tiled halo_spmm, numpy."""
    parts, reduce, kind = case
    mat, B, g, vals = _inputs(case)
    csr = jax_csr(mat)
    if kind == "binary":
        csr = csr.with_data(None)
    hp = jax_build(csr, parts, tiled=True, chunk_nnz=16, rows_per_block=16)
    mesh = jax_mesh(data=parts, model=1, devices=jax.devices()[:parts])
    Bd = jax.device_put(jax_pad(hp, jnp.asarray(B)),
                        NamedSharding(mesh, P("data", None)))
    gj = jnp.asarray(g)

    def loss(b, v):
        kw = {}
        if v is not None:
            dv, hv = jax_split(hp, v)
            kw = dict(diag_vals=dv, halo_vals=hv)
        out = jax_halo_spmm(hp, b, mesh, reduce=reduce, method="tiled",
                            model_axis=None, **kw)[:N]
        return jnp.vdot(out, gj), out

    v = None if vals is None else jnp.asarray(vals)
    argnums = (0,) if v is None else (0, 1)
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=argnums, has_aux=True))(Bd, v)
    return (np.asarray(out), np.asarray(grads[0])[:N],
            None if v is None else np.asarray(grads[1]))


def _port_result(case, L=L_WALK):
    parts, reduce, kind = case
    mat, B, g, vals = _inputs(case)
    csr = csr_from_scipy(mat)
    if kind == "binary":
        csr = csr.with_data(None)
    hp = build_halo_partition(csr, parts, device="cpu", seg_len=L)
    assert hp.joint_split.split.num_segments > 0
    Bt = pad_for_halo(hp, torch.from_numpy(B)).requires_grad_(True)
    kw, v = {}, None
    if vals is not None:
        v = torch.from_numpy(vals).requires_grad_(True)
        dv, hv = split_edge_values(hp, v)
        kw = dict(diag_vals=dv, halo_vals=hv)
    out = halo_spmm(hp, Bt, make_mesh(parts, device="cpu"), reduce=reduce,
                    method="tiled", **kw)[:N]
    (out * torch.from_numpy(g)).sum().backward()
    return (out.detach().numpy(), Bt.grad.numpy()[:N],
            None if v is None else v.grad.numpy())


def _close(got, want, floor):
    scale = float(np.abs(want).max())
    bound = 1e-5 * scale + 1e-6 if floor == "value" else 1e-5 * max(scale, 1)
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_walk_matches_jax(case):
    """Values and gradients (B and edge values) of the split walk against
    the JAX tiled tier."""
    want_out, want_gB, want_gv = _jax_result(case)
    out, gB, gv = _port_result(case)
    if case[1] in ("max", "min"):
        np.testing.assert_array_equal(out, want_out)
    else:
        _close(out, want_out, "value")
    _close(gB, want_gB, "grad")
    if want_gv is None:
        assert gv is None
    else:
        _close(gv, want_gv, "grad")


def _stacked(hp, B, vals, reduce, split=True):
    """Row 7 over all shards of ``hp`` through the kernel's entry."""
    Bp = pad_for_halo(hp, B)
    halo = make_exchange(hp, make_mesh(hp.num_parts, device="cpu"))(Bp)
    dv, hv = (None, None) if vals is None else split_edge_values(hp, vals)
    return khalo.halo_spmm_stacked(
        hp.diag_indptr, hp.diag_indices, dv, Bp, hp.halo_indptr,
        hp.halo_indices, hv, halo, reduce,
        split=hp.joint_split if split else None), Bp, halo, dv, hv


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("reduce", ["max", "min"])
@pytest.mark.parametrize("kind", ["binary", "vals"])
def test_pair_fold_equals_the_unsplit_walk(kind, reduce, parts, L):
    """Split max/min out and ties equal the unsplit plain walk, shard by
    shard, exactly; B in multiples of 1/2, so rows meet ties."""
    mat = hub_graph()
    csr = csr_from_scipy(mat)
    if kind == "binary":
        csr = csr.with_data(None)
    hp = build_halo_partition(csr, parts, device="cpu", seg_len=L)
    rng = np.random.default_rng(parts + L)
    B = torch.from_numpy((np.round(rng.standard_normal((N, 8)) * 2) / 2)
                         .astype(np.float32))
    vals = None if kind == "binary" else torch.from_numpy(mat.data)
    (out, ties), Bp, halo, dv, hv = _stacked(hp, B, vals, reduce)
    assert hp.joint_split.split.num_segments > 0
    for p in range(parts):
        blk = hp.blocks(p)
        want, want_ties = reference.halo_spmm_rows(
            blk.d_rows, blk.d_indices,
            None if dv is None else dv[p, :hp.diag_nnz[p]],
            Bp[p * hp.cpp:(p + 1) * hp.cpp], blk.h_rows, blk.h_indices,
            None if hv is None else hv[p, :hp.halo_nnz[p]], halo[p], hp.rpp,
            reduce)
        rows = slice(p * hp.rpp, (p + 1) * hp.rpp)
        assert torch.equal(out[rows], want)
        assert torch.equal(ties[rows], want_ties)
    assert (ties > 1).any()


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("L", [1, 4, 64])
@pytest.mark.parametrize("parts", [1, 4])
def test_split_sum_against_scipy_float64(parts, L, heads):
    """The split sum in float64, one value or one per head an edge: the
    scipy product (per head block) to rounding."""
    mat = hub_graph()
    rng = np.random.default_rng(L + heads)
    K = 6
    B = rng.standard_normal((N, K))
    vals = rng.standard_normal((mat.nnz, heads) if heads > 1 else mat.nnz)
    hp = build_halo_partition(csr_from_scipy(mat), parts, device="cpu",
                              seg_len=L)
    (out, ties), *_ = _stacked(hp, torch.from_numpy(B), torch.from_numpy(vals),
                               "sum")
    assert ties is None and out.dtype == torch.float64
    dh = K // heads
    for h in range(heads):
        v = vals if heads == 1 else vals[:, h]
        want = sp.csr_matrix((v, mat.indices, mat.indptr),
                             shape=mat.shape) @ B[:, h * dh:(h + 1) * dh]
        np.testing.assert_allclose(out.numpy()[:N, h * dh:(h + 1) * dh], want,
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind,reduce", [
    (k, r) for k in ("binary", "vals", "heads2") for r in ("sum", "max", "min")
    if k != "heads2" or r == "sum"])
def test_all_shards_op_equals_the_op_shard_by_shard(kind, reduce):
    """The all-shards autograd op over shards [0, 4) against the same op
    over [p, p + 1) for each shard p: out, grad_B, grad_halo and the value
    gradients (per-head values are sum only)."""
    mat = hub_graph()
    csr = csr_from_scipy(mat)
    if kind == "binary":
        csr = csr.with_data(None)
    parts = 4
    hp = build_halo_partition(csr, parts, device="cpu", seg_len=L_WALK)
    rng = np.random.default_rng(5)
    K = 8
    B = pad_for_halo(hp, torch.from_numpy(
        (np.round(rng.standard_normal((N, K)) * 2) / 2).astype(np.float32)))
    halo = make_exchange(hp, make_mesh(parts, device="cpu"))(B)
    g = torch.from_numpy(rng.standard_normal((parts * hp.rpp, K))
                         .astype(np.float32))
    dv = hv = None
    if kind != "binary":
        shape = (mat.nnz, 2) if kind == "heads2" else (mat.nnz,)
        dv, hv = split_edge_values(hp, torch.from_numpy(
            (rng.integers(1, 9, shape) / 4.0).astype(np.float32)))

    def run(lo, hi):
        leaves = [None if t is None else t.detach().clone().requires_grad_()
                  for t in (dv, hv)]
        Bl = B[lo * hp.cpp:hi * hp.cpp].clone().requires_grad_()
        hl = halo[lo:hi].clone().requires_grad_()
        out = _HaloShards.apply(
            hp, lo, hi, reduce, *(None if t is None else t[lo:hi]
                                  for t in leaves), Bl, hl)
        out.backward(g[lo * hp.rpp:hi * hp.rpp])
        return [out.detach(), Bl.grad, hl.grad] + [
            None if t is None else t.grad[lo:hi] for t in leaves]

    whole = run(0, parts)
    by_shard = [run(p, p + 1) for p in range(parts)]
    for i, got in enumerate(whole):
        if got is None:
            assert all(s[i] is None for s in by_shard)
            continue
        want = torch.cat([s[i] for s in by_shard])
        if reduce != "sum" and i == 0:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
