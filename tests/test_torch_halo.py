"""``halo_spmm`` of the port against the JAX package's, on the CPU.

The same graph, B and runtime edge values (made with numpy) go through the
JAX ``halo_spmm`` on an 8-device virtual mesh (its ``tiled`` tier runs the
Pallas stream kernel in interpret mode) and through the port's, P shards in
one process (its ``tiled`` tier runs kernel row 7's plain version here).
Each JAX result is computed once.  Tolerances: values 1e-5 * max |ref| +
1e-6, max/min values exact; gradients 1e-4 * max(|ref|, 1).  B is in
multiples of 0.5 and the graph has empty rows, so max/min meet ties (the
tiled tiers split a row's gradient evenly among all its achieving edges,
diag and halo together; the xla tiers per block, halved across a tie
between the blocks, as in the JAX package).  Row 7's plain version is also
held to a float64 scipy/numpy oracle, ties and empty rows included.
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
from gespmm_tpu_torch.parallel.halo import make_exchange, split_edge_values
from gespmm_tpu_torch.sparse.formats import csr_from_scipy

M = 64
EMPTY_ROWS = (5, 17, 40)
# (parts, reduce, JAX tier, values): "vals" = runtime values, one an edge;
# "binary" = none; "heads<H>" = per-head runtime values over K = 12.
CASES = [
    (2, "sum", "tiled", "vals"), (4, "sum", "tiled", "vals"),
    (8, "sum", "tiled", "vals"), (4, "sum", "xla", "vals"),
    (2, "max", "tiled", "binary"), (4, "max", "tiled", "binary"),
    (8, "max", "tiled", "binary"), (4, "max", "xla", "binary"),
    (4, "max", "tiled", "vals"), (8, "min", "tiled", "binary"),
    (2, "min", "xla", "binary"), (4, "mean", "tiled", "vals"),
    (8, "mean", "xla", "vals"), (2, "sum", "tiled", "heads2"),
    (4, "sum", "tiled", "heads3"),
]


@functools.lru_cache(maxsize=None)
def _graph():
    rng = np.random.default_rng(7)
    mat = sp.random(M, M, density=0.12, random_state=rng, format="csr",
                    dtype=np.float64)
    mat.data = rng.standard_normal(mat.nnz)
    mat = mat.astype(np.float32)
    for r in EMPTY_ROWS:
        mat.data[mat.indptr[r]: mat.indptr[r + 1]] = 0
    mat.eliminate_zeros()
    mat.sort_indices()
    return mat


def _inputs(case):
    parts, reduce, method, kind = case
    rng = np.random.default_rng(parts * 10 + len(reduce))
    mat = _graph()
    heads = int(kind[5:]) if kind.startswith("heads") else 0
    K = 12 if heads else 8
    B = (np.round(rng.standard_normal((M, K)) * 2) / 2).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    vals = None
    if kind != "binary":
        shape = (mat.nnz, heads) if heads else (mat.nnz,)
        vals = rng.standard_normal(shape).astype(np.float32)
    return mat, B, g, vals


@functools.lru_cache(maxsize=None)
def _jax_result(case):
    """(out, grad_B, grad_vals) of the JAX halo_spmm, numpy."""
    parts, reduce, method, kind = case
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
        out = jax_halo_spmm(hp, b, mesh, reduce=reduce, method=method,
                            model_axis=None, **kw)[:M]
        return jnp.vdot(out, gj), out

    v = None if vals is None else jnp.asarray(vals)
    argnums = (0,) if v is None else (0, 1)
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=argnums, has_aux=True))(Bd, v)
    return (np.asarray(out), np.asarray(grads[0])[:M],
            None if v is None else np.asarray(grads[1]))


def _port_result(case, method=None):
    parts, reduce, jax_method, kind = case
    mat, B, g, vals = _inputs(case)
    csr = csr_from_scipy(mat)
    if kind == "binary":
        csr = csr.with_data(None)
    hp = build_halo_partition(csr, parts, device="cpu")
    mesh = make_mesh(parts, device="cpu")
    Bt = pad_for_halo(hp, torch.from_numpy(B)).requires_grad_(True)
    kw, v = {}, None
    if vals is not None:
        v = torch.from_numpy(vals).requires_grad_(True)
        dv, hv = split_edge_values(hp, v)
        kw = dict(diag_vals=dv, halo_vals=hv)
    out = halo_spmm(hp, Bt, mesh, reduce=reduce,
                    method=method or jax_method, **kw)[:M]
    (out * torch.from_numpy(g)).sum().backward()
    return (out.detach().numpy(), Bt.grad.numpy()[:M],
            None if v is None else v.grad.numpy())


def _close(got, want, tol, floor):
    scale = float(np.abs(want).max()) if want.size else 0.0
    bound = tol * scale + 1e-6 if floor == "value" else tol * max(scale, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_halo_spmm_matches_jax(case):
    """Values and gradients (B and runtime values) of the same tier."""
    reduce = case[1]
    want_out, want_gB, want_gv = _jax_result(case)
    out, gB, gv = _port_result(case)
    assert out.shape == want_out.shape
    if reduce in ("max", "min"):
        np.testing.assert_array_equal(out, want_out)
    else:
        _close(out, want_out, 1e-5, "value")
    _close(gB, want_gB, 1e-4, "grad")
    if want_gv is None:
        assert gv is None
    else:
        _close(gv, want_gv, 1e-4, "grad")


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "tiled"
                                  and not c[3].startswith("heads")][:4],
                         ids=lambda c: "-".join(map(str, c)))
def test_auto_and_xla_tiers_agree_with_the_tiled_tier(case):
    """The port's "auto" is its "tiled" (a tiled partition); its "xla"
    tier gives the same values (sum/mean)."""
    want = _port_result(case, "tiled")
    auto = _port_result(case, "auto")
    for a, b in zip(auto, want):
        np.testing.assert_array_equal(a, b)
    if case[1] in ("sum", "mean"):
        xla = _port_result(case, "xla")
        for a, b in zip(xla, want):
            _close(a, b, 1e-5, "grad")


def _row7_by_shard(mat, B, parts, reduce, vals=None):
    """(out, ties) of row 7's plain version, shard by shard, through the
    one-process exchange."""
    hp = build_halo_partition(csr_from_scipy(mat) if vals is not None
                              else csr_from_scipy(mat).with_data(None),
                              parts, device="cpu")
    Bp = pad_for_halo(hp, B)
    halo = make_exchange(hp, make_mesh(parts, device="cpu"))(Bp)
    dvs, hvs = (None, None) if vals is None else split_edge_values(hp, vals)
    outs, ties = [], []
    for p in range(parts):
        blk = hp.blocks(p)
        dv = None if dvs is None else dvs[p, :hp.diag_nnz[p]]
        hv = None if hvs is None else hvs[p, :hp.halo_nnz[p]]
        o, t = khalo.halo_spmm_rows(
            blk.d_indptr, blk.d_indices, dv, Bp[p * hp.cpp:(p + 1) * hp.cpp],
            blk.h_indptr, blk.h_indices, hv, halo[p], reduce)
        outs.append(o)
        ties.append(t)
    out = torch.cat(outs)[:M]
    return out, None if reduce == "sum" else torch.cat(ties)[:M]


@pytest.mark.parametrize("parts", (2, 4, 8))
@pytest.mark.parametrize("reduce", ("max", "min"))
def test_row7_plain_joint_ties_against_float64_oracle(reduce, parts):
    """Joint extremum and tie counts over both blocks, exactly; rows
    without an edge give 0 and 0."""
    mat = _graph()
    rng = np.random.default_rng(parts)
    B = (np.round(rng.standard_normal((M, 8)) * 2) / 2).astype(np.float32)
    out, ties = _row7_by_shard(mat, torch.from_numpy(B), parts, reduce)
    dense = mat.toarray() != 0
    contrib = np.where(dense[:, :, None], B[None].astype(np.float64),
                       -np.inf if reduce == "max" else np.inf)
    best = contrib.max(1) if reduce == "max" else contrib.min(1)
    want_ties = (contrib == best[:, None, :]).sum(1)
    best = np.where(np.isfinite(best), best, 0.0)
    want_ties = np.where(dense.any(1)[:, None], want_ties, 0)
    np.testing.assert_array_equal(out.numpy(), best)
    np.testing.assert_array_equal(ties.numpy(), want_ties)
    assert (ties.numpy() > 1).any()  # the case has ties
    assert (out.numpy()[list(EMPTY_ROWS)] == 0).all()


@pytest.mark.parametrize("reduce", ("max", "min"))
def test_row7_plain_masks_only_rows_without_an_edge(reduce):
    """Only a row without an edge is masked to 0: a ±inf or NaN extremum
    of a row with edges comes out as it is, in row 7's plain version and
    in the plain max/min SpMM."""
    big = float("inf") if reduce == "max" else float("-inf")
    d_rows = torch.tensor([0, 1, 1, 3])
    d_indices = torch.tensor([0, 1, 2, 3])
    B = torch.tensor([[big], [1.0], [float("nan")], [2.0]])
    out, ties = reference.halo_spmm_rows(d_rows, d_indices, None, B, None,
                                         None, None, None, 4, reduce)
    assert out[0, 0] == big and torch.isnan(out[1, 0])
    assert out[2, 0] == 0 and ties[2, 0] == 0
    assert out[3, 0] == 2.0 and ties[3, 0] == 1
    want = reference.spmm_rows(d_rows, d_indices, None, B, 4, reduce)
    torch.testing.assert_close(want, out, equal_nan=True)


@pytest.mark.parametrize("heads", (1, 2, 4))
@pytest.mark.parametrize("parts", (2, 8))
def test_row7_plain_sum_against_scipy_float64(parts, heads):
    """The sum, with one value or one per head an edge, in float64: the
    scipy product (per head block) to rounding."""
    mat = _graph()
    rng = np.random.default_rng(heads)
    K = 8
    B = rng.standard_normal((M, K))
    vals = rng.standard_normal((mat.nnz, heads) if heads > 1 else mat.nnz)
    out, _ = _row7_by_shard(mat, torch.from_numpy(B), parts, "sum",
                            torch.from_numpy(vals))
    dh = K // heads
    for h in range(heads):
        v = vals if heads == 1 else vals[:, h]
        A = sp.csr_matrix((v, mat.indices, mat.indptr), shape=mat.shape)
        want = A @ B[:, h * dh:(h + 1) * dh]
        np.testing.assert_allclose(out.numpy()[:, h * dh:(h + 1) * dh], want,
                                   rtol=1e-12, atol=1e-12)


def test_halo_errors_match_jax():
    """The JAX package's ValueErrors (``tests/test_dist.py:348``) and the
    runtime-value checks of ``halo_spmm``."""
    mat = sp.random(45, 45, density=0.1, format="csr", dtype=np.float32,
                    random_state=np.random.default_rng(31))
    mat.sort_indices()
    csr = csr_from_scipy(mat)
    mesh = make_mesh(2, device="cpu")
    hp = build_halo_partition(csr, 2, tiled=False, device="cpu")
    assert hp.num_parts * hp.cpp == 46  # padding IS required here
    B = torch.zeros(hp.num_parts * hp.cpp, 8)
    with pytest.raises(ValueError, match="tiled"):
        halo_spmm(hp, B, mesh, method="tiled")
    with pytest.raises(ValueError, match="pad"):
        halo_spmm(hp, torch.zeros(45, 8), mesh)
    with pytest.raises(ValueError, match="unknown reduce"):
        halo_spmm(hp, B, mesh, reduce="prod")
    tiled = build_halo_partition(csr, 2, device="cpu")
    dv, hv = split_edge_values(tiled, torch.ones(mat.nnz))
    with pytest.raises(ValueError, match="together"):
        halo_spmm(tiled, B, mesh, diag_vals=dv)
    dv3, hv3 = split_edge_values(tiled, torch.ones(mat.nnz, 2))
    with pytest.raises(ValueError, match="method='tiled'"):
        halo_spmm(tiled, B, mesh, method="xla", diag_vals=dv3, halo_vals=hv3)
    with pytest.raises(ValueError, match="max/min"):
        halo_spmm(tiled, B, mesh, reduce="max", diag_vals=dv3, halo_vals=hv3)
    with pytest.raises(ValueError, match="heads=2"):
        halo_spmm(tiled, torch.zeros(46, 7), mesh, diag_vals=dv3,
                  halo_vals=hv3)
    mesh22 = make_mesh(2, 2, device="cpu")
    assert (mesh22.data, mesh22.model, mesh22.local_slices) == (2, 2, (0, 1))
    with pytest.raises(ValueError, match="model=2"):
        halo_spmm(tiled, torch.zeros(46, 7), mesh22)
    with pytest.raises(ValueError, match="model_axis=None"):
        halo_spmm(tiled, torch.zeros(46, 8), mesh22, diag_vals=dv3,
                  halo_vals=hv3)
