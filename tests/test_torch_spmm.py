"""Port parity: spmm (sum/mean), its gradients and its errors, against the JAX package.

Inputs are built with numpy from a seed and fed to both packages.  The JAX
side runs twice: through a plain ``Adjacency`` (the XLA tier) and through a
tiled plan, which runs the Pallas ``_reduce_kernel`` in interpret mode, as
``tests/test_stream.py`` does.  The port runs on the CPU here, i.e. through
the kernel's plain version.  Tolerance: rtol 1e-5, atol 1e-5 — both sides
accumulate in f32, in different orders.  The CUDA kernel itself is checked
in ``tests/test_torch_cuda.py``.
"""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gespmm_tpu.ops.spmm import Adjacency as JAdjacency
from gespmm_tpu.ops.spmm import spmm as jspmm
from gespmm_tpu.sparse import formats as jf

from gespmm_tpu_torch.kernels import _build
from gespmm_tpu_torch.kernels import spmm_csr as kspmm
from gespmm_tpu_torch.ops import reference as tref
from gespmm_tpu_torch.ops.spmm import Adjacency as TAdjacency
from gespmm_tpu_torch.ops.spmm import spmm as tspmm
from gespmm_tpu_torch.sparse import formats as tf

TOL = dict(rtol=1e-5, atol=1e-5)
M, N = 40, 36
EMPTY_ROWS = (0, 11, 39)
PLAN = dict(col_tile=16, rows_per_block=8, chunk_nnz=8, part_rows=24)


def graph(binary, seed=0):
    """(JAX CSR, port CSR) of a 40x36 matrix with empty rows."""
    rng = np.random.default_rng(seed)
    mat = sp.random(M, N, density=0.12, format="lil", random_state=rng,
                    dtype=np.float64)
    for r in EMPTY_ROWS:
        mat[r, :] = 0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    mat.sort_indices()
    indptr = mat.indptr.astype(np.int32)
    indices = mat.indices.astype(np.int32)
    data = None if binary else rng.standard_normal(mat.nnz).astype(np.float32)
    j = jf.CSR(jnp.asarray(indptr), jnp.asarray(indices),
               None if data is None else jnp.asarray(data), (M, N))
    t = tf.CSR(torch.from_numpy(indptr), torch.from_numpy(indices),
               None if data is None else torch.from_numpy(data), (M, N))
    return j, t


def dense_B(K, seed=1, rows=N):
    return np.random.default_rng(seed).standard_normal((rows, K)).astype(np.float32)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 3, 32, 130])
def test_spmm_matches_jax_xla(K, binary, reduce):
    j, t = graph(binary)
    B = dense_B(K)
    ref = jspmm(JAdjacency.from_csr(j), jnp.asarray(B), reduce=reduce,
                method="xla")
    out = tspmm(TAdjacency.from_csr(t), torch.from_numpy(B), reduce=reduce)
    assert out.dtype == torch.float32 and out.shape == (M, K)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.all(out.numpy()[list(EMPTY_ROWS)] == 0)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 3, 32, 130])
def test_spmm_matches_jax_tiled_kernel(K, binary):
    j, t = graph(binary)
    B = dense_B(K)
    ref = jspmm(JAdjacency.from_csr(j, plan=True, **PLAN), jnp.asarray(B),
                method="tiled")
    for method in ("auto", "tiled", "xla"):
        out = tspmm(TAdjacency.from_csr(t), torch.from_numpy(B), method=method)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _jax_grads(adj, data, B, W, reduce, method):
    def loss(d, b):
        a = adj if d is None else adj.with_data(d)
        return jnp.sum(jspmm(a, b, reduce=reduce, method=method) * W)

    if data is None:
        return None, jax.grad(lambda b: loss(None, b))(B)
    return jax.grad(loss, argnums=(0, 1))(data, B)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("jax_tier,reduce", [("xla", "sum"), ("xla", "mean"),
                                             ("tiled", "sum")])
def test_spmm_grads_match_jax(jax_tier, reduce, binary):
    j, t = graph(binary, seed=2)
    K = 32
    B, W = dense_B(K, seed=3), dense_B(K, seed=4, rows=M)
    jadj = (JAdjacency.from_csr(j, plan=True, **PLAN) if jax_tier == "tiled"
            else JAdjacency.from_csr(j))
    jgd, jgB = _jax_grads(jadj, j.data, jnp.asarray(B), jnp.asarray(W),
                          reduce, jax_tier)

    tadj = TAdjacency.from_csr(t)
    Bt = torch.from_numpy(B).requires_grad_(True)
    if not binary:
        d = t.data.clone().requires_grad_(True)
        tadj = tadj.with_data(d)
    tspmm(tadj, Bt, reduce=reduce).backward(torch.from_numpy(W))
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(jgB), **TOL)
    if not binary:
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(jgd), **TOL)


def test_grad_values_only_when_asked():
    _, t = graph(False)
    d = t.data.clone().requires_grad_(True)
    adj = TAdjacency.from_csr(t).with_data(d)
    B = torch.from_numpy(dense_B(8))  # no grad wanted for B
    tspmm(adj, B).sum().backward()
    assert d.grad is not None and B.grad is None
    np.testing.assert_allclose(
        d.grad.numpy(),
        tref.sddmm_rows(adj.rows, adj.csr.indices, torch.ones(M, 8), B).numpy(),
        **TOL)


def test_backward_takes_an_expanded_cotangent():
    _, t = graph(True)
    B = torch.from_numpy(dense_B(4)).requires_grad_(True)
    tspmm(TAdjacency.from_csr(t), B).sum().backward()  # g is an expanded view
    dense = t.todense().numpy()
    np.testing.assert_allclose(B.grad.numpy(), dense.T @ np.ones((M, 4)), **TOL)


def test_bare_csr_and_transpose():
    j, t = graph(False)
    B = dense_B(5)
    out = tspmm(t, torch.from_numpy(B))  # Adjacency built on the fly
    ref = jspmm(j, jnp.asarray(B))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    adj = TAdjacency.from_csr(t)
    Bt = dense_B(5, rows=M)
    np.testing.assert_allclose(
        tspmm(adj.transpose(), torch.from_numpy(Bt)).numpy(),
        np.asarray(jspmm(JAdjacency.from_csr(j).transpose(), jnp.asarray(Bt))),
        **TOL)


@pytest.mark.parametrize("binary", [False, True])
def test_bf16_in_bf16_out(binary):
    j, t = graph(binary)
    B = dense_B(16)
    Bb = torch.from_numpy(B).to(torch.bfloat16)
    out = tspmm(TAdjacency.from_csr(t), Bb)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    # Against JAX on the same bf16-rounded B, in f32: bf16 output rounding.
    ref = jspmm(JAdjacency.from_csr(j), jnp.asarray(Bb.float().numpy()))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=8e-3, atol=8e-3)


def test_shape_and_argument_errors():
    _, t = graph(False)
    adj = TAdjacency.from_csr(t)
    with pytest.raises(ValueError, match="rank 2"):
        tspmm(adj, torch.zeros(N))
    with pytest.raises(ValueError, match="inner dims"):
        tspmm(adj, torch.zeros(N + 1, 4))
    with pytest.raises(ValueError, match="mode"):
        tspmm(adj, torch.zeros(N, 4), mode="turbo")
    with pytest.raises(ValueError, match="method"):
        tspmm(adj, torch.zeros(N, 4), method="cusparse")
    with pytest.raises(ValueError, match="reduce"):
        tspmm(adj, torch.zeros(N, 4), reduce="prod")


@pytest.mark.parametrize("plan,kw,exc,match", [
    # The sum/mean-only tiers refuse max/min, as the JAX package's do.
    ("perrow", dict(method="pallas", reduce="max"), ValueError,
     "does not support reduce"),
    (False, dict(method="scatter", reduce="min"), ValueError,
     "does not support reduce"),
    (False, dict(method="dense", reduce="max"), ValueError,
     "does not support reduce"),
    # method="pallas" needs a per-row plan.
    (False, dict(method="pallas"), ValueError, "plan='perrow'"),
    (True, dict(method="pallas"), ValueError, "plan='perrow'"),
    # The grouped plan (kernel row 9) is sum/mean only, as in the JAX package.
    ("grouped", dict(method="pallas", reduce="max"), ValueError,
     "does not support reduce"),
])
def test_not_ported_raise(plan, kw, exc, match):
    j, t = graph(False)
    with pytest.raises(exc, match=match):
        tspmm(TAdjacency.from_csr(t, plan=plan), torch.zeros(N, 4), **kw)
    if exc is ValueError:  # the JAX package refuses the same call
        with pytest.raises(ValueError):
            jspmm(JAdjacency.from_csr(j, plan=plan, **PLAN), jnp.zeros((N, 4)),
                  **kw)


@pytest.mark.parametrize("mode", ["trilo", "hilo", "fast", "highest"])
def test_every_mode_is_f32_grade(mode):
    """Each mode against JAX's f32 result, at its contract: f32 grade, but
    "fast", which rounds B to bf16, within 8e-3·(|A|·|B|) (bf16's relative
    rounding 2**-9 with room for the f32 sums)."""
    j, t = graph(False)
    B = dense_B(8)
    ref = np.asarray(jspmm(JAdjacency.from_csr(j), jnp.asarray(B),
                           method="xla"))
    out = tspmm(TAdjacency.from_csr(t), torch.from_numpy(B), mode=mode)
    assert out.dtype == torch.float32
    if mode != "fast":
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
        return
    mag = tref.spmm_rows(t.row_ids(), t.indices, t.data.abs(),
                         torch.from_numpy(np.abs(B)), M).numpy()
    assert np.all(np.abs(out.numpy() - ref) <= 8e-3 * mag + 1e-6)
    assert not np.array_equal(out.numpy(), ref)  # B was rounded


@pytest.mark.parametrize("m,n,K", [(5, 6, 0), (0, 6, 3), (5, 6, 3)])
def test_empty_work(m, n, K):
    csr = tf.CSR(torch.zeros(m + 1, dtype=torch.int32),
                 torch.zeros(0, dtype=torch.int32), None, (m, n))
    out = tspmm(TAdjacency.from_csr(csr), torch.ones(n, K))
    assert out.shape == (m, K) and not out.any()


def test_wrapper_on_cpu_uses_plain_version_without_launching():
    _, t = graph(False)
    B = torch.from_numpy(dense_B(3))
    before = kspmm.launches
    out = kspmm.spmm_csr(t.indptr, t.indices, t.data, B)
    assert kspmm.launches == before
    plain = tref.spmm_rows(t.row_ids(), t.indices, t.data, B, M)
    assert torch.equal(out, plain)


def test_lane_vector_needs_width_and_alignment():
    buf = torch.zeros(4 * 130 + 1)
    assert kspmm.lane_vector(128, buf[:128]) == 4
    assert kspmm.lane_vector(64, buf[:64]) == 2
    assert kspmm.lane_vector(130, buf[:130]) == 2  # 130 % 4 != 0
    assert kspmm.lane_vector(16, buf[:16]) == 1  # narrow K: one column a lane
    assert kspmm.lane_vector(33, buf[:33]) == 1
    assert kspmm.lane_vector(128, buf[1:129]) == 1  # 4-byte offset
    assert kspmm.lane_vector(128, buf[2:130]) == 2  # 8-byte offset
    bf = torch.zeros(256, dtype=torch.bfloat16)
    assert kspmm.lane_vector(128, bf[4:132]) == 4  # 8 bytes is a bf16 4-vector


def test_csr_shape_walks_the_cells_narrow_widths_once():
    buf = torch.zeros(4 * 256 + 2)
    # The GCN and SAGE cells' widths: one walk at K = 47 (16-lane walkers of
    # three slabs, 47 of 48 lanes) and K = 100 (25 lanes of 4 columns); two
    # slabs of VEC 4 walked apart at K = 188 and 256.
    assert kspmm.csr_shape(47, buf[:47]) == (1, 16, 3)
    assert kspmm.csr_shape(100, buf[:100]) == (4, 32, 1)
    assert kspmm.csr_shape(188, buf[:188]) == (4, 32, 1)
    assert kspmm.csr_shape(256, buf[:256]) == (4, 32, 1)
    # Where lane_vector's one slab covers K, its shape on whole warps.
    for K, vec in ((1, 1), (32, 1), (64, 2), (128, 4)):
        assert kspmm.csr_shape(K, buf[:K]) == (vec, 32, 1)
    assert kspmm.csr_shape(48, buf[:48]) == (4, 32, 1)  # 12 lanes of 4 columns
    assert kspmm.csr_shape(33, buf[:33]) == (1, 16, 3)
    assert kspmm.csr_shape(49, buf[:49]) == (1, 32, 1)  # two walks, as before
    assert kspmm.csr_shape(130, buf[:130]) == (2, 32, 1)  # 130 % 4: 3 walks
    # Misalignment: VEC 1 needs none, so K = 47 keeps its one walk; K = 100
    # falls back to lane_vector's two slabs of VEC 2 (8-byte offset) or
    # four of VEC 1 (4-byte offset).
    assert kspmm.csr_shape(47, buf[1:48]) == (1, 16, 3)
    assert kspmm.csr_shape(100, buf[2:102]) == (2, 32, 1)
    assert kspmm.csr_shape(100, buf[1:101]) == (1, 32, 1)
    assert kspmm.csr_shape(256, buf[2:258]) == (2, 32, 1)
    assert kspmm.csr_shape(100, buf[:100], buf[1:101]) == (1, 32, 1)
    bf = torch.zeros(256, dtype=torch.bfloat16)
    assert kspmm.csr_shape(100, bf[4:104]) == (4, 32, 1)  # a bf16 4-vector
    assert kspmm.csr_shape(100, bf[2:102]) == (2, 32, 1)


# -- the nvcc build step (exercised with stand-in compilers) ----------------


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    nvcc = _fake_nvcc(tmp_path, 'echo "error: bad token" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="bad token"):
        _build.build("spmm_csr")
    assert os.listdir(tmp_path / "_build") == []  # no half-written library


def test_build_moves_library_into_place_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    count = tmp_path / "count"
    # Writes the -o target (the argument after -o) and counts invocations.
    nvcc = _fake_nvcc(tmp_path, (
        f'echo x >> "{count}"\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n'
    ))
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    lib = _build.build("spmm_csr")
    assert lib == _build.library_path("spmm_csr")
    assert lib.parent == tmp_path / "_build" and lib.read_text() == "lib\n"
    assert sorted(os.listdir(lib.parent)) == [lib.name]
    assert _build.build("spmm_csr") == lib  # the hash matches: no rebuild
    assert count.read_text() == "x\n"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "carry.cuh"\n')
    (tmp_path / "carry.cuh").write_text("// v1\n")
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    (tmp_path / "carry.cuh").write_text("// v2\n")
    assert _build.library_path("k") != before  # an edited header rebuilds
    assert (_build.PKG_DIR / "csrc" / "carry.cuh").is_file()


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
