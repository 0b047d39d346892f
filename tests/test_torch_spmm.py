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


@pytest.mark.parametrize("kw,item", [
    (dict(reduce="max"), "B2"), (dict(reduce="min"), "B2"),
    (dict(method="pallas"), "B5"), (dict(method="scatter"), "A2"),
    (dict(method="dense"), "A2"),
])
def test_not_ported_raise(kw, item):
    _, t = graph(False)
    with pytest.raises(NotImplementedError, match=item):
        tspmm(TAdjacency.from_csr(t), torch.zeros(N, 4), **kw)


@pytest.mark.parametrize("mode", ["trilo", "hilo", "fast", "highest"])
def test_every_mode_is_f32_grade(mode):
    j, t = graph(False)
    B = dense_B(8)
    ref = jspmm(JAdjacency.from_csr(j), jnp.asarray(B), method="xla")
    out = tspmm(TAdjacency.from_csr(t), torch.from_numpy(B), mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


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


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
