"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one.  The file imports neither JAX nor the JAX package, so on a
machine with the card it runs without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Sum kernel error bound, against the plain version in float64:
|out - ref| <= 1e-5 * (|A| @ |B|) + 1e-6 for f32, 8e-3 * (|A| @ |B|) for
bf16 (one output rounding to bf16 is 2**-8 relative).  Max/min forward: out
and ties equal the plain version exactly (the same f32 products, selected,
not summed).  Max/min backward: grad_B and grad_values within 1e-5 of the
float64 plain version, relative to the largest reference value.
"""

import numpy as np
import pytest
import torch

from gespmm_tpu_torch.kernels import spmm_csr as kspmm
from gespmm_tpu_torch.kernels import spmm_minmax as kmm
from gespmm_tpu_torch.models.gcn import GCN
from gespmm_tpu_torch.models.sage import GraphSAGE
from gespmm_tpu_torch.ops import reference as ref
from gespmm_tpu_torch.ops.graph import add_self_loops
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.sparse.formats import CSR
from gespmm_tpu_torch.train.loop import train_node_classifier
from gespmm_tpu_torch.utils import timing
from gespmm_tpu_torch.utils.datasets import sbm_graph

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def skewed_csr(m=3000, n=2500, seed=0) -> CSR:
    """Random degrees 0..20, m/10 empty rows and one hub row (degree 2000
    at the default size)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, min(21, n), size=m)
    deg[rng.choice(m, m // 10, replace=False)] = 0
    deg[7] = min(2000, n * 4 // 5)
    rows = np.repeat(np.arange(m), deg)
    cols = np.concatenate([np.sort(rng.choice(n, d, replace=False)) for d in deg])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    data = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return CSR(torch.from_numpy(indptr), torch.from_numpy(cols.astype(np.int32)),
               torch.from_numpy(data), (m, n))


def check_bound(out, csr, B, data):
    rows = csr.row_ids()
    m = csr.shape[0]
    d64 = None if data is None else data.double()
    exact = ref.spmm_rows(rows, csr.indices, d64, B.double(), m)
    mag = ref.spmm_rows(rows, csr.indices, None if d64 is None else d64.abs(),
                        B.double().abs(), m)
    bound = 8e-3 * mag if B.dtype == torch.bfloat16 else 1e-5 * mag + 1e-6
    err = (out.double() - exact).abs()
    assert torch.isfinite(out.double()).all()
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 3, 32, 33, 128, 130, 512])
def test_kernel_matches_plain(dev, K, binary, dtype):
    csr = skewed_csr().to(dev)
    data = None if binary else csr.data
    B = torch.randn(csr.shape[1], K, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(K)).to(dtype)
    before = kspmm.launches
    out = kspmm.spmm_csr(csr.indptr, csr.indices, data, B)
    torch.cuda.synchronize()
    assert kspmm.launches == before + 1
    assert out.dtype == dtype and out.shape == (csr.shape[0], K)
    check_bound(out, csr, B, data)
    empty = (csr.indptr[1:] == csr.indptr[:-1]).nonzero()[:, 0]
    assert not out[empty].any()


def test_kernel_is_deterministic(dev):
    csr = skewed_csr().to(dev)
    B = torch.randn(csr.shape[1], 64, device=dev)
    a = kspmm.spmm_csr(csr.indptr, csr.indices, csr.data, B)
    b = kspmm.spmm_csr(csr.indptr, csr.indices, csr.data, B)
    assert torch.equal(a, b)


def test_empty_work_returns_zeros_without_launch(dev):
    before = kspmm.launches
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    out = kspmm.spmm_csr(torch.zeros(6, dtype=torch.int32, device=dev), z[:0],
                         None, torch.ones(4, 8, device=dev))
    assert out.shape == (5, 8) and not out.any()
    out = kspmm.spmm_csr(z, z[:0], None, torch.ones(4, 8, device=dev))
    assert out.shape == (0, 8)
    assert kspmm.launches == before


def test_device_time_times_the_device_not_the_host(dev):
    csr = skewed_csr().to(dev)
    B = torch.randn(csr.shape[1], 32, device=dev)

    def once():
        return kspmm.spmm_csr(csr.indptr, csr.indices, csr.data, B)

    def twice():
        once()
        return once()

    t1, t2 = timing.device_time(once), timing.device_time(twice)
    # Queued back to back, two launches take twice the device time of one;
    # events around unqueued calls can only be slower (they add host time).
    assert 0 < t1 <= 1.1 * timing.benchmark(once).mean_s
    assert 1.5 * t1 <= t2 <= 2.5 * t1


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    csr = skewed_csr(50, 40).to(dev)
    B = torch.randn(40, 8, device=dev)
    with pytest.raises(TypeError):
        kspmm.spmm_csr(csr.indptr, csr.indices, None, B.double())
    with pytest.raises(ValueError, match="contiguous"):
        kspmm.spmm_csr(csr.indptr, csr.indices, None, B.t().contiguous().t())
    with pytest.raises(ValueError, match="is on"):
        kspmm.spmm_csr(csr.indptr.cpu(), csr.indices, None, B)
    with pytest.raises(TypeError, match="int32"):
        kspmm.spmm_csr(csr.indptr.long(), csr.indices, None, B)
    with pytest.raises(ValueError, match="values"):
        kspmm.spmm_csr(csr.indptr, csr.indices, csr.data[:-1], B)


def test_autograd_on_card_matches_plain(dev):
    csr = skewed_csr(800, 700, seed=1)
    adj = Adjacency.from_csr(csr, device=dev)
    d = adj.data.clone().requires_grad_(True)
    adj = adj.with_data(d)
    B = torch.randn(700, 32, device=dev, requires_grad=True)
    g = torch.randn(800, 32, device=dev)
    before = kspmm.launches
    spmm(adj, B).backward(g)
    assert kspmm.launches == before + 2  # forward over the CSR, grad_B over the CSC
    adj64 = Adjacency.from_csr(csr)
    d64 = csr.data.double().requires_grad_(True)
    B64 = B.detach().cpu().double().requires_grad_(True)
    spmm(adj64.with_data(d64), B64, method="xla").backward(g.cpu().double())
    torch.testing.assert_close(B.grad.cpu().double(), B64.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d.grad.cpu().double(), d64.grad, rtol=1e-5, atol=1e-5)


def test_gcn_training_goes_through_the_kernel(dev):
    ds = sbm_graph(n_per_class=300, num_classes=3, p_in=0.02, p_out=0.001,
                   feat_dim=32, seed=0).to(dev)
    adj = Adjacency.from_csr(add_self_loops(ds.csr))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = GCN([32, 16, 3], generator=gen, device=dev).with_norms(adj)
    kspmm.reset_launches()
    res = train_node_classifier(model, adj, ds.features, ds.labels, ds.masks,
                                epochs=20)
    assert kspmm.launches >= 4 * 20
    loss = res["history"]["loss"]
    assert loss[-1] < loss[0] and np.all(np.isfinite(loss))
    assert res["train_acc"] > 1 / 3

    kspmm.reset_launches()
    model.method = "xla"
    train_node_classifier(model, adj, ds.features, ds.labels, ds.masks, epochs=3)
    assert kspmm.launches == 0


@pytest.mark.parametrize("view", ["column slice", "transposed"])
def test_spmm_takes_a_non_contiguous_B(dev, view):
    # A column slice or a transposed view is a valid operand of the op; the
    # op hands the kernel a contiguous copy.
    csr = skewed_csr(300, 250, seed=3)
    adj = Adjacency.from_csr(csr, device=dev)
    full = torch.randn(250, 40, device=dev)
    B = full[:, :16] if view == "column slice" else torch.randn(
        16, 250, device=dev).t()
    assert not B.is_contiguous()
    for reduce in ("sum", "max"):
        out = spmm(adj, B, reduce=reduce)
        want = spmm(adj, B.contiguous(), reduce=reduce, method="xla")
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def quantized(shape, dev, seed, dtype=torch.float32):
    """Multiples of 0.5, so that many contributions tie exactly."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.round(torch.randn(shape, device=dev, generator=g) * 2) / 2).to(dtype)


@pytest.mark.parametrize("dtype,binary", [(torch.float32, True),
                                          (torch.float32, False),
                                          (torch.bfloat16, True),
                                          (torch.bfloat16, False)])
@pytest.mark.parametrize("K", [1, 3, 16, 33, 128, 130])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_minmax_kernel_matches_plain(dev, reduce, K, dtype, binary):
    csr = skewed_csr().to(dev)
    data = None if binary else csr.data
    B = quantized((csr.shape[1], K), dev, K, dtype)
    before = kmm.launches
    out, ties = kmm.spmm_minmax(csr.indptr, csr.indices, data, B, reduce)
    torch.cuda.synchronize()
    assert kmm.launches == before + 1
    assert out.dtype == dtype and ties.dtype == torch.float32
    want, want_ties = ref.spmm_minmax_rows(csr.row_ids(), csr.indices, data, B,
                                           csr.shape[0], reduce)
    assert torch.equal(out, want) and torch.equal(ties, want_ties)
    assert ties.max() > 1
    empty = (csr.indptr[1:] == csr.indptr[:-1]).nonzero()[:, 0]
    assert not out[empty].any() and not ties[empty].any()


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 16, 33, 128, 130])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_minmax_vjp_kernel_matches_float64(dev, reduce, K, binary):
    csr = skewed_csr(seed=4).to(dev)
    adj = Adjacency.from_csr(csr)
    data = None if binary else adj.csc.data
    B = torch.relu(quantized((csr.shape[1], K), dev, K))  # zeros tie often
    out, ties = kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices,
                                None if binary else adj.data, B, reduce)
    g = torch.randn(csr.shape[0], K, device=dev)
    before = kmm.vjp_launches
    grad_B, grad_vals = kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices,
                                            data, B, out, g, ties)
    torch.cuda.synchronize()
    assert kmm.vjp_launches == before + 1
    gt64 = g.double() / torch.clamp(ties, min=1.0).double()
    want_B, want_vals = ref.spmm_minmax_vjp_cols(
        adj.rows_t, adj.csc.indices, data, B, out, gt64)
    for got, want in ((grad_B, want_B), (grad_vals, want_vals)):
        if want is None:
            assert got is None
            continue
        scale = max(float(want.abs().max()), 1.0)
        assert float((got.double() - want).abs().max()) <= 1e-5 * scale


def test_minmax_kernels_are_deterministic(dev):
    csr = skewed_csr().to(dev)
    adj = Adjacency.from_csr(csr)
    B = torch.relu(quantized((csr.shape[1], 130), dev, 1))  # 3 K slabs
    out, ties = kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices, adj.data, B,
                                "max")
    g = torch.randn(csr.shape[0], 130, device=dev)
    runs = [kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices, adj.csc.data,
                                B, out, g, ties) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_minmax_empty_work_and_refusals(dev):
    before = (kmm.launches, kmm.vjp_launches)
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    out, ties = kmm.spmm_minmax(torch.zeros(6, dtype=torch.int32, device=dev),
                                z[:0], None, torch.ones(4, 8, device=dev), "min")
    assert out.shape == ties.shape == (5, 8) and not out.any() and not ties.any()
    assert (kmm.launches, kmm.vjp_launches) == before
    csr = skewed_csr(50, 40).to(dev)
    B = torch.randn(40, 8, device=dev)
    with pytest.raises(ValueError, match="max"):
        kmm.spmm_minmax(csr.indptr, csr.indices, None, B, "sum")
    with pytest.raises(ValueError, match="contiguous"):
        kmm.spmm_minmax_cuda(csr.indptr, csr.indices, None, B.t().contiguous().t(),
                             "max")
    adj = Adjacency.from_csr(csr)
    out, ties = kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices, None, B, "max")
    with pytest.raises(ValueError, match="g_over_ties"):
        kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices, None, B, out,
                            torch.ones_like(out[:-1]), ties[:-1])
    with pytest.raises(TypeError, match="out"):
        kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices, None, B,
                            out.double(), torch.ones_like(out), ties)


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_minmax_autograd_on_card_matches_plain(dev, reduce):
    csr = skewed_csr(800, 700, seed=1)
    adj = Adjacency.from_csr(csr, device=dev)
    d = adj.data.clone().requires_grad_(True)
    B = torch.relu(quantized((700, 32), dev, 2)).requires_grad_(True)
    g = torch.randn(800, 32, device=dev)
    before = (kmm.launches, kmm.vjp_launches)
    spmm(adj.with_data(d), B, reduce=reduce).backward(g)
    assert (kmm.launches, kmm.vjp_launches) == (before[0] + 1, before[1] + 1)
    d64 = csr.data.double().requires_grad_(True)
    B64 = B.detach().cpu().double().requires_grad_(True)
    spmm(Adjacency.from_csr(csr).with_data(d64), B64, reduce=reduce,
         method="xla").backward(g.cpu().double())
    torch.testing.assert_close(B.grad.cpu().double(), B64.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d.grad.cpu().double(), d64.grad, rtol=1e-5, atol=1e-5)


def test_sage_pool_training_goes_through_the_kernels(dev):
    ds = sbm_graph(n_per_class=300, num_classes=3, p_in=0.02, p_out=0.001,
                   feat_dim=32, seed=0).to(dev)
    adj = Adjacency.from_csr(ds.csr)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = GraphSAGE([32, 16, 3], aggregator="pool", generator=gen, device=dev)
    kmm.reset_launches()
    res = train_node_classifier(model, adj, ds.features, ds.labels, ds.masks,
                                epochs=20)
    assert kmm.launches >= 2 * 20 and kmm.vjp_launches >= 2 * 20
    loss = res["history"]["loss"]
    assert loss[-1] < loss[0] and np.all(np.isfinite(loss))
    assert res["train_acc"] > 1 / 3

    kmm.reset_launches()
    model.method = "xla"
    train_node_classifier(model, adj, ds.features, ds.labels, ds.masks, epochs=3)
    assert kmm.launches == kmm.vjp_launches == 0
