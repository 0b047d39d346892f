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

The max/min forward with its row split (long rows' (extremum, count) pairs
folded by the pair carry): out and ties equal the unsplit plain version
exactly, an f32 out the float64 extremum rounded to f32.

Edge segment reduce: a max equals the plain version's exactly (selected,
not summed); a sum is within 1e-5 * (row sum of |vals|) + 1e-6 of float64
(bf16: 8e-3 *).  Fused GAT attention, against the plain version in float64:
out, mx and den within 1e-5 * max |ref| + 1e-6 (bf16 out: 8e-3 * max |ref|);
grad_src, grad_dst and grad_B within 1e-4 * max(|ref|, 1) (a bf16 grad_B:
8e-3 *), the backward's reference taking s = <g, out> from the kernel's
stored out, as the op does.  Fused dot-product attention: the same bounds
for out, mx, den and grad_D1, grad_D2, grad_B.  The nnz-chunked and the
grouped-gather SpMMs: the sum kernel's bound.  The joint diag+halo SpMM
(kernel row 7), one launch over all shards with long rows split: a sum
within the sum kernel's bound, max/min out and joint ties exactly (the
unsplit plain walk's); the sharded op's out and gradients within 1e-5 *
max(|ref|, 1) of the float64 whole-graph SpMM.

The cases of ``chip_smoke.py``'s phases 21-25 at test sizes: ``AdjacencyMatrix``
on the CSR kernel (the sum kernel's bound; no ``torch.sparse.mm``), the
stock baselines against ours (1e-5 * max |ref| + 1e-6) and training,
one ``GATStock`` step at pubmed scale within a quarter of a dense n x n f32
matrix of memory, SAGE-LSTM and the GAT's ``"pallas"`` route against their float64 forward on
the CPU (1e-4 * max |ref|), and a checkpointed GCN against a straight one
(1e-6 * max |ref|).  The "model" mesh axis in one process (``halo_spmm``
one row-7 launch a slice and equal to the data-only mesh; the sharded GCN's
launches and logits, 1e-5 * max |ref|) and the weak-scaling bench's
launches of rows 7 and 1.
"""

import functools
import json

import numpy as np
import pytest
import torch

from gespmm_tpu_torch.kernels import edge_reduce as kedge
from gespmm_tpu_torch.kernels import gat_fused as kgat
from gespmm_tpu_torch.kernels import halo_spmm as khalo
from gespmm_tpu_torch.kernels import spmm_csr as kspmm
from gespmm_tpu_torch.kernels import spmm_grouped as kgrp
from gespmm_tpu_torch.kernels import spmm_minmax as kmm
from gespmm_tpu_torch.kernels import spmm_pallas as kpal
from gespmm_tpu_torch.models.gat import GAT
from gespmm_tpu_torch.models.gcn import GCN
from gespmm_tpu_torch.models.sage import GraphSAGE
from gespmm_tpu_torch.ops import reference as ref
from gespmm_tpu_torch.ops.graph import (add_self_loops,
                                        additive_attention_logits,
                                        attention_aggregate, edge_softmax)
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.parallel import (build_halo_partition, halo_spmm,
                                       make_mesh)
from gespmm_tpu_torch.parallel.dryrun import dryrun_multichip
from gespmm_tpu_torch.parallel.halo import make_exchange, split_edge_values
from gespmm_tpu_torch.parallel.train_step import (build_sharded_gat,
                                                  build_sharded_gcn,
                                                  build_sharded_sage)
from gespmm_tpu_torch.sparse.formats import CSR
from gespmm_tpu_torch.sparse.partition import (SPLIT_LEN,
                                                build_grouped_plan,
                                                build_row_split,
                                                build_spmm_plan)
from gespmm_tpu_torch.sparse.reorder import inverse_permutation, reorder
from gespmm_tpu_torch.train.loop import train_node_classifier
from gespmm_tpu_torch.utils import timing
from gespmm_tpu_torch.utils.datasets import (rmat_graph, sbm_graph,
                                             split_boundary_graph)

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


def hub_csr(L, seed=0):
    """Rows of 0, L - 1, L, L + 1, 2L, 2L + 1 and 10,000 edges among rows of
    a few edges; n = 12,000."""
    rng = np.random.default_rng(seed)
    deg = np.r_[0, L - 1, L, L + 1, rng.integers(0, 5, 20), 10_000, 0,
                2 * L, 2 * L + 1, rng.integers(0, 5, 20)]
    n = 12_000
    cols = np.concatenate([np.sort(rng.choice(n, d, replace=False))
                           for d in deg])
    indptr = np.r_[0, np.cumsum(deg)].astype(np.int32)
    data = rng.standard_normal(cols.shape[0]).astype(np.float32)
    return CSR(torch.from_numpy(indptr), torch.from_numpy(cols.astype(np.int32)),
               torch.from_numpy(data), (deg.shape[0], n))


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("K", [1, 32, 33, 128, 130])
@pytest.mark.parametrize("L", [32, 64, 128, 256])
def test_split_kernel_at_each_boundary_and_a_hub(dev, L, K, dtype, out_dtype):
    # A row of L edges is one warp's walk, L + 1 two segments, the hub of
    # 10,000 edges ceil(10,000 / L) segments added by the carry in order.
    csr = hub_csr(L)
    adj = Adjacency.from_csr(csr, device=dev)
    split = build_row_split(csr.indptr, L).to(dev)
    assert split.long_rows.tolist() == [3, 24, 26, 27]
    B = randn((csr.shape[1], K), dev, K, dtype)
    kspmm.reset_launches()
    out = kspmm.spmm_csr(adj.csr.indptr, adj.csr.indices, adj.data, B,
                         split=split, out_dtype=out_dtype)
    again = kspmm.spmm_csr(adj.csr.indptr, adj.csr.indices, adj.data, B,
                           split=split, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (kspmm.launches, kspmm.carry_launches) == (2, 2)
    assert out.dtype == out_dtype and torch.equal(out, again)
    check_bound(out, adj.csr, B, adj.data)
    if out_dtype == torch.float32:  # bf16 in, f32 out: no output rounding
        check_bound(out, adj.csr, B.float(), adj.data)
    assert not out[0].any()


def test_split_kernel_adds_no_launch_without_a_long_row(dev):
    # sbm-pubmed's rows have at most 16 edges: one launch a call, as before.
    ds = sbm_graph(n_per_class=2000, num_classes=3, p_in=0.003, p_out=0.0001,
                   feat_dim=8, seed=0)
    adj = Adjacency.from_csr(add_self_loops(ds.csr), device=dev)
    assert adj.split.num_segments == adj.split_t.num_segments == 0
    B = randn((adj.shape[1], 32), dev, 1, requires_grad=True)
    kspmm.reset_launches()
    spmm(adj, B).backward(randn((adj.shape[0], 32), dev, 2))
    torch.cuda.synchronize()
    assert (kspmm.launches, kspmm.carry_launches) == (2, 0)


@pytest.mark.parametrize("K", [128, 32])
def test_auto_rule_launches_on_rmat15(dev, K):
    # Rows and columns longer than L: "auto" takes the split CSR kernel,
    # forward and grad_B, each with its carry, and no other kernel.
    adj = Adjacency.from_csr(rmat15(), device=dev)
    B = randn((adj.shape[1], K), dev, 1, requires_grad=True)
    g = randn((adj.shape[0], K), dev, 2)
    kspmm.reset_launches()
    kpal.reset_launches()
    kgrp.reset_launches()
    out = spmm(adj, B)
    out.backward(g)
    torch.cuda.synchronize()
    assert (kpal.launches, kgrp.launches, kspmm.launches,
            kspmm.carry_launches) == (0, 0, 2, 2)
    check_bound(out.detach(), adj.csr, B.detach(), None)
    t = adj.transpose()
    check_bound(B.grad, t.csr, g, None)


def test_split_kernel_on_rmat15_matches_float64(dev):
    # The hub row and column of degree 3,866 and 11,708 empty rows, over
    # the CSR and the CSC; two calls bitwise equal.
    adj = Adjacency.from_csr(rmat15(), device=dev)
    for indptr, indices, split, n_in in (
            (adj.csr.indptr, adj.csr.indices, adj.split, adj.shape[1]),
            (adj.csc.indptr, adj.csc.indices, adj.split_t, adj.shape[0])):
        csr = CSR(indptr, indices, None, (indptr.shape[0] - 1, n_in))
        B = randn((n_in, 128), dev, 4)
        out = kspmm.spmm_csr(indptr, indices, None, B, split=split)
        assert torch.equal(out, kspmm.spmm_csr(indptr, indices, None, B,
                                               split=split))
        check_bound(out, csr, B, None)


@pytest.mark.parametrize("binary", [False, True])
def test_mode_fast_on_the_card(dev, binary):
    # B rounded to bf16 once, gathered as bf16, f32 out, forward and grad_B:
    # within 8e-3 (|A| @ |B|) of float64, and exactly the kernel over the
    # rounded B.
    csr = skewed_csr()
    adj = Adjacency.from_csr(csr.with_data(None if binary else csr.data),
                             device=dev)
    B = randn((csr.shape[1], 64), dev, 1, requires_grad=True)
    g = randn((csr.shape[0], 64), dev, 2)
    out = spmm(adj, B, mode="fast")
    out.backward(g)
    assert out.dtype == B.grad.dtype == torch.float32
    Bq = B.detach().to(torch.bfloat16)
    check_bound(out.detach(), adj.csr, Bq.float(), adj.data)  # f32 sums
    assert torch.equal(out, kspmm.spmm_csr(adj.csr.indptr, adj.csr.indices,
                                           adj.data, Bq, split=adj.split,
                                           out_dtype=torch.float32))
    t = adj.transpose()
    assert torch.equal(B.grad, kspmm.spmm_csr(
        t.csr.indptr, t.csr.indices, t.data, g.to(torch.bfloat16),
        split=t.split, out_dtype=torch.float32))
    exact = spmm(adj.with_data(None if binary else adj.data.double()),
                 B.detach().double(), method="xla")
    mag = spmm(adj.with_data(None if binary else adj.data.double().abs()),
               B.detach().double().abs(), method="xla")
    assert ((out.double() - exact).abs() <= 8e-3 * mag).all()


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
    split = build_row_split(csr.indptr.cpu()).to(dev)  # a bare call syncs

    def once():
        return kspmm.spmm_csr(csr.indptr, csr.indices, csr.data, B,
                              split=split)

    def twice():
        once()
        return once()

    t1, t2 = timing.device_time(once), timing.device_time(twice)
    # Queued back to back, two launches take twice the device time of one;
    # events around unqueued calls can only be slower (they add host time).
    assert 0 < t1 <= 1.1 * timing.benchmark(once).mean_s
    assert 1.5 * t1 <= t2 <= 2.5 * t1


def test_device_time_refuses_a_call_that_syncs_the_host(dev):
    x = torch.randn(1 << 16, device=dev)

    def syncing():
        x.sum().item()
        return x

    with pytest.raises(timing.HostBehind):
        timing.device_time(syncing, iters=10)
    assert timing.device_time(lambda: x * 2, iters=10) > 0


@pytest.mark.parametrize("method,plan,K", [
    ("dense", False, 32), ("auto", False, 32), ("auto", False, 128),
    ("auto", "grouped", 32), ("pallas", "grouped", 32),
    ("pallas", "perrow", 32)])
def test_spmm_tiers_never_sync_the_host(dev, method, plan, K):
    # Forward and backward, with a hub row (the split's carry) and values.
    adj = Adjacency.from_csr(skewed_csr(), device=dev, plan=plan)
    d = adj.data.clone().requires_grad_(True)
    B = randn((adj.shape[1], K), dev, 1, requires_grad=True)
    g = randn((adj.shape[0], K), dev, 2)
    spmm(adj.with_data(d), B, method=method)  # first calls load libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = spmm(adj.with_data(d), B, method=method)
        out.backward(g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check_bound(out.detach(), adj.csr, B.detach(), adj.data)


def test_sweep_roofline_on_card(dev, capsys, tmp_path):
    from gespmm_tpu_torch.bench import spmm_bench

    spmm_bench.main(["--graphs", "rmat8", "--k", "8", "--methods", "tiled",
                     "pallas", "bcoo", "--validate", "--roofline", "--csv",
                     str(tmp_path / "out.csv")])
    cap = capsys.readouterr()
    assert "copy bandwidth measured" in cap.err and "errors" not in cap.err
    row = json.loads(cap.out.strip().splitlines()[-1])
    assert 0 < row["K=8-roofline-frac"] < 1
    assert all(row[f"K=8-{mt}-gflops"] > 0 for mt in ("tiled", "pallas",
                                                      "bcoo"))


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
                             "max", build_row_split(csr.indptr).to(dev))
    adj = Adjacency.from_csr(csr)
    out, ties = kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices, None, B, "max")
    with pytest.raises(ValueError, match="g must be"):
        kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices, None, B, out,
                            torch.ones_like(out[:-1]), ties)
    with pytest.raises(TypeError, match="out"):
        kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices, None, B,
                            out.double(), torch.ones_like(out), ties)
    # g in B's dtype: the kernel folds g / max(ties, 1) itself.
    with pytest.raises(TypeError, match="g must be"):
        kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices, None, B, out,
                            torch.ones_like(out).double(), ties)


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
    # No row or column above L edges: no carry.
    assert adj.split.num_segments == adj.split_t.num_segments == 0
    assert kmm.carry_launches == kmm.vjp_carry_launches == 0
    loss = res["history"]["loss"]
    assert loss[-1] < loss[0] and np.all(np.isfinite(loss))
    assert res["train_acc"] > 1 / 3

    kmm.reset_launches()
    model.method = "xla"
    train_node_classifier(model, adj, ds.features, ds.labels, ds.masks, epochs=3)
    assert kmm.launches == kmm.vjp_launches == 0


def minmax_vjp_vs_float64(adj, data, K, dtype, reduce, seed):
    """Row 3 over the adjacency's CSC with its split, twice: (grad_B,
    grad_vals) of the first run, whether the two are bitwise equal, and the
    float64 plain version's (grad_B, grad_vals) beside them."""
    dev = adj.csr.indptr.device
    csc_data = None if data is None else data[adj.perm.long()]
    B = torch.relu(quantized((adj.shape[1], K), dev, seed, dtype))
    out, ties = kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices, data, B,
                                reduce)
    g = randn((adj.shape[0], K), dev, seed + 1, dtype)
    runs = [kmm.spmm_minmax_vjp(adj.csc.indptr, adj.csc.indices, csc_data, B,
                                out, g, ties, split=adj.split_t)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = all(a is b or torch.equal(a, b) for a, b in zip(*runs))
    gt64 = g.double() / torch.clamp(ties, min=1.0).double()
    want = ref.spmm_minmax_vjp_cols(adj.rows_t, adj.csc.indices, csc_data, B,
                                    out, gt64)
    return runs[0], same, want


def assert_minmax_vjp_close(got, want, dtype):
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    for x, w in zip(got, want):
        if w is None:
            assert x is None
            continue
        assert torch.isfinite(x).all()
        err = float((x.double() - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1.0), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("K", [1, 16, 128, 130])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_minmax_vjp_split_at_each_boundary_and_a_hub(dev, reduce, K, binary,
                                                     dtype):
    # Columns of L - 1, L, L + 1, 2L + 1 and 10,000 edges: the long ones are
    # walked in segments and the carry adds them; two runs bitwise equal.
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    assert adj.split_t.long_rows.tolist() == [2, 3, 4]
    data = None if binary else randn((adj.nnz,), dev, 7)
    before = (kmm.vjp_launches, kmm.vjp_carry_launches)
    got, same, want = minmax_vjp_vs_float64(adj, data, K, dtype, reduce, K)
    assert (kmm.vjp_launches, kmm.vjp_carry_launches) == (before[0] + 2,
                                                          before[1] + 2)
    assert same
    assert_minmax_vjp_close(got, want, dtype)


# (K, VEC, SW): the walker widths walk_shape picks for row 3, every one a
# narrow walker below K = 128 (4 lanes at K = 1, 3 and 16).
MINMAX_WALKS = [(1, 1, 4), (3, 1, 4), (16, 4, 4), (32, 4, 8), (33, 1, 32),
                (64, 4, 16), (128, 4, 32), (130, 2, 32)]


@pytest.mark.parametrize("K,vec,lanes", MINMAX_WALKS)
def test_minmax_vjp_walkers_match_float64(dev, K, vec, lanes):
    assert kmm.walk_shape(K, 1, randn((1, K), dev, 0)) == (vec, lanes)
    csr = skewed_csr(seed=5).to(dev)
    adj = Adjacency.from_csr(csr)
    for binary in (True, False):
        for reduce in ("max", "min"):
            got, same, want = minmax_vjp_vs_float64(
                adj, None if binary else adj.data, K, torch.float32, reduce,
                K + 11)
            assert same
            assert_minmax_vjp_close(got, want, torch.float32)


def test_minmax_vjp_fold_in_the_kernel_equals_the_wrappers_fold(dev):
    # The kernel divides g by max(ties, 1) per achieving edge: on a binary
    # graph its grad_B equals, bit for bit, the plain split walk fed the
    # table g.float() / clamp(ties, min=1) (the same f32 adds in the same
    # edge and segment order); valued (an FMA a term in the kernel), within
    # row 3's bound.
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for data in (None, randn((adj.nnz,), dev, 3)):
            csc_data = None if data is None else data[adj.perm.long()]
            B = torch.relu(quantized((adj.shape[1], 16), dev, 4, dtype))
            out, ties = kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices, data,
                                        B, "max")
            g = randn((adj.shape[0], 16), dev, 5, dtype)
            grad_B, grad_vals = kmm.spmm_minmax_vjp(
                adj.csc.indptr, adj.csc.indices, csc_data, B, out, g, ties,
                split=adj.split_t)
            sp = adj.split_t.to("cpu")
            cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
            want_B, want_vals = ref.spmm_minmax_vjp_split_cols(
                adj.rows_t.cpu(), adj.csc.indptr.cpu(), adj.csc.indices.cpu(),
                cpu(csc_data), B.cpu(), out.cpu(),
                g.cpu().float() / torch.clamp(ties.cpu(), min=1.0),
                sp.seg_row, sp.long_rows, sp.seg_ptr, sp.seg_len)
            if data is None:
                assert torch.equal(grad_B.cpu(), want_B.to(dtype))
            else:
                assert_minmax_vjp_close(
                    (grad_B.cpu(), grad_vals.cpu()),
                    (want_B.double(), want_vals.double()), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts", [2, 4])
def test_minmax_vjp_stacked_matches_per_shard_plain(dev, parts, dtype):
    # One launch over all shards' transposed blocks, split at L = 8 (so the
    # skewed graph's hub columns and many others are cut), against row 3's
    # float64 plain version a shard at a time; two runs bitwise equal.
    hp = build_halo_partition(_square_skewed(), parts, device=dev, seg_len=8)
    mesh = make_mesh(parts, device=dev)
    B = (torch.round(randn((parts * hp.cpp, 33), dev, 6) * 2) / 2).to(dtype)
    halo = make_exchange(hp, mesh)(B)
    dvs, hvs = split_edge_values(hp, randn((hp.nnz,), dev, 7))
    out, ties = khalo.halo_spmm_stacked(
        hp.diag_indptr, hp.diag_indices, dvs, B, hp.halo_indptr,
        hp.halo_indices, hvs, halo, "max", split=hp.joint_split)
    g = randn((parts * hp.rpp, 33), dev, 8, dtype)
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    for blk, vals, table, split, n_t in (
            ("diag", dvs, B, hp.diag_t_split, hp.cpp),
            ("halo", hvs, halo.reshape(-1, 33), hp.halo_t_split,
             hp.halo_rows)):
        t_map = getattr(hp, f"{blk}_t_map")
        tv = torch.gather(vals, 1, t_map.long())
        args = (getattr(hp, f"{blk}_t_indptr"), getattr(hp, f"{blk}_t_rows"),
                tv, table, out, g, ties)
        assert split.split.num_segments > 0
        before = (kmm.vjp_launches, kmm.vjp_carry_launches)
        runs = [kmm.spmm_minmax_vjp_stacked(*args, split=split)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert (kmm.vjp_launches, kmm.vjp_carry_launches) == (before[0] + 2,
                                                              before[1] + 2)
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        grad_B, grad_vals = runs[0]
        for p in range(parts):
            k = getattr(hp, f"{blk}_nnz")[p]
            t_indptr = args[0][p]
            rows = slice(p * hp.rpp, (p + 1) * hp.rpp)
            want_B, want_v = ref.spmm_minmax_vjp_cols(
                torch.repeat_interleave(
                    torch.arange(n_t, device=dev),
                    (t_indptr[1:] - t_indptr[:-1]).long()),
                args[1][p, :k], tv[p, :k], table[p * n_t:(p + 1) * n_t],
                out[rows], g[rows].double()
                / torch.clamp(ties[rows], min=1.0).double())
            for got, w in ((grad_B[p * n_t:(p + 1) * n_t], want_B),
                           (grad_vals[p, :k], want_v)):
                err = float((got.double() - w).abs().max())
                assert err <= tol * max(float(w.abs().max()), 1.0), (blk, p)
            assert not grad_vals[p, k:].any()


def test_minmax_vjp_kernel_refuses_what_it_does_not_take(dev):
    # The entry point itself: a table not aligned to the lane vector, and
    # grad_values without values, are cudaErrorInvalidValue (1).
    fn, _ = kmm._entry("vjp", torch.float32)
    K, m, n = 8, 4, 3
    colptr = torch.tensor([0, 1, 2, 2], dtype=torch.int32, device=dev)
    rows = torch.tensor([0, 3], dtype=torch.int32, device=dev)
    vals = torch.ones(2, device=dev)
    tab = lambda r: torch.zeros(r * K + 1, device=dev)  # noqa: E731
    B, out, g, ties, grad_B = tab(n), tab(m), tab(m), tab(m), tab(n)
    partials = torch.zeros(4, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(B_ptr, vals_ptr, partials_ptr, vec=4):
        return fn(1, n, K, vec, 4, 0, 0, 0, 0, 0, 0, 2, m,
                  colptr.data_ptr(), rows.data_ptr(), vals_ptr, B_ptr,
                  out.data_ptr(), g.data_ptr(), ties.data_ptr(), None, None,
                  None, None, grad_B.data_ptr(), partials_ptr, None, stream)

    assert call(B.data_ptr(), vals.data_ptr(), partials.data_ptr()) == 0
    assert call(B[1:].data_ptr(), vals.data_ptr(), None) == 1
    assert call(B[1:].data_ptr(), vals.data_ptr(), None, vec=1) == 0
    assert call(B.data_ptr(), None, partials.data_ptr()) == 1
    torch.cuda.synchronize()


# --- edge segment reduce and fused GAT attention -------------------------


# --- the max/min forward (kernel row 2) with its row split ----------------


def minmax_fwd_vs_plain(adj, data, K, dtype, reduce, seed):
    """Row 2 over the adjacency's CSR with its split, twice: whether out and
    ties equal the plain version's (and an f32 out the float64 extremum
    rounded), whether the two runs are bitwise equal, the carries a run."""
    B = quantized((adj.shape[1], K), adj.csr.indptr.device, seed, dtype)
    before = (kmm.launches, kmm.carry_launches)
    runs = [kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices, data, B, reduce,
                            split=adj.split) for _ in range(2)]
    torch.cuda.synchronize()
    launched = (kmm.launches - before[0], kmm.carry_launches - before[1])
    (out, ties), again = runs
    same = all(torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32))
               for a, b in zip(runs[0], again))
    want, want_ties = ref.spmm_minmax_rows(adj.rows, adj.csr.indices, data, B,
                                           adj.shape[0], reduce)
    exact = torch.equal(out, want) and torch.equal(ties, want_ties)
    if dtype == torch.float32:
        want64 = ref.spmm_rows(adj.rows, adj.csr.indices,
                               None if data is None else data.double(),
                               B.double(), adj.shape[0], reduce=reduce)
        exact = exact and torch.equal(out, want64.float())
    return exact, same, launched, float(ties.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("K", [1, 3, 16, 32, 33, 128, 130])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_minmax_split_at_each_boundary_and_a_hub(dev, reduce, K, binary,
                                                 dtype):
    # Rows of L - 1, L, L + 1, 2L + 1 and 10,000 edges: the long ones are
    # walked in segments and the pair carry folds them.
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    assert adj.split.long_rows.tolist() == [2, 3, 4]
    data = None if binary else quantized((adj.nnz,), dev, 11)
    exact, same, launched, max_ties = minmax_fwd_vs_plain(adj, data, K, dtype,
                                                          reduce, K)
    assert exact and same and max_ties > 1
    assert launched == (2, 2)


@pytest.mark.parametrize("K", [16, 128])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_minmax_split_on_rmat15(dev, reduce, K):
    # The hub row of 3,866 edges, 11,708 empty rows.
    adj = Adjacency.from_csr(rmat15(), device=dev)
    for data in (None, quantized((adj.nnz,), dev, 12)):
        exact, same, launched, _ = minmax_fwd_vs_plain(adj, data, K,
                                                       torch.float32, reduce,
                                                       K + 1)
        assert exact and same and launched == (2, 2)


# K = 16: the walker built without the segment test; K >= 128 (whole-warp
# walkers): the first port's kernel, one warp a row.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [16, 128, 130, 512])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_minmax_without_a_long_row_launches_no_carry(dev, reduce, K, dtype):
    ds = sbm_graph(n_per_class=300, num_classes=3, p_in=0.02, p_out=0.001,
                   feat_dim=8, seed=0)
    adj = Adjacency.from_csr(ds.csr, device=dev)
    assert adj.split.num_segments == 0
    exact, same, launched, _ = minmax_fwd_vs_plain(adj, None, K, dtype,
                                                   reduce, 3)
    assert exact and same and launched == (2, 0)


# (K, VEC, SW) of row 2's walkers, as walk_shape picks them (row 3's).
@pytest.mark.parametrize("K,vec,lanes", MINMAX_WALKS)
def test_minmax_forward_walkers_match_plain(dev, K, vec, lanes):
    assert kmm.walk_shape(K, 1, randn((1, K), dev, 0)) == (vec, lanes)
    adj = Adjacency.from_csr(skewed_csr(seed=6), device=dev)
    assert adj.split.num_segments > 0  # the hub row of 2,000 edges
    for data in (None, adj.data):
        exact, same, launched, _ = minmax_fwd_vs_plain(adj, data, K,
                                                       torch.float32, "max",
                                                       K + 2)
        assert exact and same and launched == (2, 2)


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_minmax_op_never_takes_the_plain_version(dev, monkeypatch, reduce):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("spmm_minmax_rows", "spmm_minmax_split_rows",
                 "spmm_minmax_vjp_cols", "spmm_minmax_vjp_split_cols"):
        monkeypatch.setattr(ref, name, refuse)
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    B = torch.relu(quantized((adj.shape[1], 32), dev, 4)).requires_grad_(True)
    kmm.reset_launches()
    spmm(adj, B, reduce=reduce).sum().backward()
    torch.cuda.synchronize()
    assert (kmm.launches, kmm.carry_launches) == (1, 1)
    assert (kmm.vjp_launches, kmm.vjp_carry_launches) == (1, 1)
    with pytest.raises(AssertionError):
        kmm.spmm_minmax(adj.csr.indptr.cpu(), adj.csr.indices.cpu(), None,
                        B.detach().cpu(), reduce, split=adj.split)


def test_minmax_forward_refuses_a_split_elsewhere(dev):
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    B = torch.randn(adj.shape[1], 8, device=dev)
    with pytest.raises(ValueError, match="split"):
        kmm.spmm_minmax(adj.csr.indptr, adj.csr.indices, None, B, "max",
                        split=adj.split.to("cpu"))


def randn(shape, dev, seed, dtype=torch.float32, requires_grad=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, device=dev, generator=g).to(dtype).requires_grad_(
        requires_grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_edge_reduce_kernel_matches_plain(dev, op, K, dtype):
    csr = skewed_csr().to(dev)
    rows, m = csr.row_ids(), csr.shape[0]
    vals = randn((csr.nnz, K), dev, K, dtype)
    before = kedge.launches
    out = kedge.edge_segment_reduce(csr.indptr, vals, op)
    torch.cuda.synchronize()
    assert kedge.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, K)
    if op == "max":
        assert torch.equal(out, ref.edge_segment_rows(rows, vals, m, "max"))
    else:
        want = ref.edge_segment_rows(rows, vals.double(), m, "sum")
        mag = ref.edge_segment_rows(rows, vals.double().abs(), m, "sum")
        bound = 8e-3 * mag if dtype == torch.bfloat16 else 1e-5 * mag + 1e-6
        assert ((out.double() - want).abs() <= bound).all()
    empty = (csr.indptr[1:] == csr.indptr[:-1]).nonzero()[:, 0]
    assert not out[empty].any()


def edge_reduce_vs_plain(indptr, rows, vals, op, split):
    """Run the edge reduce twice with ``split``: (max exact | sum within
    the float64 bound, two runs bitwise equal, carries a run)."""
    m = indptr.shape[0] - 1
    before = kedge.carry_launches
    out, again = (kedge.edge_segment_reduce(indptr, vals, op, split=split)
                  for _ in range(2))
    torch.cuda.synchronize()
    carries = (kedge.carry_launches - before) // 2
    if op == "max":
        ok = torch.equal(out, ref.edge_segment_rows(rows, vals, m, "max"))
    else:
        want = ref.edge_segment_rows(rows, vals.double(), m, "sum")
        mag = ref.edge_segment_rows(rows, vals.double().abs(), m, "sum")
        tol = 8e-3 if vals.dtype == torch.bfloat16 else 1e-5
        ok = bool(((out.double() - want).abs() <= tol * mag + 1e-6).all())
    return ok, torch.equal(out, again), carries


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_edge_reduce_split_at_each_boundary(dev, op, K, dtype):
    # Rows of L - 1, L, L + 1, 2L + 1 and 10,000 edges: the long ones are
    # walked in segments and the carry adds (or takes the max of) them; the
    # CSC's split over the transposed order too.
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    vals = randn((adj.nnz, K), dev, K, dtype)
    for indptr, rows, v, split in (
            (adj.csr.indptr, adj.rows, vals, adj.split),
            (adj.csc.indptr, adj.rows_t, vals.index_select(0, adj.perm.long()),
             adj.split_t)):
        ok, repeat, carries = edge_reduce_vs_plain(indptr, rows, v, op, split)
        assert ok and repeat and carries == 1


@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_edge_reduce_walk_widths(dev, monkeypatch, op, lanes):
    # Every walker width, on rows of 0-20 edges around a hub of 2,000 (its
    # segments and carry), at K = 3 (a column chunk past K).
    monkeypatch.setattr(kedge, "walk_width", lambda nnz, m, K: lanes)
    adj = Adjacency.from_csr(skewed_csr(), device=dev)
    vals = randn((adj.nnz, 3), dev, lanes)
    ok, repeat, carries = edge_reduce_vs_plain(adj.csr.indptr, adj.rows, vals,
                                               op, adj.split)
    assert ok and repeat and carries == 1


def test_edge_reduce_without_a_long_row_launches_no_carry(dev):
    ds = sbm_graph(n_per_class=300, num_classes=3, p_in=0.02, p_out=0.001,
                   feat_dim=32, seed=0).to(dev)
    adj = Adjacency.from_csr(add_self_loops(ds.csr))
    assert adj.split.num_segments == 0
    assert kedge.walk_width(adj.nnz, adj.shape[0], 1) == 4  # mean degree 7.5
    ok, repeat, carries = edge_reduce_vs_plain(
        adj.csr.indptr, adj.rows, randn((adj.nnz, 1), dev, 0), "sum",
        adj.split)
    assert ok and repeat and carries == 0


def gat_kernels_vs_float64(adj, H, dh, max_mode, dtype, seed=0):
    """Run the three fused kernels once each; return {name: (max abs error,
    bound)} against the float64 plain versions."""
    dev = adj.csr.indptr.device
    m, n = adj.shape
    src, dst = randn((m, H), dev, seed), randn((n, H), dev, seed + 1)
    B = randn((n, H * dh), dev, seed + 2, dtype)
    g = randn((m, H * dh), dev, seed + 3)
    launched = (kgat.launches, kgat.bwd_rows_launches, kgat.bwd_cols_launches)
    out, mx, den = kgat.gat_forward(adj.csr.indptr, adj.csr.indices, src,
                                    dst, B, heads=H, max_mode=max_mode)
    s_row = ref.gat_row_dot(g, out, H)
    grad_src = kgat.gat_backward_rows(adj.csr.indptr, adj.csr.indices, src,
                                      dst, B, g, mx, den, s_row, heads=H)
    grad_dst, grad_B = kgat.gat_backward_cols(
        adj.csc.indptr, adj.csc.indices, src, dst, B, g, mx, den, s_row,
        heads=H)
    torch.cuda.synchronize()
    assert (kgat.launches, kgat.bwd_rows_launches, kgat.bwd_cols_launches) == \
        tuple(x + 1 for x in launched)
    assert out.dtype == grad_B.dtype == dtype
    edges = (adj.rows, adj.csr.indices)
    s64, d64, B64, g64 = src.double(), dst.double(), B.double(), g.double()
    want_out, mx64, den64 = ref.gat_fused_rows(*edges, s64, d64, B64, m, 0.2,
                                               max_mode, H)
    srow64 = ref.gat_row_dot(g64, out.double(), H)  # the stored out
    vjp = (*edges, s64, d64, B64, g64, mx64, den64, srow64)
    want_src = ref.gat_fused_vjp_rows(*vjp, m, 0.2, H)
    want_dst, want_B = ref.gat_fused_vjp_cols(*vjp, 0.2, H)
    bf16 = dtype == torch.bfloat16
    errs = {}
    for name, got, want, fwd, tol in (
            ("out", out, want_out, True, 8e-3 if bf16 else 1e-5),
            ("mx", mx, mx64, True, 1e-5), ("den", den, den64, True, 1e-5),
            ("grad_src", grad_src, want_src, False, 1e-4),
            ("grad_dst", grad_dst, want_dst, False, 1e-4),
            ("grad_B", grad_B, want_B, False, 8e-3 if bf16 else 1e-4)):
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        scale = float(want.abs().max())
        bound = tol * scale + 1e-6 if fwd else tol * max(scale, 1.0)
        errs[name] = (float((got.double() - want).abs().max()), bound)
    return errs


# (heads, head width): dh in {1, 3, 8, 64}, K not a multiple of 4, K slabs
# that split a head (K=130 at 64 columns a slab), 16-byte lanes (K=128).
GAT_SHAPES = [(1, 1), (1, 3), (3, 3), (8, 3), (3, 8), (1, 64), (4, 32),
              (2, 65)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_mode", ["exact", "bound"])
@pytest.mark.parametrize("H,dh", GAT_SHAPES)
def test_gat_fused_kernels_match_float64(dev, H, dh, max_mode, dtype):
    # The edge values of the skewed graph are ignored by the op, as in JAX.
    adj = Adjacency.from_csr(skewed_csr(), device=dev)
    for name, (err, bound) in gat_kernels_vs_float64(adj, H, dh, max_mode,
                                                     dtype).items():
        assert err <= bound, (name, err, bound)


def test_gat_fused_ignores_edge_values(dev):
    # The op attends over the pattern: a valued and a binary graph of one
    # pattern give the same bits, forward and backward.
    csr = skewed_csr(seed=5)
    runs = []
    for data in (csr.data, None):
        adj = Adjacency.from_csr(csr.with_data(data), device=dev)
        src, dst, B = (randn(shape, dev, i).requires_grad_(True) for i, shape
                       in enumerate(((3000, 2), (2500, 2), (2500, 16))))
        out = kgat.gat_attention_aggregate(adj, src, dst, B, heads=2)
        out.backward(randn((3000, 16), dev, 9))
        runs.append((out.detach(), src.grad, dst.grad, B.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def rmat15() -> CSR:
    return rmat_graph(scale=15, edge_factor=8, seed=0)


@pytest.mark.parametrize("H,dh", [(1, 64), (8, 3)])
def test_gat_fused_kernels_on_rmat15(dev, H, dh):
    # Hub rows and columns (3,866 edges) and 11,708 empty rows.
    adj = Adjacency.from_csr(rmat15(), device=dev)
    for name, (err, bound) in gat_kernels_vs_float64(adj, H, dh, "exact",
                                                     torch.float32).items():
        assert err <= bound, (name, err, bound)


@functools.lru_cache(maxsize=None)
def boundary_graph() -> CSR:
    return split_boundary_graph(SPLIT_LEN)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_mode", ["exact", "bound"])
@pytest.mark.parametrize("H,dh", [(1, 64), (1, 3), (8, 3), (2, 65)])
def test_gat_fused_kernels_split_at_each_boundary(dev, H, dh, max_mode, dtype):
    # Rows and columns of L - 1, L, L + 1, 2L + 1 and 10,000 edges: every
    # kernel walks segments and launches its carry.
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    assert adj.split.long_rows.tolist() == adj.split_t.long_rows.tolist() == \
        [2, 3, 4]
    carries = (kgat.carry_launches, kgat.bwd_rows_carry_launches,
               kgat.bwd_cols_carry_launches)
    for name, (err, bound) in gat_kernels_vs_float64(adj, H, dh, max_mode,
                                                     dtype).items():
        assert err <= bound, (name, err, bound)
    assert (kgat.carry_launches, kgat.bwd_rows_carry_launches,
            kgat.bwd_cols_carry_launches) == (carries[0] + 1, carries[1] + 1,
                                              carries[2] + 2)


# (heads, head width, VEC, SW): walk_shape lands on each of the twelve
# (VEC, SW) instantiations from (H, dh) alone, with heads straddling lanes
# and K slabs of 32·VEC columns (one head across slabs at dh 65, 130, 132).
WALK_CASES = [(1, 1, 1, 4), (1, 3, 1, 4), (1, 5, 1, 8), (3, 3, 1, 16),
              (8, 3, 1, 32), (2, 65, 1, 32), (1, 2, 2, 4), (1, 10, 2, 8),
              (3, 6, 2, 16), (1, 62, 2, 32), (2, 130, 2, 32), (1, 4, 4, 4),
              (2, 4, 4, 4), (1, 32, 4, 8), (3, 8, 4, 8), (1, 64, 4, 16),
              (4, 12, 4, 16), (1, 128, 4, 32), (2, 132, 4, 32)]


@pytest.mark.parametrize("H,dh,vec,lanes", WALK_CASES)
def test_gat_fused_walk_shapes_match_float64(dev, H, dh, vec, lanes):
    # Every walker width with every lane vector, as walk_shape picks them,
    # on a graph with segments.
    assert kgat.walk_shape(H * dh, H, randn((1, H * dh), dev, 0)) == \
        (vec, lanes)
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    for mode in ("exact", "bound"):
        for name, (err, bound) in gat_kernels_vs_float64(
                adj, H, dh, mode, torch.float32).items():
            assert err <= bound, (name, err, bound, mode)


def test_gat_fused_kernels_with_carries_are_deterministic(dev):
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    m, n = adj.shape
    for H, dh in ((1, 64), (2, 65), (8, 3)):
        src, dst = randn((m, H), dev, 1), randn((n, H), dev, 2)
        B, g = randn((n, H * dh), dev, 3), randn((m, H * dh), dev, 4)

        def run():
            out, mx, den = kgat.gat_forward(adj.csr.indptr, adj.csr.indices,
                                            src, dst, B, heads=H,
                                            split=adj.split)
            tabs = (src, dst, B, g, mx, den, ref.gat_row_dot(g, out, H))
            gs = kgat.gat_backward_rows(adj.csr.indptr, adj.csr.indices, *tabs,
                                        heads=H, split=adj.split)
            gd, gB = kgat.gat_backward_cols(adj.csc.indptr, adj.csc.indices,
                                            *tabs, heads=H, split=adj.split_t)
            return out, mx, den, gs, gd, gB

        for a, b in zip(run(), run()):
            assert torch.equal(a, b), (H, dh)


def test_gat_without_a_long_row_launches_no_carry(dev):
    ds = sbm_graph(n_per_class=300, num_classes=3, p_in=0.02, p_out=0.001,
                   feat_dim=32, seed=0).to(dev)
    adj = Adjacency.from_csr(add_self_loops(ds.csr))
    assert adj.split.num_segments == adj.split_t.num_segments == 0
    gen = torch.Generator(device=dev).manual_seed(0)
    model = GAT([32, 16, 3], heads=2, generator=gen, device=dev)
    kgat.reset_launches()
    train_node_classifier(model, adj, ds.features, ds.labels, ds.masks,
                          epochs=3)
    # One launch of each kernel a layer and epoch (the forward once more a
    # layer for the final evaluation), no carry.
    assert (kgat.launches, kgat.bwd_rows_launches,
            kgat.bwd_cols_launches) == (8, 6, 6)
    assert kgat.carry_launches == kgat.bwd_rows_carry_launches == \
        kgat.bwd_cols_carry_launches == 0


def test_attention_kernels_are_deterministic(dev):
    adj = Adjacency.from_csr(skewed_csr(), device=dev)
    m, n = adj.shape
    H = 2
    src, dst = randn((m, H), dev, 1), randn((n, H), dev, 2)
    B, g = randn((n, 130), dev, 3), randn((m, 130), dev, 4)  # 3 K slabs

    def run():
        out, mx, den = kgat.gat_forward(adj.csr.indptr, adj.csr.indices, src,
                                        dst, B, heads=H)
        s_row = ref.gat_row_dot(g, out, H)
        gs = kgat.gat_backward_rows(adj.csr.indptr, adj.csr.indices, src, dst,
                                    B, g, mx, den, s_row, heads=H)
        gd, gB = kgat.gat_backward_cols(adj.csc.indptr, adj.csc.indices, src,
                                        dst, B, g, mx, den, s_row, heads=H)
        seg = kedge.edge_segment_reduce(adj.csr.indptr, randn(
            (adj.nnz, 3), dev, 5), "sum")
        return out, mx, den, gs, gd, gB, seg

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


def test_attention_kernels_empty_work_without_launch(dev):
    counts = (kedge.launches, kgat.launches, kgat.bwd_rows_launches,
              kgat.bwd_cols_launches)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    indptr = torch.zeros(6, dtype=torch.int32, device=dev)  # 5 rows, no edge
    out = kedge.edge_segment_reduce(indptr, torch.zeros(0, 2, device=dev), "max")
    assert out.shape == (5, 2) and not out.any()
    src, dst = randn((5, 2), dev, 0), randn((4, 2), dev, 1)
    B, g = randn((4, 6), dev, 2), randn((5, 6), dev, 3)
    out, mx, den = kgat.gat_forward(indptr, none, src, dst, B, heads=2)
    assert out.shape == (5, 6) and not out.any() and not mx.any()
    assert torch.all(den == ref.DENOM_EPS)
    s_row = ref.gat_row_dot(g, out, 2)
    gs = kgat.gat_backward_rows(indptr, none, src, dst, B, g, mx, den, s_row,
                                heads=2)
    colptr = torch.zeros(5, dtype=torch.int32, device=dev)
    gd, gB = kgat.gat_backward_cols(colptr, none, src, dst, B, g, mx, den,
                                    s_row, heads=2)
    assert gs.shape == (5, 2) and gd.shape == (4, 2) and gB.shape == (4, 6)
    assert not gs.any() and not gd.any() and not gB.any()
    assert (kedge.launches, kgat.launches, kgat.bwd_rows_launches,
            kgat.bwd_cols_launches) == counts


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(dev):
    csr = skewed_csr(50, 40).to(dev)
    vals = randn((csr.nnz, 2), dev, 0)
    with pytest.raises(TypeError):
        kedge.edge_segment_reduce(csr.indptr, vals.double(), "sum")
    with pytest.raises(ValueError, match="contiguous"):
        kedge.edge_segment_reduce(csr.indptr, vals.t().contiguous().t(), "sum")
    with pytest.raises(ValueError, match="is on"):
        kedge.edge_segment_reduce(csr.indptr.cpu(), vals, "sum")
    with pytest.raises(TypeError, match="int32"):
        kedge.edge_segment_reduce(csr.indptr.long(), vals, "sum")
    src, dst, B = randn((50, 2), dev, 1), randn((40, 2), dev, 2), \
        randn((40, 6), dev, 3)
    args = (csr.indptr, csr.indices)
    with pytest.raises(TypeError):
        kgat.gat_forward(*args, src, dst, B.double(), heads=2)
    with pytest.raises(ValueError, match="src"):
        kgat.gat_forward_cuda(*args, src[:-1], dst, B, 0.2, 2)
    with pytest.raises(ValueError, match="is on"):
        kgat.gat_forward_cuda(*args, src.cpu(), dst, B, 0.2, 2)
    with pytest.raises(ValueError, match="multiple"):
        kgat.gat_forward_cuda(*args, src, dst, randn((40, 5), dev, 4), 0.2, 2)
    out, mx, den = kgat.gat_forward(*args, src, dst, B, heads=2)
    g = randn((50, 6), dev, 5)
    s_row = ref.gat_row_dot(g, out, 2)
    with pytest.raises(TypeError, match="g must be"):
        kgat.gat_backward_rows_cuda(*args, src, dst, B, g.double(), mx, den,
                                    s_row, 0.2, 2)
    adj = Adjacency.from_csr(csr)
    with pytest.raises(ValueError, match="columns"):
        kgat.gat_backward_cols_cuda(adj.csc.indptr[:-1], adj.csc.indices, src,
                                    dst, B, g, mx, den, s_row, 0.2, 2)


def test_gat_autograd_on_card_matches_float64(dev):
    csr = skewed_csr(800, 700, seed=1)
    adj, adj64 = Adjacency.from_csr(csr, device=dev), Adjacency.from_csr(csr)
    H, dh = 2, 8
    host = [randn(shape, torch.device("cpu"), i) for i, shape in enumerate(
        ((800, H), (700, H), (700, H * dh), (800, H * dh)))]
    src, dst, B = (t.to(dev).requires_grad_(True) for t in host[:3])
    counts = (kgat.launches, kgat.bwd_rows_launches, kgat.bwd_cols_launches)
    out = kgat.gat_attention_aggregate(adj, src, dst, B, heads=H)
    out.backward(host[3].to(dev))
    assert (kgat.launches, kgat.bwd_rows_launches, kgat.bwd_cols_launches) == \
        tuple(c + 1 for c in counts)
    src64, dst64, B64 = (t.double().requires_grad_(True) for t in host[:3])
    out64 = kgat.gat_attention_aggregate(adj64, src64, dst64, B64, heads=H)
    out64.backward(host[3].double())
    want = out64.detach()
    assert float((out.detach().cpu().double() - want).abs().max()) <= \
        1e-5 * float(want.abs().max()) + 1e-6
    for got, want in ((src.grad, src64.grad), (dst.grad, dst64.grad),
                      (B.grad, B64.grad)):
        err = float((got.cpu().double() - want).abs().max())
        assert err <= 1e-4 * max(float(want.abs().max()), 1.0)


def test_composed_attention_chain_on_card_matches_float64(dev):
    # additive logits -> leaky -> edge softmax -> spmm(with_data(alpha)):
    # 2 segment reductions forward, 1 + 2 backward.
    csr = skewed_csr(800, 800, seed=2)
    adj, adj64 = Adjacency.from_csr(csr, device=dev), Adjacency.from_csr(csr)
    host = [randn(shape, torch.device("cpu"), 10 + i) for i, shape in
            enumerate(((800,), (800,), (800, 16), (800, 16)))]

    def chain(a, src, dst, B):
        logits = additive_attention_logits(a, src, dst)
        alpha = edge_softmax(a, torch.nn.functional.leaky_relu(logits, 0.2))
        return spmm(a.with_data(alpha), B)

    src, dst, B = (t.to(dev).requires_grad_(True) for t in host[:3])
    before = kedge.launches
    out = chain(adj, src, dst, B)
    assert kedge.launches == before + 2
    out.backward(host[3].to(dev))
    assert kedge.launches == before + 5
    src64, dst64, B64 = (t.double().requires_grad_(True) for t in host[:3])
    out64 = chain(adj64, src64, dst64, B64)
    out64.backward(host[3].double())
    want = out64.detach()
    assert float((out.detach().cpu().double() - want).abs().max()) <= \
        1e-5 * float(want.abs().max()) + 1e-6
    for got, want in ((src.grad, src64.grad), (dst.grad, dst64.grad),
                      (B.grad, B64.grad)):
        err = float((got.cpu().double() - want).abs().max())
        assert err <= 1e-4 * max(float(want.abs().max()), 1.0)


def test_gat_training_goes_through_the_fused_kernels(dev):
    ds = sbm_graph(n_per_class=300, num_classes=3, p_in=0.02, p_out=0.001,
                   feat_dim=32, seed=0).to(dev)
    adj = Adjacency.from_csr(add_self_loops(ds.csr))
    for heads in (1, 4):
        gen = torch.Generator(device=dev).manual_seed(0)
        model = GAT([32, 16, 3], heads=heads, generator=gen, device=dev)
        kgat.reset_launches()
        res = train_node_classifier(model, adj, ds.features, ds.labels,
                                    ds.masks, epochs=20, lr=5e-3)
        assert min(kgat.launches, kgat.bwd_rows_launches,
                   kgat.bwd_cols_launches) >= 2 * 20
        loss = res["history"]["loss"]
        assert loss[-1] < loss[0] and np.all(np.isfinite(loss))
        assert res["train_acc"] > 1 / 3

    for mod in (kgat, kedge, kspmm):
        mod.reset_launches()
    model.method = "xla"
    train_node_classifier(model, adj, ds.features, ds.labels, ds.masks, epochs=3)
    assert kgat.launches == kgat.bwd_rows_launches == kgat.bwd_cols_launches == 0
    assert kedge.launches == kspmm.launches == 0


# --- the nnz-chunked SpMM (kernel row 8) ----------------------------------

CHUNK_SIZES = [(64, 64), (128, 256), (8, 3)]


@pytest.mark.parametrize("R,E", CHUNK_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 3, 16, 32, 33, 128, 130, 512])
def test_chunk_kernel_matches_plain(dev, K, binary, dtype, R, E):
    csr = skewed_csr()
    data = None if binary else csr.data
    adj = Adjacency.from_csr(csr.with_data(data), device=dev, plan="perrow",
                             rows_per_block=R, chunk_nnz=E)
    B = randn((csr.shape[1], K), dev, K, dtype)
    before = (kpal.launches, kpal.carry_launches)
    out = kpal.spmm_pallas(adj.plan, adj.data, B, csr.shape[0])
    torch.cuda.synchronize()
    assert (kpal.launches, kpal.carry_launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert out.dtype == dtype
    check_bound(out, adj.csr, B, adj.data)


def straddling_csr(E, hub=10_000):
    """Rows of E - 1, E, E + 1 and 2E + 1 edges around one hub row of
    ``hub`` edges, empty rows between: rows start and end on and off chunk
    boundaries."""
    n = hub + 7
    rng = np.random.default_rng(4)
    deg = np.array([0, E - 1, E, 0, E + 1, 2 * E + 1, hub, 0, 1, E, 0, 3])
    cols = np.concatenate([np.sort(rng.choice(n, d, replace=False))
                           for d in deg])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    vals = rng.standard_normal(cols.shape[0]).astype(np.float32)
    return CSR(torch.from_numpy(indptr), torch.from_numpy(cols.astype(np.int32)),
               torch.from_numpy(vals), (deg.shape[0], n))


@pytest.mark.parametrize("E", [1, 3, 64, 256])
@pytest.mark.parametrize("K", [1, 16, 32, 128, 130])
def test_chunk_kernel_hub_row_and_straddling_rows(dev, E, K):
    csr = straddling_csr(E)
    plan = build_spmm_plan(csr, rows_per_block=8, chunk_nnz=E).to(dev)
    assert plan.cut_rows.numel() > 0
    B = randn((csr.shape[1], K), dev, 7)
    d = csr.data.to(dev)
    out = kpal.spmm_pallas(plan, d, B, csr.shape[0])
    torch.cuda.synchronize()
    check_bound(out, csr.to(dev), B, d)


# (K, VEC, SW) of the chunk kernel's walkers, as walk_shape picks them: a
# walker a piece, 4 lanes at K = 1, 3 and 16, 8 (four a warp) at K = 32.
# Each width walks long pieces (E = 64, 256) and short ones (E = 3), which a
# walker narrower than a warp gathers 4 and 2 at a time (csrc/spmm_chunk.cu:
# 4 where the pieces average at least kDeepPiece = 8 edges).
@pytest.mark.parametrize("K,vec,lanes", MINMAX_WALKS + [(512, 4, 32)])
def test_chunk_kernel_walkers_match_plain(dev, K, vec, lanes):
    assert kpal.walk_shape(K, 1, randn((1, K), dev, 0)) == (vec, lanes)
    csr = straddling_csr(64)
    for R, E in ((64, 64), (128, 256), (8, 3)):
        plan = build_spmm_plan(csr, rows_per_block=R, chunk_nnz=E).to(dev)
        assert (plan.nnz >= 8 * plan.num_pieces) == (E > 3)
        for data in (None, csr.data.to(dev)):
            B = randn((csr.shape[1], K), dev, K)
            out = kpal.spmm_pallas(plan, data, B, csr.shape[0])
            torch.cuda.synchronize()
            check_bound(out, csr.to(dev), B, data)


def test_chunk_kernel_is_deterministic(dev):
    csr = rmat15()
    plan = build_spmm_plan(csr, rows_per_block=64, chunk_nnz=64).to(dev)
    B = randn((csr.shape[1], 128), dev, 3)
    outs = [kpal.spmm_pallas(plan, None, B, csr.shape[0]) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    check_bound(outs[0], csr.to(dev), B, None)


def test_chunk_kernel_never_takes_the_plain_version(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "spmm_chunks", refuse)
    adj = Adjacency.from_csr(skewed_csr(), device=dev, plan="perrow")
    B = randn((adj.shape[1], 16), dev, 1, requires_grad=True)
    kpal.reset_launches()
    spmm(adj, B, method="pallas").sum().backward()
    assert (kpal.launches, kpal.carry_launches) == (2, 2)
    with pytest.raises(AssertionError):
        kpal.spmm_pallas(adj.plan, adj.data, B.detach().cpu(), adj.shape[0])


def test_pallas_without_transposed_plan_launches_the_csr_kernel(dev):
    adj = Adjacency.from_csr(skewed_csr(), device=dev, plan="perrow",
                             plan_transpose=False)
    assert adj.plan_t is None
    B = randn((adj.shape[1], 16), dev, 1, requires_grad=True)
    g = randn((adj.shape[0], 16), dev, 2)
    kpal.reset_launches()
    kspmm.reset_launches()
    spmm(adj, B, method="pallas").backward(g)
    torch.cuda.synchronize()
    assert (kpal.launches, kspmm.launches) == (1, 1)  # forward, grad_B
    t = adj.transpose()
    check_bound(B.grad, t.csr, g, t.data)


def test_chunk_kernel_refuses_and_empty_work(dev):
    adj = Adjacency.from_csr(skewed_csr(), device=dev, plan="perrow")
    m, n = adj.shape
    B = randn((n, 8), dev, 1)
    with pytest.raises(ValueError, match="is on cpu"):
        kpal.spmm_pallas(adj.plan.to("cpu"), adj.data, B, m)
    with pytest.raises(TypeError):
        kpal.spmm_pallas(adj.plan, adj.data, B.double(), m)
    empty = CSR(torch.zeros(m + 1, dtype=torch.int32),
                torch.zeros(0, dtype=torch.int32), None, (m, n))
    before = kpal.launches
    out = kpal.spmm_pallas(build_spmm_plan(empty).to(dev), None, B, m)
    assert kpal.launches == before and not out.any()


@pytest.mark.parametrize("view", ["column slice", "transposed"])
def test_spmm_pallas_takes_a_non_contiguous_B(dev, view):
    adj = Adjacency.from_csr(skewed_csr(), device=dev, plan="perrow")
    n = adj.shape[1]
    full = randn((n, 48), dev, 2) if view == "column slice" else \
        randn((16, n), dev, 2)
    B = full[:, 8:24] if view == "column slice" else full.t()
    assert not B.is_contiguous()
    out = spmm(adj, B, method="pallas")
    check_bound(out, adj.csr, B.contiguous(), adj.data)


def test_spmm_pallas_autograd_on_card_matches_float64(dev):
    csr = skewed_csr(seed=3)
    adj = Adjacency.from_csr(csr, device=dev, plan="perrow", rows_per_block=64,
                             chunk_nnz=64)
    d = adj.data.clone().requires_grad_(True)
    B = randn((csr.shape[1], 24), dev, 1, requires_grad=True)
    g = randn((csr.shape[0], 24), dev, 2)
    spmm(adj.with_data(d), B, method="pallas").backward(g)
    adj64 = Adjacency.from_csr(csr)
    d64 = csr.data.double().requires_grad_(True)
    B64 = B.detach().cpu().double().requires_grad_(True)
    spmm(adj64.with_data(d64), B64, method="xla").backward(g.cpu().double())
    for got, want in ((B.grad, B64.grad), (d.grad, d64.grad)):
        err = float((got.cpu().double() - want).abs().max())
        assert err <= 1e-5 * max(float(want.abs().max()), 1.0)


# --- fused dot-product attention (kernel row 6) ---------------------------


def dot_kernels_vs_float64(adj, Ka, K, slope, dtype, seed=0):
    """Run the three dot kernels once each, with the adjacency's splits;
    {name: (max abs error, bound)} against the float64 plain versions (s =
    <g, out> from the stored out)."""
    dev = adj.csr.indptr.device
    m, n = adj.shape
    D1 = randn((m, Ka), dev, seed) * Ka ** -0.25
    D2 = randn((n, Ka), dev, seed + 1) * Ka ** -0.25
    B, g = randn((n, K), dev, seed + 2, dtype), randn((m, K), dev, seed + 3)
    launched = (kgat.dot_launches, kgat.dot_bwd_rows_launches,
                kgat.dot_bwd_cols_launches)
    out, mx, den = kgat.dot_forward(adj.csr.indptr, adj.csr.indices, D1, D2, B,
                                    slope=slope, split=adj.split)
    s_row = ref.dot_row_dot(g, out)
    tabs = (D1, D2, B, g, mx, den, s_row)
    gD1 = kgat.dot_backward_rows(adj.csr.indptr, adj.csr.indices, *tabs,
                                 slope=slope, split=adj.split)
    gD2, gB = kgat.dot_backward_cols(adj.csc.indptr, adj.csc.indices, *tabs,
                                     slope=slope, split=adj.split_t)
    torch.cuda.synchronize()
    assert (kgat.dot_launches, kgat.dot_bwd_rows_launches,
            kgat.dot_bwd_cols_launches) == tuple(x + 1 for x in launched)
    assert out.dtype == gB.dtype == dtype
    edges = (adj.rows, adj.csr.indices)
    want_out, mx64, den64 = ref.dot_attention_rows(
        *edges, D1.double(), D2.double(), B.double(), m, slope)
    tabs64 = (D1.double(), D2.double(), B.double(), g.double(), mx64, den64,
              ref.dot_row_dot(g.double(), out.double()))
    want_d1 = ref.dot_attention_vjp_rows(*edges, *tabs64, m, slope)
    want_d2, want_B = ref.dot_attention_vjp_cols(*edges, *tabs64, slope)
    bf16 = dtype == torch.bfloat16
    errs = {}
    for name, got, want, fwd, tol in (
            ("out", out, want_out, True, 8e-3 if bf16 else 1e-5),
            ("mx", mx, mx64, True, 1e-5), ("den", den, den64, True, 1e-5),
            ("grad_D1", gD1, want_d1, False, 1e-4),
            ("grad_D2", gD2, want_d2, False, 1e-4),
            ("grad_B", gB, want_B, False, 8e-3 if bf16 else 1e-4)):
        assert got.shape == want.shape and torch.isfinite(got).all(), name
        scale = float(want.abs().max())
        bound = tol * scale + 1e-6 if fwd else tol * max(scale, 1.0)
        errs[name] = (float((got.double() - want).abs().max()), bound)
    return errs


def dot_carries():
    return (kgat.dot_carry_launches, kgat.dot_bwd_rows_carry_launches,
            kgat.dot_bwd_cols_carry_launches)


# (Ka, K): Ka = 1 (the JAX _pad2 case), widths off the lane vector, K slabs.
DOT_SHAPES = [(1, 8), (5, 3), (6, 1), (16, 3), (64, 64), (65, 130), (64, 130)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("Ka,K", DOT_SHAPES)
def test_dot_kernels_match_float64(dev, Ka, K, slope, dtype):
    adj = Adjacency.from_csr(skewed_csr(), device=dev)  # non-square, hub row
    for name, (err, bound) in dot_kernels_vs_float64(adj, Ka, K, slope,
                                                     dtype).items():
        assert err <= bound, (name, err, bound)


def test_dot_kernels_on_rmat15(dev):
    # The hub rows and columns (3,866 edges) in segments, and their carries.
    adj = Adjacency.from_csr(rmat15(), device=dev)
    before = dot_carries()
    for name, (err, bound) in dot_kernels_vs_float64(adj, 64, 64, None,
                                                     torch.float32).items():
        assert err <= bound, (name, err, bound)
    assert dot_carries() == (before[0] + 1, before[1] + 1, before[2] + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slope", [None, 0.2])
@pytest.mark.parametrize("Ka,K", [(64, 64), (16, 3), (64, 130)])
def test_dot_kernels_split_at_each_boundary(dev, Ka, K, slope, dtype):
    # Rows and columns of L - 1, L, L + 1, 2L + 1 and 10,000 edges: every
    # kernel walks segments and launches its carry (two over the CSC).
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    before = dot_carries()
    for name, (err, bound) in dot_kernels_vs_float64(adj, Ka, K, slope,
                                                     dtype).items():
        assert err <= bound, (name, err, bound)
    assert dot_carries() == (before[0] + 1, before[1] + 1, before[2] + 2)


# (Ka, K, VEC, SW): dot_walk_shape lands on each of the twelve (VEC, SW)
# instantiations, with Ka and K on either side and slabs past SW·VEC.
DOT_WALKS = [(3, 1, 1, 4), (5, 8, 1, 8), (16, 3, 1, 16), (65, 130, 1, 32),
             (2, 4, 2, 4), (10, 6, 2, 8), (30, 2, 2, 16), (64, 130, 2, 32),
             (4, 4, 4, 4), (32, 8, 4, 8), (64, 64, 4, 16), (128, 256, 4, 32)]


@pytest.mark.parametrize("Ka,K,vec,lanes", DOT_WALKS)
def test_dot_walk_shapes_match_float64(dev, Ka, K, vec, lanes):
    assert kgat.dot_walk_shape(K, Ka, randn((1, 4), dev, 0)) == (vec, lanes)
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    for name, (err, bound) in dot_kernels_vs_float64(adj, Ka, K, 0.2,
                                                     torch.float32).items():
        assert err <= bound, (name, err, bound)


def test_dot_kernels_with_carries_are_deterministic(dev):
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    m, n = adj.shape
    for Ka, K in ((64, 64), (16, 3), (65, 130)):
        D1, D2 = randn((m, Ka), dev, 1), randn((n, Ka), dev, 2)
        B, g = randn((n, K), dev, 3), randn((m, K), dev, 4)

        def run():
            out, mx, den = kgat.dot_forward(adj.csr.indptr, adj.csr.indices,
                                            D1, D2, B, split=adj.split)
            tabs = (D1, D2, B, g, mx, den, ref.dot_row_dot(g, out))
            return (out, mx, den,
                    kgat.dot_backward_rows(adj.csr.indptr, adj.csr.indices,
                                           *tabs, split=adj.split),
                    *kgat.dot_backward_cols(adj.csc.indptr, adj.csc.indices,
                                            *tabs, split=adj.split_t))

        for a, b in zip(run(), run()):
            assert torch.equal(a, b), (Ka, K)


@pytest.mark.parametrize("Ka,K", [(64, 64), (32, 8), (64, 130)])
def test_dot_backward_takes_the_forwards_walker_for_a_misaligned_g(dev, Ka,
                                                                   K):
    # A g that starts 4 bytes off the forward's VEC is copied, so the
    # backward walks with the forward's (VEC, SW) and gives the same bits as
    # an aligned g (a narrower VEC would split each logit's dot otherwise).
    adj = Adjacency.from_csr(boundary_graph(), device=dev)
    m, n = adj.shape
    D1, D2 = randn((m, Ka), dev, 1), randn((n, Ka), dev, 2)
    B = randn((n, K), dev, 3)
    skewed = randn((m * K + 1,), dev, 4)[1:].view(m, K)
    assert kgat.dot_walk_shape(K, Ka, D1, D2, B)[0] > 1
    assert kgat.dot_walk_shape(K, Ka, skewed)[0] == 1
    out, mx, den = kgat.dot_forward(adj.csr.indptr, adj.csr.indices, D1, D2,
                                    B, split=adj.split)

    def grads(g):
        tabs = (D1, D2, B, g, mx, den, ref.dot_row_dot(g, out))
        return (kgat.dot_backward_rows(adj.csr.indptr, adj.csr.indices, *tabs,
                                       split=adj.split),
                *kgat.dot_backward_cols(adj.csc.indptr, adj.csc.indices,
                                        *tabs, split=adj.split_t))

    for a, b in zip(grads(skewed), grads(skewed.clone())):
        assert torch.equal(a, b), (Ka, K)


def test_dot_without_a_long_row_launches_no_carry(dev):
    ds = sbm_graph(n_per_class=300, num_classes=3, p_in=0.02, p_out=0.001,
                   feat_dim=32, seed=0).to(dev)
    adj = Adjacency.from_csr(add_self_loops(ds.csr))
    assert adj.split.num_segments == adj.split_t.num_segments == 0
    kgat.reset_launches()
    xs = [randn(s, dev, i, requires_grad=True)
          for i, s in enumerate(((900, 64), (900, 64), (900, 64)))]
    out = attention_aggregate(adj, *xs)
    out.backward(randn((900, 64), dev, 5))
    torch.cuda.synchronize()
    assert (kgat.dot_launches, kgat.dot_bwd_rows_launches,
            kgat.dot_bwd_cols_launches) == (1, 1, 1)
    assert dot_carries() == (0, 0, 0)


def test_dot_kernels_are_deterministic(dev):
    adj = Adjacency.from_csr(skewed_csr(), device=dev)
    m, n = adj.shape
    D1, D2 = randn((m, 65), dev, 1), randn((n, 65), dev, 2)
    B, g = randn((n, 130), dev, 3), randn((m, 130), dev, 4)
    runs = []
    for _ in range(2):
        out, mx, den = kgat.dot_forward(adj.csr.indptr, adj.csr.indices, D1, D2,
                                        B, slope=0.2)
        s = ref.dot_row_dot(g, out)
        tabs = (D1, D2, B, g, mx, den, s)
        runs.append((out, mx, den,
                     kgat.dot_backward_rows(adj.csr.indptr, adj.csr.indices,
                                            *tabs, slope=0.2),
                     *kgat.dot_backward_cols(adj.csc.indptr, adj.csc.indices,
                                             *tabs, slope=0.2)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_dot_fused_op_launches_and_never_takes_the_plain_version(
        dev, monkeypatch):
    adj = Adjacency.from_csr(skewed_csr(), device=dev)
    m, n = adj.shape
    xs = [randn(s, dev, i, requires_grad=True)
          for i, s in enumerate(((m, 16), (n, 16), (n, 8)))]
    g = randn((m, 8), dev, 5)
    want = attention_aggregate(adj, *xs, method="xla")
    want.backward(g)
    want = want.detach()
    want_grads = [x.grad.clone() for x in xs]
    for x in xs:
        x.grad = None

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("dot_attention_rows", "dot_attention_vjp_rows",
                 "dot_attention_vjp_cols"):
        monkeypatch.setattr(ref, name, refuse)
    kgat.reset_launches()
    out = attention_aggregate(adj, *xs)
    out.backward(g)
    out = out.detach()
    assert (kgat.dot_launches, kgat.dot_bwd_rows_launches,
            kgat.dot_bwd_cols_launches) == (1, 1, 1)
    scale = float(want.abs().max())
    assert float((out - want).abs().max()) <= 1e-5 * scale + 1e-6
    for x, w in zip(xs, want_grads):
        assert float((x.grad - w).abs().max()) <= \
            1e-4 * max(float(w.abs().max()), 1.0)


def test_dot_empty_work_and_refusals(dev):
    m, n = 30, 20
    empty = Adjacency.from_csr(CSR(torch.zeros(m + 1, dtype=torch.int32),
                                   torch.zeros(0, dtype=torch.int32), None,
                                   (m, n)), device=dev)
    D1, D2, B = randn((m, 4), dev, 1), randn((n, 4), dev, 2), randn((n, 8), dev, 3)
    kgat.reset_launches()
    out, mx, den = kgat.dot_forward(empty.csr.indptr, empty.csr.indices, D1,
                                    D2, B)
    assert kgat.dot_launches == 0 and not out.any() and not mx.any()
    adj = Adjacency.from_csr(skewed_csr(), device=dev)
    m, n = adj.shape
    with pytest.raises(ValueError, match="D2"):
        kgat.dot_forward(adj.csr.indptr, adj.csr.indices, randn((m, 4), dev, 1),
                         randn((n + 1, 4), dev, 2), randn((n, 8), dev, 3))
    with pytest.raises(TypeError):
        kgat.dot_forward(adj.csr.indptr, adj.csr.indices, randn((m, 4), dev, 1),
                         randn((n, 4), dev, 2), randn((n, 8), dev, 3).double())


# --- the grouped-gather SpMM (kernel row 9) -------------------------------

# (R, E, NG, G): the JAX defaults, the small test plan, G = 1, and both
# extremes of the staged rows NG*G (2 rows; up to 512 rows, which at K=512
# f32 takes a K tile above 48 KiB of shared memory).
GROUPED_SIZES = [(64, 64, 32, 8), (8, 16, 8, 8), (64, 64, 64, 1),
                 (8, 16, 2, 1), (64, 64, 64, 8)]


def grouped_kw(sizes):
    R, E, NG, G = sizes
    return dict(rows_per_block=R, edges_per_chunk=E, groups_per_chunk=NG,
                group_rows=G)


@pytest.mark.parametrize("sizes", GROUPED_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("K", [1, 3, 32, 33, 128, 130, 512])
def test_grouped_kernel_matches_plain(dev, K, binary, dtype, sizes):
    # skewed_csr: n = 2500 is not a multiple of G = 8 (the last group runs
    # past B), a hub row of 2000 edges over many chunks, empty rows.
    csr = skewed_csr()
    data = None if binary else csr.data
    adj = Adjacency.from_csr(csr.with_data(data), device=dev, plan="grouped",
                             **grouped_kw(sizes))
    B = randn((csr.shape[1], K), dev, K, dtype)
    before = (kgrp.launches, kgrp.carry_launches)
    out = kgrp.spmm_grouped(adj.plan, adj.data, B, csr.shape[0])
    again = kgrp.spmm_grouped(adj.plan, adj.data, B, csr.shape[0])
    torch.cuda.synchronize()
    assert (kgrp.launches, kgrp.carry_launches) == (before[0] + 2,
                                                    before[1] + 2)
    assert out.dtype == dtype and torch.equal(out, again)
    check_bound(out, adj.csr, B, adj.data)
    want = ref.spmm_grouped_chunks(
        adj.plan.chunk_count, adj.plan.groups, adj.plan.group_count,
        adj.plan.slots, adj.plan.group_rows, adj.data, B, adj.rows,
        csr.shape[0])
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    assert float((out.float() - want.float()).abs().max()) <= tol * max(
        float(want.float().abs().max()), 1.0)


def test_grouped_kernel_smem_opt_in_tiles(dev, monkeypatch):
    # Up to 64 referenced rows a chunk: with tiles as wide as the kernel
    # takes (256 columns), at K=512 and K=130 the ring's stages need more
    # than the 48 KiB a launch gets without the opt-in.
    monkeypatch.setattr(kgrp, "MAX_COLS", 256)
    csr = skewed_csr()
    plan = build_grouped_plan(csr, **grouped_kw((64, 64, 64, 8))).to(dev)
    S = plan.max_refs
    header = kgrp.header_bytes(plan.edges_per_chunk, plan.rows_per_block)
    for K, dtype in ((512, torch.float32), (130, torch.float32),
                     (512, torch.bfloat16)):
        B = randn((csr.shape[1], K), dev, 5, dtype)
        size = B.element_size()
        unit = kgrp.copy_width(K, size, B) // size
        kt = kgrp.k_tile(K, max(unit, 1), S, size, header)
        ns = kgrp.stages(kt, S, size, header)
        assert ns * kgrp.stage_bytes(header, S, kt, size) > 48 * 1024, (
            K, dtype, kt, ns)
        out = kgrp.spmm_grouped(plan, csr.data.to(dev), B, csr.shape[0])
        torch.cuda.synchronize()
        check_bound(out, csr.to(dev), B, csr.data.to(dev))


@pytest.mark.parametrize("producers", [1, 2, 4])
@pytest.mark.parametrize("cols", [32, 256])
def test_grouped_kernel_launch_shapes(dev, monkeypatch, producers, cols):
    # Every producer-warp count and tile width the kernel takes gives the
    # same function, bitwise repeatable (f32 and bf16, K=130: tiles of 32
    # columns, or one of 130).
    monkeypatch.setattr(kgrp, "PRODUCERS", producers)
    monkeypatch.setattr(kgrp, "MAX_COLS", cols)
    csr = skewed_csr()
    adj = Adjacency.from_csr(csr, device=dev, plan="grouped")
    for dtype in (torch.float32, torch.bfloat16):
        B = randn((csr.shape[1], 130), dev, 3, dtype)
        out = kgrp.spmm_grouped(adj.plan, adj.data, B, csr.shape[0])
        again = kgrp.spmm_grouped(adj.plan, adj.data, B, csr.shape[0])
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        check_bound(out, adj.csr, B, adj.data)


def test_grouped_kernel_rows_past_n_and_empty_blocks(dev):
    # n = 13 with G = 8: the second group's rows 13-15 lie past B, which is
    # followed in memory by NaN rows the kernel must not read; rows 8-23
    # have no edges, so with R = 8 two blocks are one chunk of none.
    rng = np.random.default_rng(9)
    m, n = 40, 13
    dense = (rng.random((m, n)) < 0.3) * rng.standard_normal((m, n))
    dense[8:24] = 0
    dense[0, n - 1] = 1.5  # the last column, in the group past n
    indptr = np.r_[0, np.cumsum((dense != 0).sum(1))].astype(np.int32)
    rows, cols = np.nonzero(dense)
    csr = CSR(torch.from_numpy(indptr), torch.from_numpy(cols.astype(np.int32)),
              torch.from_numpy(dense[rows, cols].astype(np.float32)), (m, n))
    plan = build_grouped_plan(csr, **grouped_kw((8, 16, 8, 8))).to(dev)
    assert int(plan.groups.max()) * 8 + 8 > n
    for K in (1, 4, 130):
        buf = torch.full((n + 16, K), float("nan"), device=dev)
        buf[:n] = randn((n, K), dev, K)
        B = buf[:n]
        out = kgrp.spmm_grouped(plan, csr.data.to(dev), B, m)
        torch.cuda.synchronize()
        assert not out[8:24].any()
        check_bound(out, csr.to(dev), B, csr.data.to(dev))


def test_grouped_kernel_is_deterministic(dev):
    csr, _ = reorder(rmat15())
    plan = build_grouped_plan(csr).to(dev)
    B = randn((csr.shape[1], 128), dev, 3)
    outs = [kgrp.spmm_grouped(plan, None, B, csr.shape[0]) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    check_bound(outs[0], csr.to(dev), B, None)


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_grouped_op_launches_and_never_takes_the_plain_version(
        dev, monkeypatch, method):
    # "pallas" takes the grouped kernel; "auto" the CSR kernel, on a grouped
    # adjacency too (the rule the card measured, PERF.md PR 7).
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "spmm_grouped_chunks", refuse)
    monkeypatch.setattr(ref, "spmm_split_rows", refuse)
    csr = skewed_csr(seed=3)
    adj = Adjacency.from_csr(csr, device=dev, plan="grouped")
    d = adj.data.clone().requires_grad_(True)
    B = randn((csr.shape[1], 24), dev, 1, requires_grad=True)
    g = randn((csr.shape[0], 24), dev, 2)
    kgrp.reset_launches()
    kspmm.reset_launches()
    spmm(adj.with_data(d), B, method=method).backward(g)
    torch.cuda.synchronize()
    # forward, grad_B
    assert (kgrp.launches, kspmm.launches) == {"pallas": (2, 0),
                                               "auto": (0, 2)}[method]
    adj64 = Adjacency.from_csr(csr)
    d64 = csr.data.double().requires_grad_(True)
    B64 = B.detach().cpu().double().requires_grad_(True)
    spmm(adj64.with_data(d64), B64, method="xla").backward(g.cpu().double())
    for got, want in ((B.grad, B64.grad), (d.grad, d64.grad)):
        err = float((got.cpu().double() - want).abs().max())
        assert err <= 1e-5 * max(float(want.abs().max()), 1.0)
    with pytest.raises(AssertionError):
        kgrp.spmm_grouped(adj.plan, adj.data, B.detach().cpu(), adj.shape[0])


def test_grouped_without_transposed_plan_launches_the_csr_kernel(dev):
    adj = Adjacency.from_csr(skewed_csr(), device=dev, plan="grouped",
                             plan_transpose=False)
    assert adj.plan_t is None
    B = randn((adj.shape[1], 16), dev, 1, requires_grad=True)
    g = randn((adj.shape[0], 16), dev, 2)
    kgrp.reset_launches()
    kspmm.reset_launches()
    spmm(adj, B, method="pallas").backward(g)
    torch.cuda.synchronize()
    assert (kgrp.launches, kspmm.launches) == (1, 1)  # forward, grad_B
    t = adj.transpose()
    check_bound(B.grad, t.csr, g, t.data)


def test_grouped_kernel_refuses_and_empty_work(dev):
    adj = Adjacency.from_csr(skewed_csr(), device=dev, plan="grouped")
    m, n = adj.shape
    B = randn((n, 8), dev, 1)
    with pytest.raises(ValueError, match="is on cpu"):
        kgrp.spmm_grouped(adj.plan.to("cpu"), adj.data, B, m)
    with pytest.raises(TypeError):
        kgrp.spmm_grouped(adj.plan, adj.data, B.double(), m)
    empty = CSR(torch.zeros(m + 1, dtype=torch.int32),
                torch.zeros(0, dtype=torch.int32), None, (m, n))
    before = kgrp.launches
    out = kgrp.spmm_grouped(build_grouped_plan(empty).to(dev), None, B, m)
    assert kgrp.launches == before and not out.any()


def test_gcn_trains_on_a_reordered_graph_through_the_grouped_kernel(dev):
    ds = sbm_graph(n_per_class=300, num_classes=3, p_in=0.02, p_out=0.001,
                   feat_dim=32, seed=0)
    csr, perm = reorder(add_self_loops(ds.csr))
    p = torch.from_numpy(perm)
    adj = Adjacency.from_csr(csr, device=dev, plan="grouped")
    x, y = ds.features[p].to(dev), ds.labels[p].to(dev)
    masks = {k: v[p].to(dev) for k, v in ds.masks.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    model = GCN([32, 16, 3], generator=gen, device=dev,
                method="pallas").with_norms(adj)
    kgrp.reset_launches()
    kspmm.reset_launches()
    res = train_node_classifier(model, adj, x, y, masks, epochs=20)
    assert kgrp.launches >= 4 * 20 and kspmm.launches == 0
    loss = res["history"]["loss"]
    assert loss[-1] < loss[0] and np.all(np.isfinite(loss))
    assert res["train_acc"] > 1 / 3
    # The same parameters on the original order give the same logits.
    model.eval()
    with torch.no_grad():
        logits = model(adj, x)[torch.from_numpy(inverse_permutation(perm))]
        orig = Adjacency.from_csr(add_self_loops(ds.csr), device=dev,
                                  plan="grouped")
        model.with_norms(orig)
        want = model(orig, ds.features.to(dev))
    assert float((logits - want).abs().max()) <= 1e-4 * float(want.abs().max())


# --- the joint diag+halo SpMM (kernel row 7) and the sharded tier ----------

def _square_skewed(n=2000, seed=0):
    csr = skewed_csr(n, n, seed)
    return CSR(csr.indptr, csr.indices, csr.data, (n, n))


def _halo_setup(csr, parts, K, dtype, dev, seed=0):
    """(partition, mesh, padded B in multiples of 0.5, halo tables)."""
    hp = build_halo_partition(csr, parts, device=dev)
    mesh = make_mesh(parts, device=dev)
    B = (torch.round(randn((parts * hp.cpp, K), dev, seed) * 2) / 2).to(dtype)
    return hp, mesh, B, make_exchange(hp, mesh)(B)


def _shard_vals(hp, kind, dev, seed):
    if kind == "binary":
        return None, None
    nnz = hp.nnz
    shape = (nnz,) if kind == "vals" else (nnz, int(kind[5:]))
    return split_edge_values(hp, randn(shape, dev, seed))


HALO_CASES = [(parts, K, reduce, kind, dtype)
              for parts in (2, 8) for K in (1, 3, 32, 130)
              for reduce in ("sum", "max", "min")
              for kind in ("binary", "vals", "heads2")
              for dtype in (torch.float32, torch.bfloat16)
              if kind != "heads2" or (reduce == "sum" and K % 2 == 0)]


def _halo_vs_plain(out, ties, hp, p, blk, dv, hv, Bs, halo_p, reduce, dtype):
    """Shard p's rows of row 7 against the unsplit plain version: a sum
    within the sum kernel's bound of float64; max/min out and joint ties
    exactly."""
    tab = (blk.d_rows, blk.d_indices, blk.h_rows, blk.h_indices)
    if reduce == "sum":
        assert ties is None
        f64 = [None if v is None else v.double() for v in (dv, hv)]
        absv = [None if v is None else v.abs() for v in f64]
        exact, _ = ref.halo_spmm_rows(tab[0], tab[1], f64[0], Bs.double(),
                                      tab[2], tab[3], f64[1],
                                      halo_p.double(), hp.rpp)
        mag, _ = ref.halo_spmm_rows(tab[0], tab[1], absv[0],
                                    Bs.double().abs(), tab[2], tab[3],
                                    absv[1], halo_p.double().abs(), hp.rpp)
        bound = 8e-3 * mag if dtype == torch.bfloat16 else 1e-5 * mag + 1e-6
        assert ((out.double() - exact).abs() <= bound).all()
    else:
        want, want_ties = ref.halo_spmm_rows(tab[0], tab[1], dv, Bs, tab[2],
                                             tab[3], hv, halo_p, hp.rpp,
                                             reduce)
        assert torch.equal(out, want) and torch.equal(ties, want_ties)


@pytest.mark.parametrize("parts,K,reduce,kind,dtype", HALO_CASES)
def test_halo_stacked_kernel_matches_plain(dev, parts, K, reduce, kind,
                                           dtype):
    """One row-7 launch over all shards, rows above L = 8 joint edges split
    (segments that cross from the diag block into the halo block), and the
    carry: each shard's rows against the unsplit plain version; two calls
    bitwise equal."""
    hp = build_halo_partition(_square_skewed(), parts, device=dev, seg_len=8)
    mesh = make_mesh(parts, device=dev)
    B = (torch.round(randn((parts * hp.cpp, K), dev, 0) * 2) / 2).to(dtype)
    halo = make_exchange(hp, mesh)(B)
    assert hp.joint_split.split.num_segments > 0
    dvs, hvs = _shard_vals(hp, kind, dev, 1)
    args = (hp.diag_indptr, hp.diag_indices, dvs, B, hp.halo_indptr,
            hp.halo_indices, hvs, halo, reduce)
    khalo.reset_launches()
    out, ties = khalo.halo_spmm_stacked(*args, split=hp.joint_split)
    again = khalo.halo_spmm_stacked(*args, split=hp.joint_split)
    torch.cuda.synchronize()
    assert (khalo.launches, khalo.carry_launches) == (2, 2)
    assert torch.equal(out, again[0])
    assert ties is None or torch.equal(ties, again[1])
    for p in range(parts):
        rows = slice(p * hp.rpp, (p + 1) * hp.rpp)
        _halo_vs_plain(out[rows], None if ties is None else ties[rows], hp, p,
                       hp.blocks(p),
                       None if dvs is None else dvs[p, :hp.diag_nnz[p]],
                       None if hvs is None else hvs[p, :hp.halo_nnz[p]],
                       B[p * hp.cpp:(p + 1) * hp.cpp], halo[p], reduce, dtype)


@pytest.mark.parametrize("parts,K,reduce,kind,dtype", HALO_CASES)
def test_halo_kernel_matches_plain(dev, parts, K, reduce, kind, dtype):
    """Row 7, shard by shard (with each shard's part of the split at the
    default L), against its plain version: a sum within the sum kernel's
    bound of float64; max/min out and joint ties exactly; two launches
    bitwise equal."""
    hp, _, B, halo = _halo_setup(_square_skewed(), parts, K, dtype, dev)
    dvs, hvs = _shard_vals(hp, kind, dev, 1)
    for p in range(parts):
        blk = hp.blocks(p)
        dv = None if dvs is None else dvs[p, :hp.diag_nnz[p]]
        hv = None if hvs is None else hvs[p, :hp.halo_nnz[p]]
        Bs = B[p * hp.cpp:(p + 1) * hp.cpp]
        args = (blk.d_indptr, blk.d_indices, dv, Bs, blk.h_indptr,
                blk.h_indices, hv, halo[p], reduce)
        before = khalo.launches
        out, ties = khalo.halo_spmm_rows(*args, split=hp.joint_split, shard=p)
        again = khalo.halo_spmm_rows(*args, split=hp.joint_split, shard=p)
        torch.cuda.synchronize()
        assert khalo.launches == before + 2
        assert torch.equal(out, again[0])
        _halo_vs_plain(out, ties, hp, p, blk, dv, hv, Bs, halo[p], reduce,
                       dtype)
        if ties is not None:
            assert torch.equal(ties, again[1])


def _whole_graph_f64(csr, B, vals, g, reduce):
    """out, grad_B, grad_vals of the whole-graph plain SpMM in float64."""
    adj = Adjacency.from_csr(csr.to("cpu"))
    m, n = adj.shape
    B64 = B.detach()[:n].double().cpu().requires_grad_(True)
    v64 = vals.detach().double().cpu().requires_grad_(True)
    out = spmm(adj.with_data(v64), B64, reduce=reduce, method="xla")
    out.backward(g.double().cpu()[:m])
    return out.detach(), B64.grad, v64.grad


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_halo_op_launches_and_never_takes_the_plain_version(dev, monkeypatch,
                                                           reduce):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "halo_spmm_rows", refuse)
    monkeypatch.setattr(ref, "halo_spmm_split_rows", refuse)
    monkeypatch.setattr(ref, "spmm_minmax_vjp_cols", refuse)
    csr = _square_skewed()
    parts = 4
    hp = build_halo_partition(csr, parts, device=dev)
    mesh = make_mesh(parts, device=dev)
    B = (torch.round(randn((parts * hp.cpp, 16), dev, 3) * 2) / 2)
    B.requires_grad_(True)
    # Values in multiples of 1/4: products exact in f32 and f64, so the
    # float64 reference meets the same ties.
    vals = (torch.randint(1, 9, (csr.nnz,), device=dev) / 4.0)
    vals.requires_grad_(True)
    dv, hv = split_edge_values(hp, vals)
    g = randn((parts * hp.rpp, 16), dev, 4)
    khalo.reset_launches()
    kmm.reset_launches()
    out = halo_spmm(hp, B, mesh, reduce=reduce, diag_vals=dv, halo_vals=hv)
    torch.cuda.synchronize()
    # Forward: one row-7 launch over the 4 shards, and the carry where the
    # joint split has a segment (the skewed graph's hub rows).
    has = [int(s.split.num_segments > 0) for s in (
        hp.joint_split, hp.diag_t_split, hp.halo_t_split)]
    assert has[0] == 1
    assert (khalo.launches, khalo.carry_launches) == (1, has[0])
    out.backward(g)
    torch.cuda.synchronize()
    if reduce in ("sum", "mean"):
        # Backward: row 7 over the stacked diag^T and halo^T blocks, each
        # with its split's carry.
        assert (khalo.launches, kmm.vjp_launches) == (3, 0)
        assert khalo.carry_launches == sum(has)
    else:
        # Backward: row 3, one launch over the stacked diag^T blocks and one
        # over the stacked halo^T blocks, each with its split's carry.
        assert (khalo.launches, kmm.vjp_launches) == (1, 2)
        assert kmm.vjp_carry_launches == sum(has[1:])
    m = csr.shape[0]
    want = _whole_graph_f64(csr, B, vals, g, reduce)
    for got, w in zip((out.detach()[:m], B.grad[:m], vals.grad), want):
        err = float((got.double().cpu() - w).abs().max())
        assert err <= 1e-5 * max(float(w.abs().max()), 1.0), err
    khalo.reset_launches()
    halo_spmm(hp, B, mesh, reduce=reduce, method="xla")
    assert khalo.launches == 0


def test_halo_kernel_without_rounds_and_refusals(dev):
    """One shard: no rounds, a zero halo table of 8 rows, a halo block
    without edges; the op still launches once forward and twice backward.
    Per-head values with max raise; zero rows launch nothing."""
    csr = _square_skewed(300)
    hp = build_halo_partition(csr, 1, device=dev)
    assert hp.rounds == () and hp.halo_rows == 8 and hp.halo_nnz == (0,)
    mesh = make_mesh(1, device=dev)
    B = randn((hp.cpp, 32), dev, 5, requires_grad=True)
    khalo.reset_launches()
    out = halo_spmm(hp, B, mesh)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert khalo.launches == 3
    want = spmm(Adjacency.from_csr(csr.to(dev)), B.detach())
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())
    blk = hp.blocks(0)
    with pytest.raises(ValueError, match="max/min"):
        khalo.halo_spmm_rows(blk.d_indptr, blk.d_indices,
                             torch.ones(hp.diag_nnz[0], 2, device=dev),
                             B.detach(), reduce="max")
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    before = khalo.launches
    o, t = khalo.halo_spmm_rows(z, z[:0], None, B.detach(), reduce="max")
    assert o.shape == (0, 32) and t.shape == (0, 32)
    assert khalo.launches == before


def test_sharded_train_steps_on_the_card(dev):
    """GCN, SAGE-pool and 2-head GAT steps over 4 shards through row 7,
    and the dry run over 8."""
    ds = sbm_graph(n_per_class=64, num_classes=3, feat_dim=16, seed=0)
    csr = add_self_loops(ds.csr)
    mesh = make_mesh(4, device=dev)
    for build, kw in ((build_sharded_gcn, {}),
                      (build_sharded_sage, {"aggregator": "pool"}),
                      (build_sharded_gat, {"heads": 2})):
        step, (model, opt), prepare, _ = build(csr, 16, 8, 3, mesh, **kw)
        x, labels, mask = prepare(ds.features, ds.labels, ds.masks["train"])
        khalo.reset_launches()
        losses = [float(step(model, opt, x, labels, mask)[2])
                  for _ in range(10)]
        # Row 7 a step: one launch an aggregation over the 4 shards, and
        # two for a sum aggregation's backward (GCN and GAT: 2 + 4; SAGE-pool
        # 2, its max backward on row 3); no row above L, so no carry.
        per_step = 2 if kw.get("aggregator") == "pool" else 6
        assert losses[-1] < losses[0]
        assert (khalo.launches, khalo.carry_launches) == (10 * per_step, 0)
    losses = dryrun_multichip(8, device=dev)
    assert all(np.isfinite(v) for v in losses.values())


def test_model_axis_on_the_card(dev):
    """(4, 2) in one process: halo_spmm one row-7 launch a slice, equal to
    (4, 1); the sharded GCN 9 row-7 launches a step (6 on (4, 1)) and the
    same logits from the same parameters."""
    ds = sbm_graph(n_per_class=64, num_classes=3, feat_dim=16, seed=0)
    csr = add_self_loops(ds.csr)
    hp = build_halo_partition(csr, 4, device=dev)
    B = torch.randn(4 * hp.cpp, 16, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    outs = []
    for model in (1, 2):
        khalo.reset_launches()
        outs.append(halo_spmm(hp, B, make_mesh(4, model, device=dev)))
        torch.cuda.synchronize()
        assert khalo.launches == model
    assert torch.equal(outs[0], outs[1])
    logits = []
    for model in (1, 2):
        step, (gcn, opt), prepare, _ = build_sharded_gcn(
            csr, 16, 8, 3, make_mesh(4, model, device=dev))
        if logits:
            gcn.load_state_dict(state)
        state = {k: v.clone() for k, v in gcn.state_dict().items()}
        x, labels, mask = prepare(ds.features, ds.labels, ds.masks["train"])
        with torch.no_grad():
            logits.append(gcn(x))
        khalo.reset_launches()
        step(gcn, opt, x, labels, mask)
        torch.cuda.synchronize()
        assert (khalo.launches, khalo.carry_launches) == (
            (6, 0) if model == 1 else (9, 0))
    scale = float(logits[0].abs().max())
    assert float((logits[1] - logits[0]).abs().max()) <= 1e-5 * scale


def test_dist_bench_on_the_card_launches_rows_7_and_1(dev):
    from gespmm_tpu_torch.bench.dist_bench import bench_weak_scaling

    for method, kernel in (("halo-tiled", khalo), ("allgather", kspmm)):
        kernel.reset_launches()
        rows = bench_weak_scaling([1, 2], scale=9, k=16, edge_factor=8,
                                  iters=5, method=method, partition="auto",
                                  device=dev)
        torch.cuda.synchronize()
        assert kernel.launches > 0, method
        assert [r["devices"] for r in rows] == [1, 2]
        assert all(r["ms"] > 0 for r in rows)


# --- interop, the stock baselines, SAGE-LSTM, the GAT chunk route and
# --- checkpoint/resume on the card --------------------------------------


@pytest.fixture
def small_sbm(dev):
    return sbm_graph(n_per_class=300, num_classes=3, p_in=0.02, p_out=0.001,
                     feat_dim=32, seed=0).to(dev)


def test_adjacency_matrix_runs_the_csr_kernel(dev, small_sbm, monkeypatch):
    from gespmm_tpu_torch.ops.interop import (AdjacencyMatrix,
                                              csr_from_torch_sparse,
                                              csr_to_torch_sparse)

    adj = Adjacency.from_csr(add_self_loops(small_sbm.csr))
    A = AdjacencyMatrix(adj)
    m, n = A.shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, 32, device=dev, generator=gen, requires_grad=True)
    y = torch.randn(8, m, device=dev, generator=gen)
    v = torch.randn(n, device=dev, generator=gen)
    d = adj.data.clone().requires_grad_(True)
    calls = []
    mm = torch.sparse.mm
    monkeypatch.setattr(torch.sparse, "mm",
                        lambda *a, **k: calls.append(1) or mm(*a, **k))
    kspmm.reset_launches()
    out = A.with_data(d) @ x
    g = torch.randn_like(out)
    out.backward(g)
    left, vec, tr = y @ A, A @ v, A.T @ y.t()
    torch.cuda.synchronize()
    assert kspmm.launches == 5 and not calls
    check_bound(out.detach(), adj.csr, x.detach(), adj.data)
    csc_t = adj.transpose().csr
    check_bound(left.t(), csc_t, y.t(), csc_t.data)
    check_bound(tr, csc_t, y.t(), csc_t.data)
    check_bound(vec[:, None], adj.csr, v[:, None], adj.data)
    d64 = adj.data.double().requires_grad_(True)
    x64 = x.detach().double().requires_grad_(True)
    spmm(adj.with_data(d64), x64, method="xla").backward(g.double())
    for got, want in ((x.grad, x64.grad), (d.grad, d64.grad)):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-5 * max(float(want.abs().max()), 1.0)
    back = csr_from_torch_sparse(csr_to_torch_sparse(adj.csr))
    assert torch.equal(back.indptr, adj.csr.indptr)
    assert torch.equal(back.indices, adj.csr.indices)
    assert torch.equal(back.data, adj.data)


@pytest.mark.parametrize("name", ["gcn", "sage-mean", "sage-pool", "gat"])
def test_stock_baselines_match_ours_and_train(dev, small_sbm, name):
    from gespmm_tpu_torch.models.baselines import GATStock, GCNBcoo, SAGEStock

    ds = small_sbm
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    if name == "gcn":
        adj = Adjacency.from_csr(add_self_loops(ds.csr))
        ours = GCN([32, 16, 3], generator=gen(), device=dev)
        stock = GCNBcoo([32, 16, 3], generator=gen(), device=dev)
        operand = GCNBcoo.from_adjacency(adj)
    elif name == "gat":
        adj = Adjacency.from_csr(add_self_loops(ds.csr))
        ours = GAT([32, 16, 3], generator=gen(), device=dev)
        stock = GATStock([32, 16, 3], generator=gen(), device=dev)
        operand = GATStock.from_adjacency(adj)
    else:
        agg = name.split("-")[1]
        adj = Adjacency.from_csr(ds.csr)
        ours = GraphSAGE([32, 16, 3], aggregator=agg, generator=gen(),
                         device=dev)
        stock = SAGEStock([32, 16, 3], agg, generator=gen(), device=dev)
        operand = SAGEStock.from_adjacency(adj, agg)
    stock.load_state_dict(ours.state_dict())
    with torch.no_grad():
        want = ours.eval()(adj, ds.features)
        got = stock.eval()(operand, ds.features)
    assert float((got - want).abs().max()) <= \
        1e-5 * float(want.abs().max()) + 1e-6
    for mod in (kspmm, kmm, kedge, kgat, kpal):
        mod.reset_launches()
    res = train_node_classifier(stock, operand, ds.features, ds.labels,
                                ds.masks, epochs=20, lr=5e-3 if name == "gat"
                                else 1e-2)
    loss = res["history"]["loss"]
    assert loss[-1] < loss[0] and np.all(np.isfinite(loss))
    assert res["train_acc"] > 1 / 3
    assert not (kspmm.launches or kmm.launches or kedge.launches
                or kgat.launches or kpal.launches)


def test_gat_stock_step_memory_stays_sparse(dev):
    """One training step of ``GATStock`` [128, 64, 3] at pubmed scale holds
    less than a quarter of a dense n x n f32 matrix above its start: the
    gradient to alpha stays O(nnz K), where ``torch.sparse.mm`` over a
    matrix of alpha forms it as a dense m x n one."""
    from gespmm_tpu_torch.bench.gcn_bench import SBM_PUBMED
    from gespmm_tpu_torch.models.baselines import GATStock

    ds = sbm_graph(**SBM_PUBMED).to(dev)
    adj = Adjacency.from_csr(add_self_loops(ds.csr))
    model = GATStock([128, 64, 3],
                     generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    operand = GATStock.from_adjacency(adj)
    opt = torch.optim.AdamW(model.parameters(), lr=5e-3)
    gen = torch.Generator(device=dev).manual_seed(1)
    train = ds.masks["train"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logp = model.log_probs(operand, ds.features, generator=gen)
    loss = torch.nn.functional.nll_loss(logp[train], ds.labels[train])
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    n = adj.shape[0]
    peak = torch.cuda.max_memory_allocated() - base
    assert np.isfinite(float(loss.detach()))
    assert peak <= n * n * 4 // 4, (peak, n)


def test_sage_lstm_trains_and_matches_float64(dev, small_sbm):
    from gespmm_tpu_torch.models.sage_lstm import build_neighbor_table

    ds = small_sbm
    adj = Adjacency.from_csr(ds.csr)
    table = build_neighbor_table(ds.csr, max_neighbors=8)
    assert table[0].device.type == "cuda"
    model = GraphSAGE([32, 16, 3], aggregator="lstm", neighbor_table=table,
                      generator=torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    res = train_node_classifier(model, adj, ds.features, ds.labels, ds.masks,
                                epochs=20)
    loss = res["history"]["loss"]
    assert loss[-1] < loss[0] and res["train_acc"] > 1 / 3
    cpu = GraphSAGE([32, 16, 3], aggregator="lstm",
                    neighbor_table=tuple(t.cpu() for t in table)).double()
    cpu.load_state_dict({k: v.cpu().double()
                         for k, v in model.state_dict().items()})
    with torch.no_grad():
        got = model.eval()(adj, ds.features)
        want = cpu.eval()(Adjacency.from_csr(ds.csr.to("cpu")),
                          ds.features.cpu().double())
    assert float((got.cpu().double() - want).abs().max()) <= \
        1e-4 * float(want.abs().max())


@pytest.mark.parametrize("heads", [1, 2])
def test_gat_pallas_route_launches_rows_8_and_4(dev, small_sbm, heads):
    ds = small_sbm
    adj = Adjacency.from_csr(add_self_loops(ds.csr), plan="perrow",
                             rows_per_block=64, chunk_nnz=64)
    model = GAT([32, 8, 3], heads=heads, method="pallas",
                generator=torch.Generator(device=dev).manual_seed(0),
                device=dev)
    for mod in (kspmm, kedge, kgat, kpal):
        mod.reset_launches()
    res = train_node_classifier(model, adj, ds.features, ds.labels, ds.masks,
                                epochs=10, lr=5e-3)
    torch.cuda.synchronize()
    loss = res["history"]["loss"]
    assert loss[-1] < loss[0] and np.all(np.isfinite(loss))
    # A head a layer, each epoch: 2 segment reduces and 1 chunk launch
    # forward, 3 segment sums and 1 chunk launch backward; the final
    # evaluation adds the forward once.
    per_layer_heads = 2 * heads
    assert kedge.launches == per_layer_heads * (5 * 10 + 2)
    assert kpal.launches == per_layer_heads * (2 * 10 + 1)
    assert kedge.carry_launches == 0
    assert kgat.launches == kgat.bwd_rows_launches == kspmm.launches == 0
    cpu = GAT([32, 8, 3], heads=heads, method="xla").double()
    cpu.load_state_dict({k: v.cpu().double()
                         for k, v in model.state_dict().items()})
    with torch.no_grad():
        got = model.eval()(adj, ds.features)
        want = cpu.eval()(Adjacency.from_csr(adj.csr.to("cpu").with_data(
            adj.data.cpu().double())), ds.features.cpu().double())
    assert float((got.cpu().double() - want).abs().max()) <= \
        1e-4 * float(want.abs().max())


def test_checkpoint_resume_equals_the_straight_run(dev, small_sbm, tmp_path):
    ds = small_sbm
    adj = Adjacency.from_csr(add_self_loops(ds.csr))

    def model():
        return GCN([32, 16, 3], generator=torch.Generator(
            device=dev).manual_seed(0), device=dev).with_norms(adj)

    straight = model()
    train_node_classifier(straight, adj, ds.features, ds.labels, ds.masks,
                          epochs=10)
    train_node_classifier(model(), adj, ds.features, ds.labels, ds.masks,
                          epochs=5, checkpoint_dir=str(tmp_path),
                          checkpoint_every=5)
    resumed = model()
    res = train_node_classifier(resumed, adj, ds.features, ds.labels,
                                ds.masks, epochs=10,
                                checkpoint_dir=str(tmp_path),
                                checkpoint_every=5)
    assert len(res["history"]["loss"]) == 5
    for k, want in straight.state_dict().items():
        got = resumed.state_dict()[k]
        assert float((got - want).abs().max()) <= \
            1e-6 * float(want.abs().max())
