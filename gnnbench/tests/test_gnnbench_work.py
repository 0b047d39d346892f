"""The work of a step counted from shapes, against hand counts."""

import json

import pytest

from gnnbench import harness, roofline
from gnnbench.models import gcn, sage

N = 2_449_029
NNZ_LOOPS = 126_167_309
NNZ = 123_718_280


def _config(name):
    return json.loads((harness.PACKAGE / "configs" / f"{name}.json").read_text())


def test_gcn_counts():
    cfg = _config("gcn-ogbn-products")
    # x @ W0 forward and its weight gradient; layers 1 and 2 also the
    # input gradient.
    hand = (2 * 2 * N * 100 * 256 + 3 * 2 * N * 256 * 256
            + 3 * 2 * N * 256 * 47)
    assert gcn.dense_flops(cfg, N) == hand
    calls = gcn.spmm_calls(cfg, N, NNZ_LOOPS)
    assert sorted(k for _, _, k in calls) == [47, 47, 256, 256, 256, 256]
    total = hand + sum(roofline.spmm_flops(nnz, k) for _, nnz, k in calls)
    assert total == pytest.approx(1.67e12, rel=0.01)


def test_sage_counts():
    cfg = _config("sage-mean-ogbn-products")
    hand = 2 * (2 * 2 * N * 100 * 256 + 3 * 2 * N * 256 * 256
                + 3 * 2 * N * 256 * 47)
    assert sage.dense_flops(cfg, N) == hand
    assert hand == pytest.approx(2.78e12, rel=0.01)
    calls = sage.spmm_calls(cfg, N, NNZ)
    assert sorted(k for _, _, k in calls) == [100, 256, 256, 256, 256]


def test_spmm_bytes_and_bound_by_hand():
    k = 256
    hand = (N + 1) * 4 + NNZ_LOOPS * 4 + 2 * N * k * 4
    assert roofline.spmm_bytes(NNZ_LOOPS, N, k) == hand
    t, term = roofline.bound(hand, 2 * NNZ_LOOPS * k)
    assert term == "bytes" and t == pytest.approx(hand / 3.35e12)
    # A step of the GCN: four K=256 calls and two K=47, each bounded alone.
    cfg = _config("gcn-ogbn-products")
    step = roofline.spmm_bound_s(gcn.spmm_calls(cfg, N, NNZ_LOOPS))
    k47 = (N + 1) * 4 + NNZ_LOOPS * 4 + 2 * N * 47 * 4
    assert step == pytest.approx((4 * hand + 2 * k47) / 3.35e12)
    assert 7e-3 < step < 8e-3


def test_matmul_flops():
    assert roofline.matmul_flops(3, 4, 5) == 120
