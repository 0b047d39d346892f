"""The sharded tier across processes: gloo on the CPU.

The other sharded tests hold every shard in one process, where the exchange
is an ``index_select``.  Here OS processes join a ``torch.distributed`` gloo
group on a free local port, and ``halo_spmm``'s exchange runs its
point-to-point rounds (``parallel/halo.py::_Rounds``).

Two processes, one shard each: ``halo_spmm`` sum and max, forward and
backward (B and runtime edge values), ``dist_spmm``'s all-gather and one
data-parallel GCN step must equal the one-process result.

Four processes on a 2 x 2 (data, model) grid, one cell each: the rounds run
over each rank's data group, the GCN's output contraction ``all_reduce``s
over its model group; ``halo_spmm`` sum and max (forward and backward, B
and runtime edge values, whose gradient each rank sums over its model
group) and one GCN step, its gradients included (an ``all_reduce`` in the
contraction's backward would double them), must equal the one-process
(2, 2) mesh.  The same grid over NCCL, one rank a card, needs four cards:

    python -m pytest tests/test_torch_multiprocess.py --noconftest -s -k nccl

Forwards exactly (the exchange copies rows), gradients and the step to
1e-6 * max(|ref|, 1) (the sums of a row's gradient meet in another order).
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gespmm_tpu_torch.ops.graph import add_self_loops
from gespmm_tpu_torch.parallel import (build_halo_partition, dist_spmm,
                                       halo_spmm, make_mesh, pad_for_halo,
                                       partition_adjacency)
from gespmm_tpu_torch.parallel.halo import split_edge_values
from gespmm_tpu_torch.parallel.train_step import build_sharded_gcn
from gespmm_tpu_torch.sparse.formats import csr_from_scipy
from gespmm_tpu_torch.utils.datasets import sbm_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _problem():
    """The graph, B, cotangent and edge values every process builds alike."""
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    mat = sp.random(96, 96, density=0.08, random_state=rng, format="csr",
                    dtype=np.float32)
    mat.data[:] = rng.standard_normal(mat.nnz).astype(np.float32)
    mat.sort_indices()
    B = (np.round(rng.standard_normal((96, 16)) * 2) / 2).astype(np.float32)
    g = rng.standard_normal((96, 16)).astype(np.float32)
    return csr_from_scipy(mat), B, g, mat.data.copy()


def run(mesh):
    """The results of every checked op for the local shards of ``mesh``,
    as a dict of numpy arrays (the local rows of each output)."""
    csr, B, g, vals = _problem()
    hp = build_halo_partition(csr, mesh.data, device="cpu")
    shards = mesh.local_shards
    rows = slice(shards[0] * hp.cpp, (shards[-1] + 1) * hp.cpp)
    out_rows = slice(shards[0] * hp.rpp, (shards[-1] + 1) * hp.rpp)
    res = {}
    for reduce in ("sum", "max"):
        Bl = pad_for_halo(hp, torch.from_numpy(B))[rows].clone()
        Bl.requires_grad_(True)
        v = torch.from_numpy(vals).requires_grad_(True)
        dv, hv = split_edge_values(hp, v)
        local = slice(shards[0], shards[-1] + 1)
        out = halo_spmm(hp, Bl, mesh, reduce=reduce, diag_vals=dv[local],
                        halo_vals=hv[local])
        gl = torch.from_numpy(np.concatenate(
            [g, np.zeros((hp.num_parts * hp.rpp - 96, 16), np.float32)]))
        (out * gl[out_rows]).sum().backward()
        res[f"{reduce}_out"] = out.detach().numpy()
        res[f"{reduce}_grad_B"] = Bl.grad.numpy()
        # Each process's value gradient covers its own shards' edges.
        res[f"{reduce}_grad_vals"] = v.grad.numpy()
    padj = partition_adjacency(csr, mesh.data, device="cpu")
    Bd = torch.from_numpy(B).requires_grad_(True)
    per = 96 // mesh.data
    Bd_local = Bd if mesh.group is None else Bd[shards[0] * per:
                                                (shards[0] + 1) * per]
    out = dist_spmm(padj, Bd_local, mesh)
    out.sum().backward()
    res["dist_out"] = out.detach().numpy()
    res["dist_grad_B"] = Bd.grad.numpy()
    ds = sbm_graph(n_per_class=16, num_classes=3, feat_dim=8, seed=0)
    step, (model, opt), prepare, _ = build_sharded_gcn(
        add_self_loops(ds.csr), 8, 8, 3, mesh)
    x, labels, mask = prepare(ds.features, ds.labels, ds.masks["train"])
    _, _, loss = step(model, opt, x, labels, mask)
    res["gcn_loss"] = np.asarray(float(loss))
    for name, p in model.state_dict().items():
        res[f"gcn_{name}"] = p.numpy()
    return res


def run_grid(mesh):
    """The checked results of the local cell(s) of a (data, model) mesh:
    ``halo_spmm`` on the local shards' rows and slices' columns, and one
    GCN step with its gradients."""
    csr, B, g, vals = _problem()
    dev = mesh.device
    hp = build_halo_partition(csr, mesh.data, device=dev)
    shards, slices = mesh.local_shards, mesh.local_slices
    w = B.shape[1] // mesh.model
    rows = slice(shards[0] * hp.cpp, (shards[-1] + 1) * hp.cpp)
    out_rows = slice(shards[0] * hp.rpp, (shards[-1] + 1) * hp.rpp)
    cols = slice(slices[0] * w, (slices[-1] + 1) * w)
    gl = torch.from_numpy(np.concatenate(
        [g, np.zeros((hp.num_parts * hp.rpp - 96, g.shape[1]), np.float32)]))
    local = slice(shards[0], shards[-1] + 1)
    res = {}
    for reduce in ("sum", "max"):
        Bl = pad_for_halo(hp, torch.from_numpy(B))[rows, cols].to(dev)
        Bl.requires_grad_(True)
        v = torch.from_numpy(vals).to(dev).requires_grad_(True)
        dv, hv = split_edge_values(hp, v)
        out = halo_spmm(hp, Bl, mesh, reduce=reduce, diag_vals=dv[local],
                        halo_vals=hv[local])
        (out * gl[out_rows, cols].to(dev)).sum().backward()
        res[f"{reduce}_out"] = out.detach().cpu().numpy()
        res[f"{reduce}_grad_B"] = Bl.grad.cpu().numpy()
        # The rank's shard's edges, summed over its model group's slices.
        res[f"{reduce}_grad_vals"] = v.grad.cpu().numpy()
    ds = sbm_graph(n_per_class=16, num_classes=3, feat_dim=8, seed=0)
    step, (model, opt), prepare, _ = build_sharded_gcn(
        add_self_loops(ds.csr), 8, 8, 3, mesh)
    x, labels, mask = prepare(ds.features, ds.labels, ds.masks["train"])
    _, _, loss = step(model, opt, x, labels, mask)
    res["gcn_loss"] = np.asarray(float(loss))
    for name, p in model.named_parameters():
        res[f"gcn_{name}"] = p.detach().cpu().numpy()
        res[f"gcn_grad_{name}"] = p.grad.cpu().numpy()
    return res


# The worker imports this file by its directory, not as ``tests.<name>``: a
# machine may have another top-level ``tests`` package installed.
WORKER = """
import os, sys, numpy as np, torch.distributed as dist
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from gespmm_tpu_torch.parallel.mesh import maybe_distributed_init, make_mesh
from test_torch_multiprocess import run, run_grid
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
model, backend, device = int(sys.argv[5]), sys.argv[6], sys.argv[7]
if device == "cuda":  # one card a rank
    import torch
    device = f"cuda:{rank}"
    torch.cuda.set_device(device)
group = maybe_distributed_init(f"tcp://localhost:{port}", world, rank, backend)
mesh = make_mesh(world // model, model, group=group, device=device)
res = (run if model == 1 else run_grid)(mesh)
np.savez(out, **res)
dist.destroy_process_group()
print("OK rank", rank)
"""


def spawn(out_dir, world: int, model: int, backend: str = "gloo",
          device: str = "cpu", timeout: float = TIMEOUT_S):
    """Run the worker on ``world`` ranks of ``model`` slices (``device``
    "cuda": rank r on card r), each with its own timeout; each rank's
    results, in rank order."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [os.path.join(str(out_dir), f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(world), port, outs[r], str(model), backend,
                               device],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"OK rank {r}" in log, log[-4000:]
    return [dict(np.load(o)) for o in outs]


def _within(got, want, key):
    bound = 1e-6 * max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= bound, (key, err, bound)
    return err


def check_grid(ranks, want):
    """Hold the four cells' results (rank r holds cell divmod(r, 2)) to the
    one-process (2, 2) run ``want``; returns each key's max_abs_err."""
    errs = {}
    for key, value in want.items():
        if key.endswith(("_out", "grad_B")):  # [shard rows][slice columns]
            got = np.block([[ranks[0][key], ranks[1][key]],
                            [ranks[2][key], ranks[3][key]]])
            if key.endswith("_out"):
                np.testing.assert_array_equal(got, value, err_msg=key)
            errs[key] = _within(got, value, key)
            continue
        if key.endswith("grad_vals"):  # a data row's two slices agree
            for d in (0, 2):
                np.testing.assert_array_equal(ranks[d + 1][key],
                                              ranks[d][key], err_msg=key)
            errs[key] = _within(ranks[0][key] + ranks[2][key], value, key)
            continue
        # The GCN: the two data ranks of a model column hold equal results
        # (the gradient and loss sums ran over the data group).
        for m in (0, 1):
            np.testing.assert_array_equal(ranks[2 + m][key], ranks[m][key],
                                          err_msg=key)
        name = key.split("_")[-1]
        if name in ("l1.w", "l1.b"):  # column slices
            got = np.concatenate([ranks[0][key], ranks[1][key]], axis=-1)
        elif name == "l2.w":  # row slices
            got = np.concatenate([ranks[0][key], ranks[1][key]])
        else:  # l2.b and the loss, replicated over the model axis
            np.testing.assert_array_equal(ranks[1][key], ranks[0][key],
                                          err_msg=key)
            got = ranks[0][key]
        errs[key] = _within(got, value, key)
    return errs


def test_four_process_gloo_grid_equals_one_process(tmp_path):
    check_grid(spawn(tmp_path, 4, 2), run_grid(make_mesh(2, 2, device="cpu")))


@pytest.mark.cuda
def test_four_rank_nccl_grid_equals_one_process(tmp_path):
    """The 2 x 2 grid over NCCL, rank r on card r, against one process
    running the (2, 2) mesh on card 0.  Prints each key's max_abs_err and
    the cards (run with ``-s``)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: NCCL puts one rank on a card")
    from gespmm_tpu_torch.kernels import _build

    # Build the grid's two libraries once, before the ranks load them.
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.build, ("halo_spmm", "spmm_minmax")))
    ranks = spawn(tmp_path, 4, 2, backend="nccl", device="cuda", timeout=300)
    errs = check_grid(ranks, run_grid(make_mesh(2, 2, device="cuda:0")))
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip().splitlines()
    print(json.dumps({"nccl_grid_2x2_max_abs_err": errs, "cards": cards}))


def test_two_process_gloo_equals_one_process(tmp_path):
    ranks = spawn(tmp_path, WORLD, 1)
    want = run(make_mesh(WORLD, device="cpu"))
    for key, value in want.items():
        if key.endswith("_out"):  # the local rows, exactly
            np.testing.assert_array_equal(
                np.concatenate([r[key] for r in ranks]), value, err_msg=key)
            continue
        # Gradients of full-size leaves: each rank holds its share.
        got = ranks[0][key] + ranks[1][key] if key.endswith(
            ("grad_vals", "dist_grad_B")) else (
            np.concatenate([r[key] for r in ranks])
            if key.endswith("grad_B") else ranks[0][key])
        if not key.endswith(("grad_B", "grad_vals")):  # replicated
            np.testing.assert_allclose(ranks[1][key], got, rtol=0, atol=0,
                                       err_msg=key)
        bound = 1e-6 * max(float(np.abs(value).max()), 1.0)
        err = float(np.abs(got - value).max())
        assert err <= bound, (key, err, bound)
