"""The sharded tier across two processes: gloo on the CPU.

The other sharded tests hold every shard in one process, where the exchange
is an ``index_select``.  Here two OS processes, one shard each, join a
``torch.distributed`` gloo group on a free local port, and ``halo_spmm``'s
exchange runs its point-to-point rounds (``parallel/halo.py::_Rounds``).
``halo_spmm`` sum and max, forward and backward (B and runtime edge values),
``dist_spmm``'s all-gather and one data-parallel GCN step must equal the
one-process result: forwards exactly (the exchange copies rows), gradients
and the step to 1e-6 * max(|ref|, 1) (the sums of a row's gradient meet in
another order).
"""

import os
import socket
import subprocess
import sys

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


WORKER = """
import sys, numpy as np, torch.distributed as dist
from gespmm_tpu_torch.parallel.mesh import maybe_distributed_init, make_mesh
from tests.test_torch_multiprocess import run
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
group = maybe_distributed_init(f"tcp://localhost:{port}", world, rank, "gloo")
res = run(make_mesh(world, group=group, device="cpu"))
np.savez(out, **res)
dist.destroy_process_group()
print("OK rank", rank)
"""


def test_two_process_gloo_equals_one_process(tmp_path):
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(WORLD), port, outs[r]], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"OK rank {r}" in log, log[-4000:]
    ranks = [dict(np.load(o)) for o in outs]
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
