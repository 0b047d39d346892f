"""Sharded SpMM weak-scaling benchmark — port of ``gespmm_tpu/bench/dist_bench.py``.

The problem grows with the shard count (an R-MAT graph of 2^(scale +
log2 P) nodes over P shards), and each row reports nnz/s and the weak-scaling
efficiency against the first count's per-shard rate.  ``--method``:
``halo-tiled`` (``parallel/halo.py::halo_spmm``, kernel row 7 on the card),
``halo`` (its plain tier) or ``allgather`` (``parallel/dist_spmm.py``, one
row-1 launch a slab).  ``--partition`` applies ``sparse/reorder.py::
partition_order`` before the halo split (halo methods, P > 1), and the row
gives the naive slab split's padded footprint beside the partitioned
exchange's.

Without a process group, one process holds every shard on one card:
"devices" is then the number of shards, and the first line warns that the
efficiency measures contention on that card, not scaling.  Times are device
times of the op alone (``utils/timing.py::device_time``); on the CPU, host
times.  With ``--init-method`` (and ``--backend``, ``--world-size``,
``--rank``) each rank holds its shard, ``--devices`` must be the world size,
times are CUDA-event times around groups of calls (host clock on the CPU),
and rank 0 prints.  After the rows, a last line gives the kernel launches of
the whole run (``{"kernel_launches": {...}}``; 0 on the CPU, where the
plain versions run).

Run:  python -m gespmm_tpu_torch.bench.dist_bench --devices 1 2 4 --scale 15 \\
          --k 64 --method halo-tiled --partition auto
"""

from __future__ import annotations

import argparse
import json
import os


def bench_weak_scaling(devices_list, scale, k, edge_factor, iters=20,
                       method="xla", partition="none", device="cuda",
                       group=None):
    """One JSON row a shard count (printed, and returned as a list), with
    the JAX package's keys.  ``method`` other than "halo"/"halo-tiled" runs
    the all-gather tier, as in the JAX package."""
    import numpy as np
    import torch

    from gespmm_tpu_torch.parallel.dist_spmm import (dist_spmm,
                                                     partition_adjacency)
    from gespmm_tpu_torch.parallel.halo import (build_halo_partition,
                                                halo_spmm, pad_for_halo)
    from gespmm_tpu_torch.parallel.mesh import make_mesh
    from gespmm_tpu_torch.sparse.reorder import (apply_permutation,
                                                 halo_need_stats,
                                                 partition_order)
    from gespmm_tpu_torch.utils import timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph

    device = torch.device(device)
    rank = 0 if group is None else torch.distributed.get_rank(group)
    emit = print if rank == 0 else (lambda *a, **k: None)
    if group is None and max(devices_list) > 1:
        emit(json.dumps({"warning": "one device holds every shard: efficiency "
                         "numbers measure contention, not scaling"}))
    elif group is not None:
        world = torch.distributed.get_world_size(group)
        if list(devices_list) != [world]:
            raise ValueError(f"under a process group --devices must be the "
                             f"world size [{world}], got {list(devices_list)}")
    results = []
    base_rate = None
    for nd in devices_list:
        # Weak scaling: grow nodes with the shard count (edges ~linearly).
        extra = int(np.log2(nd))
        csr = rmat_graph(scale=scale + extra, edge_factor=edge_factor, seed=0)
        mesh = make_mesh(nd, group=group, device=device)
        n = csr.shape[1]
        B = torch.from_numpy(
            np.random.default_rng(0).standard_normal((n, k)).astype(np.float32))
        halo_frac = naive_frac = None
        if method in ("halo", "halo-tiled"):
            if partition != "none" and nd > 1:
                # Permute the graph so that equal row slabs coincide with
                # the computed shards; B follows the same permutation.
                naive_frac = round(halo_need_stats(csr, nd)["footprint_frac"],
                                   4)
                perm = partition_order(csr, nd, method=partition)
                csr = apply_permutation(csr, perm)
                B = B[torch.from_numpy(perm)]
            hp = build_halo_partition(csr, nd, tiled=(method == "halo-tiled"),
                                      device=device)
            halo_frac = round(hp.footprint_fraction, 4)
            B = pad_for_halo(hp, B)
            if group is not None:
                B = B[rank * hp.cpp:(rank + 1) * hp.cpp]
            B = B.to(device)
            tier = "tiled" if method == "halo-tiled" else "xla"

            def run(hp=hp, B=B, mesh=mesh, tier=tier):
                return halo_spmm(hp, B, mesh, method=tier, model_axis=None)
        else:  # the all-gather reference tier
            padj = partition_adjacency(csr, nd, device=device)
            if group is not None:
                B = B[rank * (n // nd):(rank + 1) * (n // nd)]
            B = B.to(device)

            def run(padj=padj, B=B, mesh=mesh):
                return dist_spmm(padj, B, mesh, model_axis=None)
        if device.type == "cuda" and group is None:
            dt = timing.device_time(run, iters=iters)
        else:
            dt = timing.benchmark(run, iters=iters).median_s
        rate = csr.nnz / dt
        if base_rate is None:
            base_rate = rate / nd  # the per-shard rate at the first count
        eff = rate / (base_rate * nd)
        row = {
            "devices": nd,
            "nodes": csr.shape[0],
            "nnz": csr.nnz,
            "k": k,
            "ms": round(dt * 1e3, 3),
            "nnz_per_s": round(rate, 0),
            "weak_scaling_efficiency": round(eff, 4),
            **({} if halo_frac is None else {"halo_footprint_frac": halo_frac}),
            **({} if naive_frac is None else
               {"naive_footprint_frac": naive_frac, "partition": partition}),
        }
        results.append(row)
        emit(json.dumps(row))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--scale", type=int, default=13,
                   help="log2 nodes at 1 device")
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--edge-factor", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--method", default="halo-tiled",
                   choices=["allgather", "halo", "halo-tiled"])
    p.add_argument("--partition", default="none",
                   choices=["none", "auto", "fennel", "random"],
                   help="cut-reducing node partition applied before the "
                        "halo split (sparse/reorder.py::partition_order)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--init-method", default=None,
                   help="join a torch.distributed group here (e.g. "
                        "tcp://localhost:29500); one shard a rank")
    p.add_argument("--backend", default=None, help="'nccl' or 'gloo'")
    p.add_argument("--world-size", type=int,
                   default=int(os.environ.get("WORLD_SIZE", "1")))
    p.add_argument("--rank", type=int, default=int(os.environ.get("RANK", "0")))
    args = p.parse_args(argv)

    import torch.distributed as dist

    from gespmm_tpu_torch.kernels import halo_spmm as khalo
    from gespmm_tpu_torch.kernels import spmm_csr as kspmm
    from gespmm_tpu_torch.parallel.mesh import maybe_distributed_init

    group = maybe_distributed_init(args.init_method, args.world_size,
                                   args.rank, args.backend)
    try:
        bench_weak_scaling(args.devices, args.scale, args.k, args.edge_factor,
                           args.iters, method=args.method,
                           partition=args.partition, device=args.device,
                           group=group)
        if group is None or dist.get_rank(group) == 0:
            print(json.dumps({"kernel_launches": {
                "halo_spmm": khalo.launches,
                "halo_spmm_carry": khalo.carry_launches,
                "spmm_csr": kspmm.launches,
                "spmm_csr_carry": kspmm.carry_launches}}))
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
