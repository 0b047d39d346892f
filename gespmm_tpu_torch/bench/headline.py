"""The port's headline line — counterpart of the repository's ``bench.py``.

    python -m gespmm_tpu_torch.bench.headline [--device cuda]

Prints exactly one JSON line:

    {"metric": "spmm_gflops_<graph>_k128", "value": ..., "unit": "GFLOP/s",
     "vs_baseline": ...}

The graph is pubmed where ``utils/datasets.py::find_graph("pubmed")`` finds
it, else ``rmat_graph(scale=15, edge_factor=8, seed=0)`` ("rmat15"), as in
``bench.py``; K = 128.  ``value`` is 2·nnz·K over the device time of one
``spmm(adj, B, method="auto")`` call (on the card the CSR kernel, kernel
row 1); ``vs_baseline`` is the time of the stock library's call, the
``torch.sparse.mm`` of ``ops/interop.py::torch_sparse_spmm_baseline``
(cuSPARSE on the card), over ours.  Each side's operands are built once,
outside the timed calls.

Both are timed on the op alone with ``utils/timing.py::device_time``, not
with ``bench.py``'s chained ``spmm(...) * 0.5``: XLA fuses that scale into
its program, while eager PyTorch launches it as a second kernel, about
10 µs of HBM traffic at this shape, a quarter of row 1's time, which would
blur both sides' times.  On the CPU (``--device cpu``) the times are the
host clock's median.
"""

from __future__ import annotations

import argparse
import json

K = 128


def headline(csr=None, name: str = "rmat15", k: int = K, device="cuda",
             iters: int = 50) -> dict:
    """The headline record for ``csr`` (default: pubmed if found, else
    rmat15) at width ``k`` on ``device``."""
    import numpy as np
    import torch

    from gespmm_tpu_torch.ops.interop import csr_to_torch_sparse
    from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
    from gespmm_tpu_torch.utils import timing
    from gespmm_tpu_torch.utils.datasets import (find_graph, load_mtx_graph,
                                                 rmat_graph)

    device = torch.device(device)
    if csr is None:
        if find_graph("pubmed"):
            csr, name = load_mtx_graph("pubmed", binary=True), "pubmed"
        else:
            csr, name = rmat_graph(scale=15, edge_factor=8, seed=0), "rmat15"
    adj = Adjacency.from_csr(csr, device=device)
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (csr.shape[1], k)).astype(np.float32) * 0.01).to(device)
    lib = csr_to_torch_sparse(adj.csr)

    def seconds(fn):
        if device.type == "cuda":
            return timing.device_time(fn, iters=iters)
        return timing.benchmark(fn, iters=iters).median_s

    ours = seconds(lambda: spmm(adj, B, method="auto"))
    stock = seconds(lambda: torch.sparse.mm(lib, B))
    return {"metric": f"spmm_gflops_{name}_k{k}",
            "value": round(timing.spmm_flops(csr.nnz, k) / ours / 1e9, 3),
            "unit": "GFLOP/s",
            "vs_baseline": round(stock / ours, 4)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(headline(device=args.device)))


if __name__ == "__main__":
    main()
