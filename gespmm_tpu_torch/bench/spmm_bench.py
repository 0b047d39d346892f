"""SpMM / SDDMM tier sweep — port of ``gespmm_tpu/bench/spmm_bench.py``.

For each graph and width K, time each SpMM tier and emit one row

    data,m,n,nnz,K=<k>-<method>-gflops,...

(the JAX package's CSV schema, with a ``device`` column naming the card).
GFLOP/s = 2·nnz·K / time.  Tiers: ``xla`` (plain), ``tiled`` (the CSR
kernel), ``pallas`` (the nnz-chunked kernel over a per-row plan), ``scatter``
(one ``index_add_``), ``dense`` (densify and matmul, size-guarded), and
``bcoo``, the sparse-library yardstick: ``torch.sparse.mm`` on a
``torch.sparse_csr_tensor`` (cuSPARSE on the card), under the JAX column
name; the port never calls it.  ``tiled-hilo`` / ``tiled-fast`` are the CSR
kernel with ``mode="hilo"`` (the f32 kernel) and ``mode="fast"`` (B rounded
to bf16 once, gathered as bf16, f32 out).

On the card each cell's time is its device time (``utils/timing.py::
device_time``; a tier whose call synchronises the host is an error cell).
On the CPU (``--device cpu``) the host clock's; the cell's ``timer`` says
which.  With ``--validate`` every cell is first held to a float64 scipy
golden, max |out − golden| / (1 + |golden|) <= tol, else it is recorded as
``VALIDATION FAILED``; the golden of ``tiled-fast`` is that of B rounded
to bf16, as in the JAX sweep (its contract is the exact sum of the rounded
contributions).  A width that runs out of device memory is halved
(the reference's max_ncols ladder) and recorded with its width.

Run on the card:

    python -m gespmm_tpu_torch.bench.spmm_bench --graphs rmat15 --k 32 128 \\
        --methods xla tiled pallas scatter dense bcoo --validate
    python -m gespmm_tpu_torch.bench.spmm_bench --graphs rmat15 --k 64 \\
        --sddmm --validate
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from gespmm_tpu_torch.ops.interop import csr_to_torch_sparse

METHODS = ("xla", "tiled", "pallas", "scatter", "dense", "bcoo", "tiled-hilo",
           "tiled-fast")
SDDMM_METHODS = ("xla", "tiled", "auto")


def _append_csv(csv_file: str, row: dict) -> None:
    """Merge ``row`` into the CSV: one row per graph (a re-run replaces that
    graph's row) and the columns the union across runs.  A file that is not
    this sweep's — no ``data`` column, unreadable as CSV, or a row without a
    ``data`` value or with more fields than the header — does not lose the
    run: its unusable rows are dropped (a foreign file is rewritten)."""
    rows, cols = {}, []
    if os.path.exists(csv_file):
        try:
            with open(csv_file, newline="") as f:
                rdr = csv.DictReader(f)
                cols = list(rdr.fieldnames or [])
                if "data" in cols:
                    for r in rdr:
                        if r.get("data") and None not in r:
                            rows[r["data"]] = r
                else:
                    cols = []
        except (csv.Error, UnicodeDecodeError):
            rows, cols = {}, []
    for c in row:
        if c not in cols:
            cols.append(c)
    key = str(row["data"])
    merged = rows.get(key, {})
    merged.update({k: str(v) for k, v in row.items()})
    rows[key] = merged
    with open(csv_file, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols, restval="nan")
        w.writeheader()
        for r in rows.values():
            w.writerow(r)


def load_graph(name: str, seed: int = 0):
    """A ``.mtx`` graph found by ``find_graph`` (binary), else the synthetic
    corpus name (``utils/datasets.py::synth_graph``)."""
    from gespmm_tpu_torch.utils.datasets import (find_graph, load_mtx_graph,
                                                 synth_graph)

    if find_graph(name):
        return load_mtx_graph(name, binary=True)
    csr = synth_graph(name, seed=seed)
    if csr is None:
        raise FileNotFoundError(name)
    return csr


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "False (use --device cpu for a host run)")
    return device


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _seconds(fn, device: torch.device, iters: int):
    """(seconds per call, timer).  On the card "device":
    ``utils/timing.py::device_time``, whose ``HostBehind`` fails the cell of
    a call that synchronises the host.  On the CPU "host", the median of
    the host clock."""
    from gespmm_tpu_torch.utils import timing

    if device.type != "cuda":
        return timing.benchmark(fn, iters=iters).median_s, "host"
    return timing.device_time(fn, iters=max(10, min(iters // 4, 50))), "device"


def _rel_err(got: torch.Tensor, golden: np.ndarray) -> float:
    got = got.detach().cpu().double().numpy()
    return float((np.abs(got - golden) / (1.0 + np.abs(golden))).max())


def bench_graph(name: str, ks: List[int], iters: int = 200,
                methods=("xla", "pallas"), rows_per_block: int = 64,
                chunk_nnz: int = 64, csv_file: Optional[str] = None,
                seed: int = 0, validate: bool = False, tol: float = 2e-3,
                device="cuda"):
    """Time each SpMM tier of ``methods`` at each width of ``ks`` on graph
    ``name``; returns (row, {(K, method): cell}).  A cell is {"ms",
    "gflops", "nnz_per_s"[, "k_fallback"]} or {"error": text}."""
    import scipy.sparse as sp

    from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
    from gespmm_tpu_torch.utils import timing

    device = _device(device)
    unknown = [mt for mt in methods if mt not in METHODS]
    if unknown:
        raise ValueError(f"unknown methods {unknown}; expected {METHODS}")
    csr = load_graph(name, seed)
    m, n = csr.shape
    base_adj = Adjacency.from_csr(csr, device=device)
    adjs = {}
    for method in methods:
        if method == "pallas":
            # Forward-only sweep: no plan of the transpose.
            adjs[method] = Adjacency.from_csr(
                csr, device=device, plan="perrow", plan_transpose=False,
                rows_per_block=rows_per_block, chunk_nnz=chunk_nnz)
        else:
            adjs[method] = base_adj
    lib = (csr_to_torch_sparse(csr.to(device)) if "bcoo" in methods
           else None)
    golden_A = sp.csr_matrix(
        (np.ones(csr.nnz) if csr.data is None else csr.data.double().numpy(),
         csr.indices.numpy(), csr.indptr.numpy()), shape=csr.shape)
    rng = np.random.default_rng(seed)
    results = {}

    def progress(msg: str) -> None:
        print(f"[bench {name}] {msg}", file=sys.stderr, flush=True)

    def make_golden(B: torch.Tensor, method: str):
        if not validate:
            return None
        if method == "tiled-fast":  # the golden of the bf16-rounded B
            B = B.to(torch.bfloat16)
        return golden_A @ B.cpu().double().numpy()

    def alloc_B(K: int):
        # OOM-halving allocation (the reference's max_ncols ladder).
        while True:
            try:
                return torch.from_numpy(
                    rng.standard_normal((n, K)).astype(np.float32)).to(device), K
            except torch.cuda.OutOfMemoryError:
                if K == 1:
                    raise
                torch.cuda.empty_cache()
                K //= 2

    for K_req in ks:
        progress(f"K={K_req}: allocating B")
        B0, K0 = alloc_B(K_req)
        for method in methods:
            K, B = K0, B0
            golden = make_golden(B, method)
            adj = adjs[method]
            tier, _, mode = method.partition("-")
            while True:
                progress(f"K={K_req} method={method} (width {K})")
                if method == "bcoo":
                    fn = (lambda _B=B: torch.sparse.mm(lib, _B))
                else:
                    fn = (lambda _B=B, _a=adj, _t=tier, _md=mode or "trilo":
                          spmm(_a, _B, method=_t, mode=_md))
                try:
                    if golden is not None:
                        err = _rel_err(fn(), golden)
                        if err > tol:
                            results[(K_req, method)] = {
                                "error": f"VALIDATION FAILED: err={err:.2e}"}
                            break
                    t, timer = _seconds(fn, device, iters)
                except torch.cuda.OutOfMemoryError:
                    torch.cuda.empty_cache()
                    if K == 1:
                        results[(K_req, method)] = {"error": "out of memory at "
                                                    "width 1"}
                        break
                    progress(f"K={K_req} method={method}: out of memory at "
                             f"width {K}, halving")
                    B, K = alloc_B(K // 2)
                    golden = make_golden(B, method)
                    continue
                except Exception as e:  # a cell's failure is its record
                    results[(K_req, method)] = {"error": str(e)[:200]}
                    break
                results[(K_req, method)] = {
                    "ms": t * 1e3,
                    "gflops": timing.spmm_flops(csr.nnz, K) / t / 1e9,
                    "nnz_per_s": csr.nnz / t, "timer": timer,
                    **({"k_fallback": K} if K != K_req else {}),
                }
                break
    row = {"data": name, "m": m, "n": n, "nnz": csr.nnz,
           "device": _device_name(device)}
    for (K, method), v in results.items():
        row[f"K={K}-{method}-gflops"] = round(v.get("gflops", float("nan")), 2)
        if "k_fallback" in v:
            row[f"K={K}-{method}-width"] = v["k_fallback"]
    if csv_file:
        _append_csv(csv_file, row)
    return row, results


def bench_sddmm_graph(name: str, ks: List[int], iters: int = 200,
                      methods=("xla", "tiled"), csv_file: Optional[str] = None,
                      seed: int = 0, validate: bool = False, tol: float = 2e-3,
                      device="cuda"):
    """SDDMM tier sweep: out[e] = D1[row_e]·D2[col_e] over the graph's
    pattern, timed per (K, tier) with a float64 golden check."""
    from gespmm_tpu_torch.ops.sddmm import sddmm
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.utils import timing

    device = _device(device)
    csr = load_graph(name, seed)
    m, n = csr.shape
    adj = Adjacency.from_csr(csr, device=device)
    rng = np.random.default_rng(seed)
    rows_h = csr.row_ids().numpy()
    cols_h = csr.indices.numpy()
    results = {}
    for K in ks:
        D1h = rng.standard_normal((m, K)).astype(np.float32)
        D2h = rng.standard_normal((n, K)).astype(np.float32)
        D1 = torch.from_numpy(D1h).to(device)
        D2 = torch.from_numpy(D2h).to(device)
        golden = (np.einsum("ek,ek->e", D1h.astype(np.float64)[rows_h],
                            D2h.astype(np.float64)[cols_h]) if validate
                  else None)
        for method in methods:
            def fn(_m=method):
                return sddmm(adj, D1, D2, method=_m)

            try:
                if golden is not None:
                    err = _rel_err(fn(), golden)
                    if err > tol:
                        results[(K, method)] = {
                            "error": f"VALIDATION FAILED: err={err:.2e}"}
                        continue
                t, timer = _seconds(fn, device, iters)
            except Exception as e:  # a cell's failure is its record
                results[(K, method)] = {"error": str(e)[:200]}
                continue
            results[(K, method)] = {
                "ms": t * 1e3,
                "gflops": timing.sddmm_flops(csr.nnz, K) / t / 1e9,
                "timer": timer}
    row = {"data": name, "m": m, "n": n, "nnz": csr.nnz,
           "device": _device_name(device)}
    for (K, method), v in results.items():
        row[f"K={K}-sddmm-{method}-gflops"] = round(
            v.get("gflops", float("nan")), 2)
    if csv_file:
        _append_csv(csv_file, row)
    return row, results


def _bench_one(g: str, args) -> None:
    if args.sddmm:
        row, results = bench_sddmm_graph(
            g, args.k, iters=args.iters,
            methods=tuple(mt for mt in args.methods if mt in SDDMM_METHODS)
            or ("xla", "tiled"),
            csv_file=args.csv, validate=args.validate, tol=args.tol,
            device=args.device)
    else:
        roofline = args.roofline and torch.device(args.device).type == "cuda"
        if args.roofline and not roofline:
            print("--roofline compares device times with the H100's bound; "
                  "a host run has none, so no roofline column", file=sys.stderr)
        row, results = bench_graph(
            g, args.k, iters=args.iters, methods=tuple(args.methods),
            rows_per_block=args.rows_per_block, chunk_nnz=args.chunk_nnz,
            csv_file=None if roofline else args.csv,
            validate=args.validate, tol=args.tol, device=args.device)
        if roofline:
            from gespmm_tpu_torch.utils.profiling import spmm_roofline

            for K in args.k:
                best = min((v["ms"] for (kk, _), v in results.items()
                            if kk == K and "ms" in v and "k_fallback" not in v),
                           default=None)
                if best is None:
                    continue
                rf = spmm_roofline(row["nnz"], row["m"], K, best * 1e-3,
                                   n=row["n"])["fraction_of_roofline"]
                row[f"K={K}-roofline-frac"] = round(rf, 3)
            if args.csv:
                _append_csv(args.csv, row)
    print(json.dumps(row), flush=True)
    errs = {f"K={k}-{mt}": v["error"] for (k, mt), v in results.items()
            if "error" in v}
    if errs:
        print(json.dumps({"data": g, "errors": errs}), file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--graphs", nargs="+", default=["pubmed"])
    p.add_argument("--k", nargs="+", type=int, default=[32, 64, 128, 256])
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--methods", nargs="+", default=["xla", "tiled", "bcoo"],
                   help="tiers: " + " | ".join(METHODS))
    p.add_argument("--csv", default="spmm_bench_out.csv")
    p.add_argument("--rows-per-block", type=int, default=64)
    p.add_argument("--chunk-nnz", type=int, default=64)
    p.add_argument("--validate", action="store_true",
                   help="golden-check each cell against float64 scipy first")
    p.add_argument("--tol", type=float, default=2e-3,
                   help="max |out-golden64|/(1+|golden64|)")
    p.add_argument("--sddmm", action="store_true",
                   help="sweep the SDDMM tiers instead of SpMM")
    p.add_argument("--roofline", action="store_true",
                   help="append K=<k>-roofline-frac columns (best tier against "
                        "the H100's bound, utils/profiling.py::spmm_roofline)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.roofline and torch.device(args.device).type == "cuda":
        from gespmm_tpu_torch.utils.profiling import (H100_HBM_GBPS,
                                                      measure_hbm_bandwidth)

        print(f"copy bandwidth measured on {_device_name(_device(args.device))}:"
              f" {measure_hbm_bandwidth():.1f} GB/s (published H100 SXM: "
              f"{H100_HBM_GBPS:.0f} GB/s)", file=sys.stderr, flush=True)
    for g in args.graphs:
        try:
            _bench_one(g, args)
        except Exception as e:  # one graph's failure must not end the sweep
            import traceback

            traceback.print_exc(file=sys.stderr)
            print(json.dumps({"data": g, "errors": {"fatal": str(e)[:300]}}),
                  file=sys.stderr)


if __name__ == "__main__":
    main()
