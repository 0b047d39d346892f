#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gespmm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--record PATH]

Phases, each printed as it goes; any failure exits non-zero:
  1. device: torch.cuda, and the card's name and power limit from nvidia-smi;
  2. build: nvcc builds csrc/spmm_csr.cu from this checkout (timed);
  3. kernel vs plain: the CSR SpMM kernel against its plain PyTorch version
     in float64, |out - ref| <= 1e-5 (|A| @ |B|) + 1e-6 (bf16: 8e-3 (|A| @ |B|)),
     at the GCN slice's shapes (pubmed-scale SBM graph, K=32 and K=3, over
     the CSR and the CSC) and on rmat15 (hub rows, empty rows) at
     K in {1, 3, 32, 33, 128, 130, 512}, valued and binary, f32 and bf16;
  4. autograd on the card: grad_B and grad_values against float64;
  5. GCN train: dims [128, 32, 3] on the pubmed-scale SBM graph, 50 epochs
     through the kernel (launch count >= 4 per epoch), loss falling, train
     accuracy above chance, logits agreeing with a float64 CPU forward;
     then the same run with method="xla" (the plain version, no launches);
  6. timings: kernel and plain device time and GFLOP/s (2 nnz K / t) at the
     slice's shapes and at rmat15 K=128, their call times, and GCN ms/epoch
     for both methods (two runs each, in the order auto, xla, xla, auto).

Output: one line per phase, then a {"kernels": [...]} JSON line, the
nvidia-smi line, and as the last line {"ok": true, "device": {...}}.  With
--record, the full record of the run is also written to PATH as JSON.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
EPOCHS = 50
DIMS = [128, 32, 3]
SBM_PUBMED = dict(n_per_class=6573, num_classes=3, p_in=0.0006, p_out=0.00002,
                  feat_dim=128, seed=SEED)
RMAT_KS = (1, 3, 32, 33, 128, 130, 512)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def bound_check(torch, ref, out, indptr, indices, rows, data, B):
    """Max abs error against float64, and whether it is within the bound."""
    m = indptr.shape[0] - 1
    d64 = None if data is None else data.double()
    exact = ref.spmm_rows(rows, indices, d64, B.double(), m)
    mag = ref.spmm_rows(rows, indices, None if d64 is None else d64.abs(),
                        B.double().abs(), m)
    bound = 8e-3 * mag if B.dtype == torch.bfloat16 else 1e-5 * mag + 1e-6
    err = (out.double() - exact).abs()
    ok = bool(torch.isfinite(out.double()).all()) and bool((err <= bound).all())
    return float(err.max()) if err.numel() else 0.0, ok


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--record", default="",
                      help="also write the full record of the run here (JSON)")
    args = args.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import spmm_csr as kspmm
    from gespmm_tpu_torch.models.gcn import GCN
    from gespmm_tpu_torch.ops import reference as ref
    from gespmm_tpu_torch.ops.graph import add_self_loops
    from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
    from gespmm_tpu_torch.train.loop import train_node_classifier
    from gespmm_tpu_torch.utils import timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph, sbm_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {count} x "
          f"{kind} | nvidia-smi: {card}", flush=True)
    record["card"] = card

    phase("2 build")
    t0 = time.perf_counter()
    lib = _build.build("spmm_csr")
    build_s = time.perf_counter() - t0
    print(f"nvcc {' '.join(_build.NVCC_FLAGS)} -> {os.path.relpath(lib, HERE)} "
          f"in {build_s:.2f} s", flush=True)
    record["build_s"] = build_s

    phase("3 kernel vs plain (float64 bound)")
    ds = sbm_graph(**SBM_PUBMED).to(dev)
    adj = Adjacency.from_csr(add_self_loops(ds.csr))
    rmat = Adjacency.from_csr(rmat_graph(scale=15, edge_factor=8, seed=SEED),
                              device=dev)
    for name, a in (("sbm-pubmed+loops", adj), ("rmat15", rmat)):
        deg = a.csr.indptr[1:] - a.csr.indptr[:-1]
        print(f"{name}: n={a.shape[0]} nnz={a.nnz} max_deg={int(deg.max())} "
              f"empty_rows={int((deg == 0).sum())}", flush=True)
    record["graphs"] = {"sbm_pubmed": [adj.shape[0], adj.nnz],
                        "rmat15": [rmat.shape[0], rmat.nnz]}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rmat_vals = torch.randn(rmat.nnz, device=dev, generator=gen)
    # (label, indptr, indices, rows, data, rows of B, K, dtype, on the
    # slice's path)
    n_sbm, n_rmat = adj.shape[0], rmat.shape[0]  # both square
    cases = []
    for K in (32, 3):
        cases.append((f"sbm csr K={K}", adj.csr.indptr, adj.csr.indices,
                      adj.rows, adj.data, n_sbm, K, torch.float32, True))
        cases.append((f"sbm csc K={K}", adj.csc.indptr, adj.csc.indices,
                      adj.rows_t, adj.csc.data, n_sbm, K, torch.float32, True))
        cases.append((f"sbm csr K={K} bf16", adj.csr.indptr, adj.csr.indices,
                      adj.rows, adj.data, n_sbm, K, torch.bfloat16, False))
    for K in RMAT_KS:
        for dtype in (torch.float32, torch.bfloat16):
            for data in (None, rmat_vals):
                label = (f"rmat15 K={K} {'binary' if data is None else 'valued'}"
                         f" {str(dtype).split('.')[-1]}")
                cases.append((label, rmat.csr.indptr, rmat.csr.indices,
                              rmat.rows, data, n_rmat, K, dtype, False))
    slice_err = 0.0
    compared = []
    for label, indptr, indices, rows, data, n_in, K, dtype, on_path in cases:
        B = torch.randn(n_in, K, device=dev, generator=gen).to(dtype)
        out = kspmm.spmm_csr(indptr, indices, data, B)
        torch.cuda.synchronize()
        err, ok = bound_check(torch, ref, out, indptr, indices, rows, data, B)
        print(f"{label}: max_abs_err={err:.3e} {'ok' if ok else 'OUT OF BOUND'}",
              flush=True)
        check(ok, f"kernel disagrees with the plain version: {label}")
        if on_path:
            slice_err = max(slice_err, err)
        compared.append({"case": label, "max_abs_err": err})
    record["kernel_vs_plain"] = compared

    phase("4 autograd on the card")
    d = adj.data.clone().requires_grad_(True)
    B = torch.randn(adj.shape[1], 32, device=dev, generator=gen,
                    requires_grad=True)
    g = torch.randn(adj.shape[0], 32, device=dev, generator=gen)
    spmm(adj.with_data(d), B).backward(g)
    d64 = adj.data.double().requires_grad_(True)
    B64 = B.detach().double().requires_grad_(True)
    spmm(adj.with_data(d64), B64, method="xla").backward(g.double())
    for name, got, want in (("grad_B", B.grad, B64.grad),
                            ("grad_values", d.grad, d64.grad)):
        err = float((got.double() - want).abs().max())
        scale = float(want.abs().max())
        print(f"{name}: max_abs_err={err:.3e} (max |ref| {scale:.3e})", flush=True)
        check(torch.isfinite(got).all() and err <= 1e-5 * max(scale, 1.0),
              f"{name} disagrees with float64")

    phase(f"5 GCN train, dims {DIMS}, {EPOCHS} epochs")

    def train(method):
        model = GCN(DIMS, dropout_rate=0.5, method=method,
                    generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev).with_norms(adj)
        kspmm.reset_launches()
        res = train_node_classifier(model, adj, ds.features, ds.labels,
                                    ds.masks, seed=SEED, epochs=EPOCHS)
        torch.cuda.synchronize()
        return model, res, kspmm.launches

    runs = {}
    for method in ("auto", "xla"):
        model, res, launches = train(method)
        loss = res["history"]["loss"]
        print(f"method={method}: loss {loss[0]:.4f} -> {loss[-1]:.4f} | "
              f"train/val/test acc {res['train_acc']:.4f}/{res['val_acc']:.4f}/"
              f"{res['test_acc']:.4f} | {res['mean_epoch_time'] * 1e3:.4f} "
              f"ms/epoch | kernel launches {launches}", flush=True)
        finite = all(map(lambda v: v == v and abs(v) != float("inf"), loss))
        check(finite and loss[-1] < loss[0], f"{method}: loss did not fall")
        check(res["train_acc"] > 1 / 3, f"{method}: train accuracy at chance")
        check(all(torch.isfinite(p).all() for p in model.parameters()),
              f"{method}: non-finite parameters")
        if method == "auto":
            check(launches >= 4 * EPOCHS,
                  f"only {launches} kernel launches in {EPOCHS} epochs")
            main_launches = launches
            model.eval()
            with torch.no_grad():
                logits = model(adj, ds.features)
                cpu = GCN(DIMS, method="xla").double()
                cpu.load_state_dict({k: v.cpu().double()
                                     for k, v in model.state_dict().items()})
                cpu.eval()
                want = cpu(Adjacency.from_csr(adj.csr.to("cpu").with_data(
                    adj.data.cpu().double())), ds.features.cpu().double())
            check(logits.shape == (adj.shape[0], DIMS[-1]), "logits shape")
            err = float((logits.cpu().double() - want).abs().max())
            scale = float(want.abs().max())
            print(f"logits vs float64 CPU forward: max_abs_err={err:.3e} "
                  f"(max |ref| {scale:.3e})", flush=True)
            check(err <= 1e-4 * max(scale, 1.0), "logits disagree with float64")
        else:
            check(launches == 0, "method='xla' launched the kernel")
        runs[method] = {"loss_first": loss[0], "loss_last": loss[-1],
                        "train_acc": res["train_acc"], "val_acc": res["val_acc"],
                        "test_acc": res["test_acc"],
                        "ms_per_epoch_runs": [res["mean_epoch_time"] * 1e3],
                        "launches": launches}
    record["gcn"] = runs

    phase("6 timings, in the order plain / kernel / kernel / plain")
    # Device time: CUDA events around calls queued behind a spin kernel,
    # so they run back to back on the card.  Call time: CUDA events around
    # groups of calls, which at these sizes is the host's enqueue rate
    # (the wrapper's checks and the launch).
    shapes = []
    for K in (32, 3):
        shapes.append((f"sbm csr K={K}", adj.csr.indptr, adj.csr.indices,
                       adj.rows, adj.data, adj.shape[1], K))
        shapes.append((f"sbm csc K={K}", adj.csc.indptr, adj.csc.indices,
                       adj.rows_t, adj.csc.data, adj.shape[0], K))
    shapes.append(("rmat15 csr K=128 binary", rmat.csr.indptr, rmat.csr.indices,
                   rmat.rows, None, rmat.shape[1], 128))

    def alternate(measure, kernel, plain):
        p1, k1, k2, p2 = measure(plain), measure(kernel), measure(kernel), \
            measure(plain)
        return [k1 * 1e3, k2 * 1e3], [p1 * 1e3, p2 * 1e3]

    def mean(xs):
        return sum(xs) / len(xs)

    timings = []
    for label, indptr, indices, rows, data, n_in, K in shapes:
        B = torch.randn(n_in, K, device=dev, generator=gen)
        m = indptr.shape[0] - 1

        def kernel():
            return kspmm.spmm_csr(indptr, indices, data, B)

        def plain():
            return ref.spmm_rows(rows, indices, data, B, m)

        k_dev, p_dev = alternate(timing.device_time, kernel, plain)
        k_call, p_call = alternate(lambda f: timing.benchmark(f).mean_s,
                                   kernel, plain)
        gf = timing.spmm_flops(int(indices.shape[0]), K) / 1e6  # per ms
        row = {"shape": label, "nnz": int(indices.shape[0]), "K": K,
               "kernel_device_ms": k_dev, "plain_device_ms": p_dev,
               "kernel_call_ms": k_call, "plain_call_ms": p_call,
               "kernel_gflops": gf / mean(k_dev), "plain_gflops": gf / mean(p_dev)}
        timings.append(row)
        print(f"{label}: device time kernel {mean(k_dev):.5f} ms "
              f"({row['kernel_gflops']:.3f} GFLOP/s) | plain {mean(p_dev):.5f} ms "
              f"({row['plain_gflops']:.3f} GFLOP/s) | call time kernel "
              f"{mean(k_call):.5f} ms, plain {mean(p_call):.5f} ms | {card}",
              flush=True)
    record["timings"] = timings
    for method in ("xla", "auto"):
        runs[method]["ms_per_epoch_runs"].append(
            train(method)[1]["mean_epoch_time"] * 1e3)
    for method, r in runs.items():
        ms = r["ms_per_epoch_runs"]
        r["ms_per_epoch"] = mean(ms)
        print(f"GCN {method}: {mean(ms):.4f} ms/epoch (runs "
              f"{', '.join(f'{x:.4f}' for x in ms)}) | {card}", flush=True)

    main_shape = timings[0]
    kernels = {"kernels": [{
        "name": "spmm_csr", "route": "cuda", "source": kspmm.SOURCE,
        "replaces": kspmm.REPLACES, "launches": main_launches,
        "max_abs_err": slice_err, "ms": mean(main_shape["kernel_device_ms"]),
        "plain_ms": mean(main_shape["plain_device_ms"]),
    }]}
    record.update(kernels)
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
