"""End-to-end GCN training benchmark — port of ``gespmm_tpu/bench/gcn_bench.py``.

Same flags and the same JSON line (mean epoch time after the warm-up
epochs, final accuracies), with ``--impl ours`` only: the stock sparse
library baseline waits for ROADMAP A3.  ``--dataset sbm-pubmed`` is the synthetic
pubmed-scale graph (19,719 nodes, 3 classes, 128 features) the port is
measured on while no pubmed.mtx is available.

Run:  python -m gespmm_tpu_torch.bench.gcn_bench --dataset sbm-pubmed
"""

from __future__ import annotations

import argparse
import json

# sbm_graph arguments of the pubmed-scale graph.
SBM_PUBMED = dict(n_per_class=6573, num_classes=3, p_in=0.0006, p_out=0.00002,
                  feat_dim=128, seed=0)


def load_dataset(name: str):
    from gespmm_tpu_torch.utils.datasets import planetoid_style_dataset, sbm_graph

    if name == "sbm":
        return sbm_graph(n_per_class=500, num_classes=4)
    if name == "sbm-pubmed":
        return sbm_graph(**SBM_PUBMED)
    return planetoid_style_dataset(name)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="pubmed",
                   help="graph name or .mtx path, 'sbm' or 'sbm-pubmed'")
    p.add_argument("--n-hidden", type=int, default=32)
    p.add_argument("--n-layers", type=int, default=2,
                   help="number of GCN layers (2 = one hidden)")
    p.add_argument("--n-epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--self-loop", action="store_true", default=True)
    p.add_argument("--no-self-loop", dest="self_loop", action="store_false")
    p.add_argument("--method", default="auto", choices=["auto", "xla", "tiled"])
    p.add_argument("--impl", default="ours", choices=["ours"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler chrome trace here")
    p.add_argument("--log-every", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    from gespmm_tpu_torch.models.gcn import GCN
    from gespmm_tpu_torch.ops.graph import add_self_loops
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.train.loop import train_node_classifier

    device = torch.device(args.device)
    ds = load_dataset(args.dataset).to(device)
    csr = add_self_loops(ds.csr) if args.self_loop else ds.csr
    adj = Adjacency.from_csr(csr)
    dims = ([ds.features.shape[1]] + [args.n_hidden] * (args.n_layers - 1)
            + [ds.num_classes])
    gen = torch.Generator(device=device).manual_seed(0)
    model = GCN(dims, dropout_rate=args.dropout, method=args.method,
                generator=gen, device=device).with_norms(adj)

    def run():
        return train_node_classifier(
            model, adj, ds.features, ds.labels, ds.masks,
            epochs=args.n_epochs, lr=args.lr, weight_decay=args.weight_decay,
            log_every=args.log_every,
        )

    if args.profile_dir:
        import os

        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            res = run()
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    else:
        res = run()

    print(json.dumps({
        "dataset": ds.name,
        "n": int(ds.features.shape[0]),
        "nnz": csr.nnz,
        "dims": dims,
        "impl": args.impl,
        "method": args.method,
        "epochs": args.n_epochs,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "mean_epoch_time_ms": round(res["mean_epoch_time"] * 1e3, 3),
        "train_acc": round(res["train_acc"], 4),
        "val_acc": round(res["val_acc"], 4),
        "test_acc": round(res["test_acc"], 4),
    }))


if __name__ == "__main__":
    main()
