"""End-to-end GAT training benchmark — port of ``gespmm_tpu/bench/gat_bench.py``.

The JAX bench's flags and JSON line (mean epoch time after the warm-up
epochs, final accuracies, dims), with these differences, as in
``sage_bench``: ``--device`` picks the device; ``--dataset sbm-pubmed`` is
the synthetic pubmed-scale graph (19,719 nodes, 3 classes, 128 features);
``--method`` is ``auto``/``tiled`` (the fused attention kernels), ``xla``
(the composed chain on the plain versions) or ``pallas`` (the composed
chain: the edge ops on the segment-reduce kernel, the aggregate on the
chunk kernel), over the plan ``--method`` needs, as in ``gcn_bench``
(the JAX bench's ``--plan/--no-plan`` is not carried); ``--impl stock``
trains the single-head GAT on stock ops
(``models/baselines.py::GATStock``), the A/B baseline.  The graph gets
self-loops unless ``--no-self-loop``.

Run:  python -m gespmm_tpu_torch.bench.gat_bench --dataset sbm-pubmed
"""

from __future__ import annotations

import argparse
import json

from gespmm_tpu_torch.bench.gcn_bench import load_dataset, plan_for


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="pubmed",
                   help="graph name or .mtx path, 'sbm' or 'sbm-pubmed'")
    p.add_argument("--n-hidden", type=int, default=64)
    p.add_argument("--n-heads", type=int, default=1)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--self-loop", action="store_true", default=True)
    p.add_argument("--no-self-loop", dest="self_loop", action="store_false")
    p.add_argument("--method", default="auto",
                   choices=["auto", "xla", "pallas", "tiled"])
    p.add_argument("--impl", default="ours", choices=["ours", "stock"],
                   help="'stock' trains the same single-head model on stock "
                        "PyTorch ops (the A/B baseline)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--log-every", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    from gespmm_tpu_torch.models.gat import GAT
    from gespmm_tpu_torch.ops.graph import add_self_loops
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.train.loop import train_node_classifier

    device = torch.device(args.device)
    ds = load_dataset(args.dataset).to(device)
    csr = add_self_loops(ds.csr) if args.self_loop else ds.csr
    adj = Adjacency.from_csr(csr, plan=plan_for(args.method))
    dims = ([ds.features.shape[1]] + [args.n_hidden] * (args.n_layers - 1)
            + [ds.num_classes])
    gen = torch.Generator(device=device).manual_seed(0)
    if args.impl == "stock":
        from gespmm_tpu_torch.models.baselines import GATStock

        model = GATStock(dims, generator=gen, device=device)
        operand = GATStock.from_adjacency(adj)
    else:
        model = GAT(dims, method=args.method, heads=args.n_heads,
                    generator=gen, device=device)
        operand = adj
    res = train_node_classifier(
        model, operand, ds.features, ds.labels, ds.masks,
        epochs=args.n_epochs, lr=args.lr, weight_decay=args.weight_decay,
        log_every=args.log_every,
    )
    print(json.dumps({
        "dataset": ds.name,
        "model": "gat",
        "n": csr.shape[0],
        "nnz": csr.nnz,
        "dims": dims,
        "heads": args.n_heads,
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
