"""End-to-end GraphSAGE training benchmark — port of ``gespmm_tpu/bench/sage_bench.py``.

Same flags and the same JSON line: mean epoch time after the warm-up
epochs, ETputs (thousands of traversed edges per second per epoch, the
reference's ``sage_dgl.py`` metric), final accuracies and dims.  The graph
is used as it comes, without self-loops, as in the JAX bench.  ``--impl
stock`` trains mean/sum/pool on stock PyTorch ops
(``models/baselines.py::SAGEStock``), the A/B baseline; any other
aggregator exits.  ``--aggregator-type lstm`` samples at most
``--max-neighbors`` neighbours a node.  ``--method pallas`` takes the
chunk kernel (the per-row chunk plan is built; mean, sum and gcn only).
``--dataset sbm-pubmed`` is the synthetic pubmed-scale graph (19,719
nodes, 3 classes, 128 features) the port is measured on while no
pubmed.mtx is available.

Run:  python -m gespmm_tpu_torch.bench.sage_bench --dataset sbm-pubmed \\
          --aggregator-type pool
"""

from __future__ import annotations

import argparse
import json

from gespmm_tpu_torch.bench.gcn_bench import load_dataset, plan_for


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="pubmed",
                   help="graph name or .mtx path, 'sbm' or 'sbm-pubmed'")
    p.add_argument("--n-hidden", type=int, default=16)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--aggregator-type", default="mean",
                   choices=["mean", "gcn", "pool", "sum", "lstm"])
    p.add_argument("--max-neighbors", type=int, default=32,
                   help="lstm aggregator: neighbour sample cap per node")
    p.add_argument("--method", default="auto",
                   choices=["auto", "xla", "pallas"])
    p.add_argument("--impl", default="ours", choices=["ours", "stock"],
                   help="'stock' trains the same model on stock PyTorch ops "
                        "(torch.sparse.mm / scatter_reduce), the A/B "
                        "baseline")
    p.add_argument("--device", default="cuda")
    p.add_argument("--log-every", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    from gespmm_tpu_torch.models.sage import GraphSAGE
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.train.loop import train_node_classifier

    if args.impl == "stock" and args.aggregator_type not in ("mean", "sum",
                                                              "pool"):
        raise SystemExit("--impl stock supports mean/sum/pool aggregators")
    device = torch.device(args.device)
    ds = load_dataset(args.dataset).to(device)
    adj = Adjacency.from_csr(ds.csr, plan=plan_for(args.method))
    dims = ([ds.features.shape[1]] + [args.n_hidden] * (args.n_layers - 1)
            + [ds.num_classes])
    gen = torch.Generator(device=device).manual_seed(0)
    if args.impl == "stock":
        from gespmm_tpu_torch.models.baselines import SAGEStock

        model = SAGEStock(dims, aggregator=args.aggregator_type,
                          dropout_rate=args.dropout, generator=gen,
                          device=device)
        operand = SAGEStock.from_adjacency(adj, args.aggregator_type)
    else:
        table = None
        if args.aggregator_type == "lstm":
            from gespmm_tpu_torch.models.sage_lstm import build_neighbor_table

            table = build_neighbor_table(ds.csr,
                                         max_neighbors=args.max_neighbors)
        model = GraphSAGE(dims, aggregator=args.aggregator_type,
                          dropout_rate=args.dropout, method=args.method,
                          neighbor_table=table, generator=gen, device=device)
        operand = adj
    res = train_node_classifier(
        model, operand, ds.features, ds.labels, ds.masks,
        epochs=args.n_epochs, lr=args.lr, weight_decay=args.weight_decay,
        log_every=args.log_every,
    )
    epoch_s = res["mean_epoch_time"]
    print(json.dumps({
        "dataset": ds.name,
        "aggregator": args.aggregator_type,
        "impl": args.impl,
        "method": args.method,
        "dims": dims,
        "epochs": args.n_epochs,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "mean_epoch_time_ms": round(epoch_s * 1e3, 3),
        "etputs_kteps": (round(adj.nnz / epoch_s / 1e3, 1) if epoch_s > 0
                         else float("nan")),
        "train_acc": round(res["train_acc"], 4),
        "val_acc": round(res["val_acc"], 4),
        "test_acc": round(res["test_acc"], 4),
    }))


if __name__ == "__main__":
    main()
