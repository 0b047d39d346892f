#!/usr/bin/env python3
"""Time an earlier build of kernel row 4 (the edge segment reduce) against
this checkout's, on one CUDA card, and A/B this checkout's walker width.

    python3 scripts/row4_ab.py OLD_DIR [--variants] [--json PATH]

OLD_DIR holds an earlier checkout (``git archive 24d878a | tar -x -C
OLD_DIR``) whose ``csrc/edge_reduce.cu`` walks one row a warp, unsplit,
through ``gespmm_edge_reduce_f32(m, K, is_max, indptr, vals, out,
stream)``.  This checkout's kernel takes the adjacency's split
(``Adjacency.split``) and a walker of ``walk_width`` lanes a row.  Shapes
(f32 values): the SBM graph with self-loops (pubmed scale) at K = 1 (the
composed chain's sum and max) and K = 8 (8 heads), and rmat15 (edge factor
8: hub rows of up to 3,866 edges, 11,708 empty rows) at K = 1 and 8.  Each
pair is timed in the order old, new, new, old (device time, 50 calls a
group behind a spin kernel), the outputs compared (a max bit for bit, a sum
within the float64 bound: a split row is summed in another order); beside
it the plain version, the bound (``profiling.edge_reduce_work`` over 3.35
TB/s), the carries a call and ``torch.segment_reduce`` with the same op
(the library call, held to the kernel on the rows with an edge).

With ``--variants``: the walker widths 4, 8, 16 and 32 (``walk_width``
replaced) and the kernel given no split (one launch, every hub row walked
by one walker) through the wrapper at every shape, in the order listed,
then reversed.

Prints one line a row and the card's name and power limit; ``--json`` also
writes the rows there.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (4, 8, 16, 32)


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("--json", default="", help="also write the rows here")
    ap.add_argument("--variants", action="store_true",
                    help="also time every walker width")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import edge_reduce as kedge
    from gespmm_tpu_torch.ops import reference as ref
    from gespmm_tpu_torch.ops.graph import add_self_loops
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.sparse.partition import build_row_split
    from gespmm_tpu_torch.utils import profiling, timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph, sbm_graph

    if not torch.cuda.is_available():
        print("row4_ab: needs a CUDA card", file=sys.stderr)
        return 2
    old_lib = os.path.join(tempfile.mkdtemp(), "libedge_old.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", old_lib,
                    os.path.join(args.old_dir, "gespmm_tpu_torch", "csrc",
                                 "edge_reduce.cu")], check=True)
    _build.build("edge_reduce")
    old = ctypes.CDLL(old_lib).gespmm_edge_reduce_f32
    old.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    old.restype = ctypes.c_int
    card = card_name()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sbm = sbm_graph(n_per_class=6573, num_classes=3, p_in=0.0006,
                    p_out=0.00002, feat_dim=128, seed=0)
    graphs = {"sbm": Adjacency.from_csr(add_self_loops(sbm.csr), device=dev),
              "rmat15": Adjacency.from_csr(rmat_graph(15, 8, seed=0),
                                           device=dev)}
    rows = []

    def with_width(call, lanes):
        def run():
            saved = kedge.walk_width
            kedge.walk_width = lambda nnz, m, K: lanes
            try:
                return call()
            finally:
                kedge.walk_width = saved
        return run

    for graph, K, op in (("sbm", 1, "sum"), ("sbm", 1, "max"),
                         ("sbm", 8, "sum"), ("rmat15", 1, "sum"),
                         ("rmat15", 1, "max"), ("rmat15", 8, "sum")):
        a = graphs[graph]
        m = a.shape[0]
        vals = torch.randn(a.nnz, K, device=dev, generator=gen)

        def first():
            out = torch.empty(m, K, device=dev)
            assert old(m, K, int(op == "max"), a.csr.indptr.data_ptr(),
                       vals.data_ptr(), out.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream) == 0
            return out

        def second():
            return kedge.edge_segment_reduce(a.csr.indptr, vals, op,
                                             split=a.split)

        def plain():
            return ref.edge_segment_rows(a.rows, vals, m, op)

        before = kedge.carry_launches
        x, y = first(), second()
        carries = kedge.carry_launches - before
        if op == "max":
            ok = torch.equal(x, y)
        else:
            want = ref.edge_segment_rows(a.rows, vals.double(), m, "sum")
            mag = ref.edge_segment_rows(a.rows, vals.double().abs(), m, "sum")
            ok = bool(((y.double() - want).abs() <= 1e-5 * mag + 1e-6).all())
        t = [timing.device_time(fn) * 1e6
             for fn in (first, second, second, first)]
        plain_us = timing.device_time(plain) * 1e6
        nbytes, ops = profiling.edge_reduce_work(m, a.nnz, K)
        bound_us = profiling.bound(nbytes, ops)[0] * 1e6
        lengths = (a.csr.indptr[1:] - a.csr.indptr[:-1]).long()
        live = lengths.nonzero()[:, 0]

        def lib():
            return torch.segment_reduce(vals, op, lengths=lengths, axis=0,
                                        unsafe=True)

        # Held to the kernel on the rows with an edge: an empty row's max is
        # -inf in torch.segment_reduce, 0 in the kernel.
        lib_us = None
        if float((lib()[live] - y[live]).abs().max()) <= 1e-4 * max(
                float(y.abs().max()), 1.0):
            lib_us = timing.device_time(lib) * 1e6
        shape = f"{graph} K={K} {op}"
        row = {"kernel": "edge_segment_reduce", "shape": shape,
               "old_us": [t[0], t[3]], "new_us": [t[1], t[2]], "ok": ok,
               "plain_us": plain_us, "bound_us": bound_us,
               "segment_reduce_us": lib_us, "carries": carries,
               "walk_width": kedge.walk_width(a.nnz, m, K), "card": card}
        rows.append(row)
        print(f"edge_segment_reduce {shape}: old {t[0]:.2f}, {t[3]:.2f} us | "
              f"new {t[1]:.2f}, {t[2]:.2f} us | {(t[0] + t[3]) / (t[1] + t[2]):.2f}x"
              f" | {'agrees' if ok else 'DISAGREES'} | plain {plain_us:.2f} | "
              f"bound {bound_us:.2f} | torch.segment_reduce "
              f"{'none' if lib_us is None else f'{lib_us:.2f}'} | carries "
              f"{carries} | lanes {row['walk_width']} | {card}", flush=True)
        if args.variants:
            whole = build_row_split(a.csr.indptr, 1 << 30).to(dev)
            runs = {f"{w} lanes": with_width(second, w) for w in WIDTHS}
            runs["no split"] = lambda: kedge.edge_segment_reduce(
                a.csr.indptr, vals, op, split=whole)
            names = list(runs)
            tv = {nm: [] for nm in names}
            for nm in names + names[::-1]:
                tv[nm].append(timing.device_time(runs[nm]) * 1e6)
            rows.append({"kernel": "edge_segment_reduce",
                         "shape": f"{shape} variants", "us": tv, "card": card})
            print(f"edge_segment_reduce {shape} variants: " + " | ".join(
                f"{nm} {v[0]:.2f}, {v[1]:.2f} us" for nm, v in tv.items())
                + f" | {card}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
