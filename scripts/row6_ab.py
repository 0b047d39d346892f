#!/usr/bin/env python3
"""Time an earlier build of kernel row 6 (the fused dot-product attention
kernels) against this checkout's on one CUDA card, and time this checkout's
multi-head kernels at the UniMP cell's calls.

    python3 scripts/row6_ab.py OLD_DIR [--pairs N] [--products-seed N]
        [--json PATH]

OLD_DIR holds an earlier checkout, for example the tree before the
multi-head kernels, unpacked with ``git archive 53a76ab | tar -x -C
OLD_DIR``.  Its ``csrc/dot_attention.cu`` has the single-head entry points
``gespmm_dot_{fwd,bwd_rows,bwd_cols}_f32`` with this checkout's arguments;
both builds are called through this checkout's wrappers
(``kernels/gat_fused.py``) at one head with no scale and no mask, the old
library in place of ``_dot_entry``.

Part 1, the single-head kernels at ``chip_smoke.py``'s shapes: the SBM
graph with self-loops (pubmed scale) at (Ka, K) = (64, 64) and (16, 3), and
rmat15 (edge factor 8: hub rows and columns of 3,866 edges, 11,708 empty
rows) at (64, 64); f32, identity act, the adjacency's splits.  Each
kernel's outputs are compared bit for bit, and it is timed in the order
old, new, new, old (device time, 50 calls a group behind a spin kernel),
``--pairs`` times.

Part 2, this checkout's multi-head kernels at the UniMP cell's calls on
the products graph (``gnnbench/graphgen.py``'s ``powerlaw`` traffic from
``--products-seed``, no self-loops: 2,449,029 nodes, 123,718,280
nonzeros): two heads of 32 (K = Ka = 64) and of 47 (K = Ka = 94), scale
dh^-1/2, without and with the attention mask (keep 0.7).  Each call's
device time (5 calls a group), its edge walks (``dot_edge_walks``), its
bound (``gnnbench/dot_roofline.py`` over 3.35 TB/s) and its share of it.

Prints one line a row, the registers of this checkout's f32 dot kernels
(``cuobjdump -res-usage``) and the card's name and power limit; ``--json``
also writes the rows there.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("fwd", "bwd_rows", "bwd_cols")


def old_entries(lib_path):
    """A stand-in for ``kernels/gat_fused.py::_dot_entry`` that returns the
    entry points of the library at ``lib_path``, with the same argtypes."""
    cdll = ctypes.CDLL(lib_path)
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    head = [i] * 6 + [f] + [i] * 3 + [p] * 4
    fns = {}
    for kind, more in (("fwd", 12), ("bwd_rows", 12), ("bwd_cols", 14)):
        fn = getattr(cdll, f"gespmm_dot_{kind}_f32")
        fn.argtypes, fn.restype = head + [p] * more, ctypes.c_int
        fns[kind] = fn
    cdll.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return lambda kind, dtype: (fns[kind], cdll.gespmm_cuda_error_string)


def registers(lib_path, cuobjdump):
    """(kernel, resource line) of each f32 dot kernel of the library."""
    usage = subprocess.run([cuobjdump, "-res-usage", lib_path],
                           capture_output=True, text=True, check=True).stdout
    out, name = [], None
    for line in usage.splitlines():
        if line.strip().startswith("Function"):
            name = line.strip().split()[-1].rstrip(":")
        elif name and "REG:" in line:
            m = re.search(r"(dot_(?:heads_)?(?:fwd|bwd_rows|bwd_cols)_kernel)"
                          r"IfLi(\d)ELi(\d+)E(?:Li(\d)E)?", name)
            if m:
                kernel, vec, sw, ns = m.groups()
                out.append((f"{kernel} VEC={vec} SW={sw}"
                            + (f" NS={ns}" if ns else ""), line.strip()))
            name = None
    return out


def same_bits(x, y):
    """Whether two calls' outputs (a tensor or a tuple) are bitwise equal."""
    xs, ys = ((x,), (y,)) if hasattr(x, "shape") else (x, y)
    return all(torch.equal(a, b) for a, b in zip(xs, ys))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("--pairs", type=int, default=2,
                    help="old/new groups a shape")
    ap.add_argument("--products-seed", type=int, default=2500000011,
                    help="seed of the products graph")
    ap.add_argument("--json", default="", help="also write the rows here")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import gat_fused as kgat
    from gespmm_tpu_torch.ops import reference as ref
    from gespmm_tpu_torch.ops.graph import add_self_loops
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.sparse.formats import CSR
    from gespmm_tpu_torch.utils import timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph, sbm_graph
    from gnnbench import dot_roofline, graphgen

    if not torch.cuda.is_available():
        print("row6_ab: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc = _build._nvcc()
    old_csrc = os.path.join(args.old_dir, "gespmm_tpu_torch", "csrc")
    old_lib = os.path.join(tempfile.mkdtemp(), "libdot_old.so")
    build = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", old_csrc, "-o",
                              old_lib,
                              os.path.join(old_csrc, "dot_attention.cu")])
    new_lib = str(_build.build("dot_attention"))
    if build.wait():
        raise RuntimeError(f"nvcc failed: {build.args}")
    old_entry = old_entries(old_lib)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def old(call):
        def run():
            saved = kgat._dot_entry
            kgat._dot_entry = old_entry
            try:
                return call()
            finally:
                kgat._dot_entry = saved
        return run

    # --- part 1: the single-head kernels against the old build ------------
    sbm = sbm_graph(n_per_class=6573, num_classes=3, p_in=0.0006,
                    p_out=0.00002, feat_dim=128, seed=0)
    graphs = {"sbm": Adjacency.from_csr(add_self_loops(sbm.csr), device=dev),
              "rmat15": Adjacency.from_csr(rmat_graph(15, 8, seed=0),
                                           device=dev)}
    for gname, Ka, K in (("sbm", 64, 64), ("sbm", 16, 3),
                         ("rmat15", 64, 64)):
        a = graphs[gname]
        m, n = a.shape
        D1 = torch.randn(m, Ka, device=dev, generator=gen) * Ka ** -0.25
        D2 = torch.randn(n, Ka, device=dev, generator=gen) * Ka ** -0.25
        B = torch.randn(n, K, device=dev, generator=gen)
        g = torch.randn(m, K, device=dev, generator=gen)
        out, mx, den = kgat.dot_forward(a.csr.indptr, a.csr.indices, D1, D2,
                                        B, split=a.split)
        tabs = (D1, D2, B, g, mx, den, ref.dot_row_dot(g, out))
        calls = {
            "fwd": lambda: kgat.dot_forward(a.csr.indptr, a.csr.indices, D1,
                                            D2, B, split=a.split),
            "bwd_rows": lambda: kgat.dot_backward_rows(
                a.csr.indptr, a.csr.indices, *tabs, split=a.split),
            "bwd_cols": lambda: kgat.dot_backward_cols(
                a.csc.indptr, a.csc.indices, *tabs, split=a.split_t)}
        shape = f"{gname} Ka={Ka} K={K}"
        for kind in KINDS:
            new_fn, old_fn = calls[kind], old(calls[kind])
            same = same_bits(new_fn(), old_fn())
            for _ in range(args.pairs):
                t = [timing.device_time(f) * 1e6
                     for f in (old_fn, new_fn, new_fn, old_fn)]
                rows.append({"kernel": f"dot_{kind}", "shape": shape,
                             "old_us": [t[0], t[3]], "new_us": [t[1], t[2]],
                             "bitwise_equal": same, "card": card})
                print(f"dot_{kind} {shape}: old {t[0]:.2f}, {t[3]:.2f} us | "
                      f"new {t[1]:.2f}, {t[2]:.2f} us | new/old "
                      f"{(t[1] + t[2]) / (t[0] + t[3]):.4f} | outputs "
                      f"{'bitwise equal' if same else 'DIFFER'} | {card}",
                      flush=True)
        del D1, D2, B, g, out, mx, den, tabs
    del graphs

    # --- part 2: the multi-head kernels at the UniMP cell's calls ---------
    with open(os.path.join(HERE, "gnnbench", "traffic",
                           "powerlaw.json")) as fh:
        traffic = json.load(fh)
    pg = graphgen.make_graph(traffic, args.products_seed, dev,
                             self_loops=False)
    a = Adjacency.from_csr(CSR(pg.indptr, pg.indices, None, (pg.n, pg.n)),
                           device=dev)
    n, nnz, H = pg.n, a.nnz, 2
    keep = torch.rand((nnz, H), device=dev, generator=gen) < 0.7
    for dh in (32, 47):
        K = H * dh
        D1, D2, B, g = (torch.randn(n, K, device=dev, generator=gen) * 0.3
                        for _ in range(4))
        for masked in (False, True):
            kw = dict(heads=H, scale=dh ** -0.5,
                      edge_keep=keep if masked else None,
                      keep_prob=0.7 if masked else None)
            out, mx, den = kgat.dot_forward(a.csr.indptr, a.csr.indices, D1,
                                            D2, B, split=a.split, **kw)
            tabs = (D1, D2, B, g, mx, den, ref.dot_row_dot(g, out, H))
            calls = {
                "fwd": lambda: kgat.dot_forward(
                    a.csr.indptr, a.csr.indices, D1, D2, B, split=a.split,
                    **kw),
                "bwd_rows": lambda: kgat.dot_backward_rows(
                    a.csr.indptr, a.csr.indices, *tabs, split=a.split, **kw),
                "bwd_cols": lambda: kgat.dot_backward_cols(
                    a.csc.indptr, a.csc.indices, *tabs, split=a.split_t,
                    perm=a.perm, **kw)}
            shape = (f"products H={H} dh={dh} "
                     f"{'masked' if masked else 'unmasked'}")
            for kind in KINDS:
                walks = kgat.dot_edge_walks
                calls[kind]()
                walks = kgat.dot_edge_walks - walks
                ms = [timing.device_time(calls[kind], iters=5) * 1e3
                      for _ in range(args.pairs)]
                bound_ms = dot_roofline.bound(*dot_roofline.dot_work(
                    kind, n, n, nnz, K, K, H, masked))[0] * 1e3
                rows.append({"kernel": f"dot_heads_{kind}", "shape": shape,
                             "ms": ms, "edge_walks": walks,
                             "bound_ms": bound_ms, "card": card})
                print(f"dot_heads_{kind} {shape}: "
                      + ", ".join(f"{t:.3f}" for t in ms)
                      + f" ms | edge walks {walks} | bound {bound_ms:.3f} ms"
                      f" ({100 * bound_ms / min(ms):.2f}%) | {card}",
                      flush=True)
        del D1, D2, B, g, out, mx, den, tabs
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    for tag, line in registers(new_lib, cuobjdump):
        print(f"resources {tag}: {line}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
