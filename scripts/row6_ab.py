#!/usr/bin/env python3
"""Time an earlier build of kernel row 6 (the fused dot-product attention
kernels) against this checkout's on one CUDA card, at chip_smoke.py's
single-head shapes and at the UniMP cell's multi-head calls.

    python3 scripts/row6_ab.py OLD_DIR [--pairs N] [--products-seed N]
        [--variants] [--json PATH]

OLD_DIR holds an earlier checkout, unpacked with ``git archive <commit> |
tar -x -C OLD_DIR``; its ``csrc/dot_attention.cu`` is built beside this
checkout's and called through this checkout's wrappers
(``kernels/gat_fused.py``), the old library in place of ``_dot_entry`` and
``_dot_heads_entry``.  Its single-head entry points take this checkout's
arguments; its multi-head ones those of the tree before the head groups
(no G after ns), which a stand-in drops.

Part 1, the single-head kernels at ``chip_smoke.py``'s shapes: the SBM
graph with self-loops (pubmed scale) at (Ka, K) = (64, 64) and (16, 3), and
rmat15 (edge factor 8: hub rows and columns of 3,866 edges, 11,708 empty
rows) at (64, 64); f32, identity act, the adjacency's splits.  Each
kernel's outputs are compared bit for bit, and it is timed in the order
old, new, new, old (device time, 50 calls a group behind a spin kernel),
``--pairs`` times.

Part 2, the multi-head kernels at the UniMP cell's calls on the products
graph (``gnnbench/graphgen.py``'s ``powerlaw`` traffic from
``--products-seed``, no self-loops: 2,449,029 nodes, 123,718,280
nonzeros): two heads of 32 (K = Ka = 64), two heads of 47 (K = Ka = 94)
and one head of 94, scale dh^-1/2, without and with the attention mask
(keep 0.7).  Each build's forward gives its own backward's tables.  Every
output of the two builds is compared bit for bit (expected equal at heads
of 32 and at one head; the tree before the head groups, unmasked at one
head, fuses the scale's product into the subtraction of the row's maximum
in its CSR walk alone, an ulp off the product rounded first), and each
build's is held to float64 on a sample (2,000 rows for out, mx, den and
grad_D1; 500 columns for grad_D2 and grad_B, whose rows' tables come from
float64 forwards over those rows) at the card tests' bounds (forward 1e-5 x
max |ref| + 1e-6, gradients 1e-4 x max(|ref|, 1)).  Each call is timed old,
new, new, old (5 calls a group), with its edge walks and walks in head
groups (``dot_edge_walks``, ``dot_grouped_walks``), its bound
(``gnnbench/dot_roofline.py`` over 3.35 TB/s) and its share of it.

``--variants`` (part 3) rebuilds this checkout's source with one constant
edited, ``kHeadsBatchOf`` at several slabs (2 -> 3, 4) or
``kHeadsColsMinBlocks`` (4 -> 3), and times each against this build at
heads of 32 and 47 with the mask (this, variant, variant, this), its
outputs compared bit for bit.

Prints one line a row, the registers of every f32 dot kernel of each build
(``cuobjdump -res-usage``) and the card's name and power limit; ``--json``
also writes the rows there.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("fwd", "bwd_rows", "bwd_cols")
# (name, pattern, replacement) of the --variants builds.
VARIANTS = (
    ("batch3", r"kHeadsBatchOf = NS == 1 \? 4 : 2;",
     "kHeadsBatchOf = NS == 1 ? 4 : 3;"),
    ("batch4", r"kHeadsBatchOf = NS == 1 \? 4 : 2;",
     "kHeadsBatchOf = NS == 1 ? 4 : 4;"),
    ("cols_blocks3", r"kHeadsColsMinBlocks = 4;", "kHeadsColsMinBlocks = 3;"),
)


def _error_string(cdll):
    cdll.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return cdll.gespmm_cuda_error_string


def single_entries(lib_path):
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
    err = _error_string(cdll)
    return lambda kind, dtype: (fns[kind], err)


def heads_entries(lib_path, takes_group):
    """A stand-in for ``_dot_heads_entry``: the library's multi-head entry
    points, called with this checkout's arguments; where the library takes
    no G (``takes_group`` False), G (the eighth argument) is dropped."""
    cdll = ctypes.CDLL(lib_path)
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    ints = 9 if takes_group else 8
    head = [i] * ints + [f] * 3 + [i] * 3 + [p] * 4
    fns = {}
    for kind, more in (("fwd", 13), ("bwd_rows", 13), ("bwd_cols", 16)):
        fn = getattr(cdll, f"gespmm_dot_heads_{kind}_f32")
        fn.argtypes, fn.restype = head + [p] * more, ctypes.c_int
        fns[kind] = (fn if takes_group else
                     (lambda fn: lambda *a: fn(*a[:7], *a[8:]))(fn))
    err = _error_string(cdll)
    return lambda kind, dtype: (fns[kind], err)


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
                          r"IfLi(\d)ELi(\d+)E(?:Li(\d)E)?(?:Lb(\d)E)?", name)
            if m:
                kernel, vec, sw, ns, major = m.groups()
                out.append((f"{kernel} VEC={vec} SW={sw}"
                            + (f" NS={ns}" if ns else "")
                            + (f" MAJOR={major}" if major else ""),
                            line.strip()))
            name = None
    return out


def same_bits(x, y):
    """Whether two calls' outputs (a tensor or a tuple) are bitwise equal."""
    xs, ys = ((x,), (y,)) if hasattr(x, "shape") else (x, y)
    return all(torch.equal(a, b) for a, b in zip(xs, ys))


def swapped(kgat, name, entry, call):
    """``call`` with ``kgat.<name>`` replaced by ``entry``."""
    def run():
        saved = getattr(kgat, name)
        setattr(kgat, name, entry)
        try:
            return call()
        finally:
            setattr(kgat, name, saved)
    return run


def edge_ids(indptr, units):
    """(unit position, edge id) of every edge of the rows (columns)
    ``units`` of a compressed structure."""
    start = indptr[units].long()
    count = indptr[units + 1].long() - start
    local = torch.repeat_interleave(torch.arange(units.numel(),
                                                 device=units.device), count)
    first = torch.cumsum(count, 0) - count
    at = torch.arange(local.numel(), device=units.device)
    return local, start[local] + at - first[local]


def sampled_errors(ref, a, H, dh, t64, keep, outs, gen, n_rows=2000,
                   n_cols=500, chunk=2000):
    """{name: (max abs error, bound)} of one build's outputs ``outs`` =
    (out, mx, den, grad_D1, grad_D2, grad_B) against float64 on sampled
    rows and columns (the module docstring)."""
    D1, D2, B, g = t64
    out, mx, den, gD1, gD2, gB = outs
    m, n = a.shape
    dev = D1.device
    scale = dh ** -0.5
    masked = keep is not None
    kw = dict(heads=H, scale=scale, keep_prob=0.7 if masked else None)
    ind = a.csr.indices

    def rows_forward(R):
        local, e = edge_ids(a.csr.indptr, R)
        return ref.dot_attention_rows(
            local, ind[e], D1[R], D2, B, R.numel(),
            keep=keep[e] if masked else None, **kw), local, e

    def tables(t):
        return t.view(-1, H) if H == 1 else t

    R = torch.randperm(m, generator=gen, device=dev)[:n_rows].sort().values
    (want_out, mx64, den64), local, e = rows_forward(R)
    s_row = ref.dot_row_dot(g[R], out[R].double(), H)
    want_d1 = ref.dot_attention_vjp_rows(
        local, ind[e], D1[R], D2, B, g[R], mx64, den64, s_row, R.numel(),
        keep=keep[e] if masked else None, **kw)
    pairs = {"out": (out[R], want_out), "mx": (mx[R], mx64),
             "den": (den[R], den64), "grad_D1": (gD1[R], want_d1)}
    C = torch.randperm(n, generator=gen, device=dev)[:n_cols].sort().values
    local_c, ec = edge_ids(a.csc.indptr, C)
    rows_c = a.csc.indices[ec]
    Rc = torch.unique(rows_c)
    mx_all = torch.zeros((m, H), dtype=torch.float64, device=dev)
    den_all = torch.ones((m, H), dtype=torch.float64, device=dev)
    s_all = torch.zeros((m, H), dtype=torch.float64, device=dev)
    for i in range(0, Rc.numel(), chunk):
        Ri = Rc[i:i + chunk]
        (_, mxi, deni), _, _ = rows_forward(Ri)
        mx_all[Ri], den_all[Ri] = tables(mxi), tables(deni)
        s_all[Ri] = tables(ref.dot_row_dot(g[Ri], out[Ri].double(), H))
    shape = (m,) if H == 1 else (m, H)
    want_d2, want_b = ref.dot_attention_vjp_cols(
        rows_c, local_c, D1, D2[C], B[C], g, mx_all.view(shape),
        den_all.view(shape), s_all.view(shape),
        keep=keep[a.perm[ec].long()] if masked else None, **kw)
    pairs.update(grad_D2=(gD2[C], want_d2), grad_B=(gB[C], want_b))
    errs = {}
    for name, (got, want) in pairs.items():
        fwd = name in ("out", "mx", "den")
        top = float(want.abs().max())
        bound = 1e-5 * top + 1e-6 if fwd else 1e-4 * max(top, 1.0)
        errs[name] = (float((got.double() - want.view(got.shape)).abs().max()),
                      bound)
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("--pairs", type=int, default=2,
                    help="old/new groups a shape")
    ap.add_argument("--products-seed", type=int, default=2500000011,
                    help="seed of the products graph")
    ap.add_argument("--variants", action="store_true",
                    help="also time this source with a constant edited")
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
    tmp = tempfile.mkdtemp()
    csrc = os.path.join(HERE, "gespmm_tpu_torch", "csrc")
    old_csrc = os.path.join(args.old_dir, "gespmm_tpu_torch", "csrc")
    builds = {"old": (old_csrc, os.path.join(old_csrc, "dot_attention.cu"))}
    if args.variants:
        with open(os.path.join(csrc, "dot_attention.cu")) as fh:
            source = fh.read()
        for name, pattern, repl in VARIANTS:
            edited, hits = re.subn(pattern, repl, source)
            if hits != 1:
                raise RuntimeError(f"variant {name}: {hits} matches")
            path = os.path.join(tmp, f"dot_attention_{name}.cu")
            with open(path, "w") as fh:
                fh.write(edited)
            builds[name] = (csrc, path)
    procs = {}
    for name, (inc, path) in builds.items():
        lib = os.path.join(tmp, f"libdot_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", inc, "-o", lib, path]))
    new_lib = str(_build.build("dot_attention"))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed: {proc.args}")
        libs[name] = lib
    with open(os.path.join(old_csrc, "dot_attention.cu")) as fh:
        old_takes_group = bool(re.search(r"int ns,[\s\\]*int G,",
                                         fh.read()))
    old_single = single_entries(libs["old"])
    old_heads = heads_entries(libs["old"], old_takes_group)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

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
            new_fn = calls[kind]
            old_fn = swapped(kgat, "_dot_entry", old_single, calls[kind])
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
    n, nnz = pg.n, a.nnz
    keep2 = torch.rand((nnz, 2), device=dev, generator=gen) < 0.7
    keep1 = keep2[:, :1].contiguous()
    variant_heads = {name: heads_entries(lib, True)
                     for name, lib in libs.items() if name != "old"}
    # (label, heads, head width, whether the builds must agree bit for bit)
    for label, H, dh, bitwise in (("H=2 dh=32", 2, 32, True),
                                  ("H=2 dh=47", 2, 47, False),
                                  ("H=1 dh=94", 1, 94, True)):
        K = H * dh
        D1, D2, B, g = (torch.randn(n, K, device=dev, generator=gen) * 0.3
                        for _ in range(4))
        t64 = tuple(t.double() for t in (D1, D2, B, g))
        for masked in (False, True):
            keep = (keep2 if H == 2 else keep1) if masked else None
            kw = dict(heads=H, scale=dh ** -0.5, edge_keep=keep,
                      keep_prob=0.7 if masked else None)
            builds_here = {"new": kgat._dot_heads_entry, "old": old_heads}
            if masked and H == 2:
                builds_here.update(variant_heads)

            def calls_of(entry):
                fwd = swapped(kgat, "_dot_heads_entry", entry, lambda: (
                    kgat.dot_forward(a.csr.indptr, a.csr.indices, D1, D2, B,
                                     split=a.split, **kw)))
                out, mx, den = fwd()
                tabs = (D1, D2, B, g, mx, den, ref.dot_row_dot(g, out, H))
                return {
                    "fwd": fwd,
                    "bwd_rows": swapped(kgat, "_dot_heads_entry", entry,
                                        lambda: kgat.dot_backward_rows(
                                            a.csr.indptr, a.csr.indices,
                                            *tabs, split=a.split, **kw)),
                    "bwd_cols": swapped(kgat, "_dot_heads_entry", entry,
                                        lambda: kgat.dot_backward_cols(
                                            a.csc.indptr, a.csc.indices,
                                            *tabs, split=a.split_t,
                                            perm=a.perm, **kw))}

            calls = {b: calls_of(entry) for b, entry in builds_here.items()}
            outs = {b: {kind: c[kind]() for kind in KINDS}
                    for b, c in calls.items()}
            shape = (f"products {label} "
                     f"{'masked' if masked else 'unmasked'}")
            flat = {b: (*o["fwd"], o["bwd_rows"], *o["bwd_cols"])
                    for b, o in outs.items()}
            sample = torch.Generator(device=dev)
            errs = {b: sampled_errors(ref, a, H, dh, t64, keep, flat[b],
                                      sample.manual_seed(1))
                    for b in ("new", "old")}
            for b in ("new", "old"):
                worst = max(e / bd for e, bd in errs[b].values())
                print(f"float64 {b} {shape}: "
                      + ", ".join(f"{k} {e:.3e} ({bd:.3e})"
                                  for k, (e, bd) in errs[b].items())
                      + f" | worst share of bound {worst:.4f} | "
                      + ("inside" if worst <= 1.0 else "OUTSIDE"),
                      flush=True)
                rows.append({"check": "float64", "build": b, "shape": shape,
                             "errors": errs[b], "card": card})
            for kind in KINDS:
                same = same_bits(outs["new"][kind], outs["old"][kind])
                walks = (kgat.dot_edge_walks, kgat.dot_grouped_walks)
                calls["new"][kind]()
                walks = (kgat.dot_edge_walks - walks[0],
                         kgat.dot_grouped_walks - walks[1])
                ms = []
                for _ in range(args.pairs):
                    t = [timing.device_time(calls[b][kind], iters=5) * 1e3
                         for b in ("old", "new", "new", "old")]
                    ms.append(t)
                bound_ms = dot_roofline.bound(*dot_roofline.dot_work(
                    kind, n, n, nnz, K, K, H, masked))[0] * 1e3
                best_new = min(min(t[1], t[2]) for t in ms)
                rows.append({"kernel": f"dot_heads_{kind}", "shape": shape,
                             "old_ms": [[t[0], t[3]] for t in ms],
                             "new_ms": [[t[1], t[2]] for t in ms],
                             "bitwise_equal": same, "edge_walks": walks[0],
                             "grouped_walks": walks[1], "bound_ms": bound_ms,
                             "card": card})
                old_sum = sum(t[0] + t[3] for t in ms)
                new_sum = sum(t[1] + t[2] for t in ms)
                print(f"dot_heads_{kind} {shape}: old "
                      + ", ".join(f"{t[0]:.3f}, {t[3]:.3f}" for t in ms)
                      + " ms | new "
                      + ", ".join(f"{t[1]:.3f}, {t[2]:.3f}" for t in ms)
                      + f" ms | new/old {new_sum / old_sum:.4f} | outputs "
                      f"{'bitwise equal' if same else 'differ'}"
                      f"{' (EXPECTED EQUAL)' if bitwise and not same else ''}"
                      f" | walks {walks[0]}, grouped {walks[1]} | bound "
                      f"{bound_ms:.3f} ms ({100 * bound_ms / best_new:.2f}%)"
                      f" | {card}", flush=True)
                # --- part 3: this source with a constant edited -----------
                for v in builds_here:
                    if v in ("new", "old"):
                        continue
                    vsame = same_bits(outs["new"][kind], outs[v][kind])
                    t = [timing.device_time(calls[b][kind], iters=5) * 1e3
                         for b in ("new", v, v, "new")]
                    rows.append({"kernel": f"dot_heads_{kind}",
                                 "shape": shape, "variant": v,
                                 "new_ms": [t[0], t[3]],
                                 "variant_ms": [t[1], t[2]],
                                 "bitwise_equal": vsame, "card": card})
                    print(f"variant {v} dot_heads_{kind} {shape}: new "
                          f"{t[0]:.3f}, {t[3]:.3f} ms | variant {t[1]:.3f}, "
                          f"{t[2]:.3f} ms | variant/new "
                          f"{(t[1] + t[2]) / (t[0] + t[3]):.4f} | outputs "
                          f"{'bitwise equal' if vsame else 'DIFFER'}",
                          flush=True)
            del calls, outs, flat
        del D1, D2, B, g, t64
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    for name, lib in (("new", new_lib), *libs.items()):
        for tag, line in registers(lib, cuobjdump):
            print(f"resources {name} {tag}: {line}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    shutil.rmtree(tmp, ignore_errors=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
