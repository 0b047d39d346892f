#!/usr/bin/env python3
"""Time an earlier build of kernel row 5 (the fused GAT forward and its two
backward kernels) against this checkout's, on one CUDA card.

    python3 scripts/gat_row5_ab.py OLD_DIR [--variants [NAME ...]]
        [--graphs sbm rmat15 products] [--sass OUT_DIR] [--json PATH]
        [--products-seed N]

OLD_DIR holds an earlier ``gat_fused.cu``, for example the tree before the
slab groups, unpacked with ``git archive c5b4cc9 | tar -x -C OLD_DIR``.
Its entry points take the split walks' arguments without a slab count:
``gespmm_gat_fwd_f32(m, K, H, vec, sw, exact, slope, L, S, J, seg_row,
seg_start, long_rows, seg_ptr, indptr, indices, src, dst, B, mx, out, den,
pm, pz, pacc, stream)``, ``gespmm_gat_bwd_rows_f32(m, K, H, vec, sw, slope,
<split>, indptr, indices, src, dst, B, g, mx, den, srow, grad_src, part,
stream)`` and ``gespmm_gat_bwd_cols_f32(n, K, H, vec, sw, slope, <split>,
colptr, rows, src, dst, B, g, mx, den, srow, grad_B, grad_dst, part_B,
part_dst, stream)``; this checkout's take NS after SW
(``kernels/gat_fused.py::launch_shape``).

Both builds run the three kernels, f32, exact mode, with the adjacency's
splits and carries and the same (VEC, SW): on the SBM graph of the GAT
slice (pubmed scale, with self-loops) at (H, dh) = (1, 64), (1, 3), (8, 8),
(8, 3), on rmat15 (scale 15, edge factor 8) at (1, 64) and (8, 3), and on
the products GAT cell's graph (``gnnbench/graphgen.py``'s ``powerlaw``
traffic with self-loops: 2,449,029 nodes, 126,167,309 nonzeros) at the
cell's heads (4, 128) and (4, 47).  Each kernel is timed in the order old,
new, new, old (device time behind a spin kernel: 50 calls a group, 5 on
the products graph), the two builds' outputs are compared bit for bit, and
the edge walks of this checkout's launch are printed (``edge_walks``).
Then, on the products graph, this checkout's kernels at NS = 1 (a walk a K
slab) against ``launch_shape``'s NS, in the order one, chosen, chosen, one.
``--variants`` adds this checkout's source rebuilt with one of its depth
constants fixed (``VARIANTS``: the gather depth ``kBatchOf``, the head
loads in flight ``kHeadLoadsOf``, the blocks an SM ``kMinBlocks``), each
timed at every shape against this checkout's, in the order variant,
chosen, chosen, variant.  Prints one line a kernel and shape and the
card's name and power limit; ``--json`` also writes the rows there.
``--sass`` dumps the SASS of this checkout's three kernels at the products
instantiations (f32: VEC 4, SW 32, NS 4 and VEC 1, SW 32, NS 6) and at
the single-slab sbm ones (VEC 4, SW 16 and VEC 1, SW 4) into OUT_DIR,
prints each one's global loads and branches, and prints the registers,
stack and local memory of every f32 row-5 kernel (``cuobjdump
-res-usage``).
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

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("sbm", 1, 64), ("sbm", 1, 3), ("sbm", 8, 8), ("sbm", 8, 3),
          ("rmat15", 1, 64), ("rmat15", 8, 3), ("products", 4, 128),
          ("products", 4, 47))
SLOPE = 0.2
KINDS = ("fwd", "bwd_rows", "bwd_cols")
# Variants of this checkout's source: each constant of csrc/gat_fused.cu
# that sets a walker's depth, fixed at another value.
BATCH = "kBatchOf = NS * VEC >= 16 ? 2 : 4;"
HEADS = "kHeadLoadsOf = NS > 1 ? 4 : 1;"
BLOCKS = "kMinBlocks = NS > 1 ? 2 : ONE_SLAB;"
VARIANTS = {"batch 4": (BATCH, "kBatchOf = 4;"),
            "batch 2": (BATCH, "kBatchOf = 2;"),
            "head loads 4": (HEADS, "kHeadLoadsOf = 4;"),
            "head loads 1": (HEADS, "kHeadLoadsOf = 1;"),
            "min blocks 1": (BLOCKS, "kMinBlocks = 1;"),
            "one-slab blocks 1": (BLOCKS, "kMinBlocks = NS > 1 ? 2 : 1;"),
            "one-slab blocks 4": (BLOCKS, "kMinBlocks = NS > 1 ? 2 : 4;")}


def entries(lib_path, with_ns):
    """A build's three f32 entry points, with or without the NS argument."""
    lib = ctypes.CDLL(str(lib_path))
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    extra = [i] if with_ns else []
    split = [i] * 3 + [p] * 4
    out = {}
    for kind, args in (("fwd", [i] * 6 + extra + [f] + split + [p] * 12),
                       ("bwd_rows", [i] * 5 + extra + [f] + split + [p] * 12),
                       ("bwd_cols", [i] * 5 + extra + [f] + split + [p] * 14)):
        fn = getattr(lib, f"gespmm_gat_{kind}_f32")
        fn.argtypes, fn.restype = args, ctypes.c_int
        out[kind] = fn
    return out


def build(sources, nvcc, flags):
    """Build ``gat_fused.cu`` of each directory of ``sources`` (which holds
    its headers), in parallel; the libraries' paths."""
    libs = [os.path.join(tempfile.mkdtemp(), "libgat.so") for _ in sources]
    procs = [subprocess.Popen([nvcc, *flags, "-o", lib,
                               os.path.join(src, "gat_fused.cu")])
             for src, lib in zip(sources, libs)]
    for p in procs:
        if p.wait():
            raise RuntimeError(f"nvcc failed: {p.args}")
    return libs


def variant_dir(csrc, old, new):
    """A copy of ``csrc`` with ``old`` replaced by ``new`` in gat_fused.cu."""
    out = tempfile.mkdtemp()
    for name in os.listdir(csrc):
        shutil.copy(os.path.join(csrc, name), out)
    path = os.path.join(out, "gat_fused.cu")
    text = open(path).read()
    assert text.count(old) == 1, f"{old!r} changed: update VARIANTS"
    with open(path, "w") as fh:
        fh.write(text.replace(old, new))
    return out


def compare(a, b):
    """(bitwise equal, largest difference over max(|b|, 1)) of two calls'
    outputs."""
    import torch
    if all(torch.equal(x, y) for x, y in zip(a, b)):
        return True, 0.0
    return False, max(float((x.double() - y.double()).abs().max())
                      / max(float(y.abs().max()), 1.0) for x, y in zip(a, b))


def sass_report(lib_path, out_dir, cuobjdump):
    """Dump and summarise the SASS of the three kernels at four
    instantiations, and print every row-5 kernel's resource use."""
    os.makedirs(out_dir, exist_ok=True)
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    for kernel in ("gat_fwd_kernel", "gat_bwd_rows_kernel",
                   "gat_bwd_cols_kernel"):
        for vec, sw, ns in ((4, 32, 4), (1, 32, 6), (4, 16, 1), (1, 4, 1)):
            tag = f"{kernel}IfLi{vec}ELi{sw}ELi{ns}E"  # the f32 one
            body = next((f for f in funcs if tag in f.split("\n", 1)[0]),
                        None)
            if body is None:
                print(f"sass {kernel} VEC={vec} SW={sw} NS={ns}: not found")
                continue
            path = os.path.join(out_dir,
                                f"{kernel}_f32_vec{vec}_sw{sw}_ns{ns}.sass")
            with open(path, "w") as fh:
                fh.write(body)
            lines = [ln for ln in body.splitlines() if "/*" in ln]
            ldg = [n for n, ln in enumerate(lines) if "LDG" in ln]
            bra = [n for n, ln in enumerate(lines) if re.search(r"\bBRA\b", ln)]
            cond = [n for n in bra if re.search(r"@!?U?P\d", lines[n])]
            # A conditional branch with a global load in the next 8
            # instructions: a gather that the branch can skip.
            guarded = [n for n in cond if any(0 < m - n <= 8 for m in ldg)]
            vector = sum("LDG.E.128" in lines[n] or "LDG.E.64" in lines[n]
                          for n in ldg)
            print(f"sass {kernel} f32 VEC={vec} SW={sw} NS={ns}: "
                  f"{len(lines)} instructions, {len(ldg)} global loads "
                  f"({vector} vector), {len(bra)} branches ({len(cond)} "
                  f"conditional), {len(guarded)} conditional branches right "
                  f"before a global load -> {path}", flush=True)
    usage = subprocess.run([cuobjdump, "-res-usage", str(lib_path)],
                           capture_output=True, text=True, check=True).stdout
    name = None
    for line in usage.splitlines():
        if line.strip().startswith("Function"):
            name = line.strip().split()[-1].rstrip(":")
        elif name and "REG:" in line and "gat_" in name:
            m = re.search(r"gat_(fwd|bwd_rows|bwd_cols)_kernelIfLi(\d)ELi"
                          r"(\d+)ELi(\d)E", name)  # the f32 ones
            if m:
                print(f"resources gat_{m.group(1)} f32 VEC={m.group(2)} "
                      f"SW={m.group(3)} NS={m.group(4)}: {line.strip()}",
                      flush=True)
            name = None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("--variants", nargs="*", default=None,
                    help="also time these builds of VARIANTS (all without "
                         "a name)")
    ap.add_argument("--graphs", nargs="+", default=["sbm", "rmat15",
                                                    "products"],
                    help="the graphs of SHAPES to run")
    ap.add_argument("--sass", default="", help="dump SASS here")
    ap.add_argument("--json", default="", help="also write the rows here")
    ap.add_argument("--products-seed", type=int, default=2200000019,
                    help="seed of the products graph")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import gat_fused as kgat
    from gespmm_tpu_torch.ops import reference as ref
    from gespmm_tpu_torch.ops.graph import add_self_loops
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.sparse.formats import CSR
    from gespmm_tpu_torch.utils import timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph, sbm_graph
    from gnnbench import graphgen

    if not torch.cuda.is_available():
        print("gat_row5_ab: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc = _build._nvcc()
    old_src = os.path.join(args.old_dir, "gespmm_tpu_torch", "csrc")
    if not os.path.isdir(old_src):
        old_src = args.old_dir
    tags = ([] if args.variants is None else args.variants or list(VARIANTS))
    libs = build([old_src] + [variant_dir(str(_build.CSRC_DIR), *VARIANTS[t])
                              for t in tags], nvcc, _build.NVCC_FLAGS)
    old = entries(libs[0], False)
    builds = {t: entries(lib, True) for t, lib in zip(tags, libs[1:])}
    new_lib = _build.build("gat_fused")
    new = entries(new_lib, True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def graph(name):
        if name == "sbm":
            ds = sbm_graph(n_per_class=6573, num_classes=3, p_in=0.0006,
                           p_out=0.00002, feat_dim=128, seed=0)
            return Adjacency.from_csr(add_self_loops(ds.csr), device=dev)
        if name == "rmat15":
            return Adjacency.from_csr(rmat_graph(15, 8, seed=0), device=dev)
        with open(os.path.join(HERE, "gnnbench", "traffic",
                               "powerlaw.json")) as fh:
            traffic = json.load(fh)
        g = graphgen.make_graph(traffic, args.products_seed, dev,
                                self_loops=True)
        return Adjacency.from_csr(CSR(g.indptr, g.indices, None, (g.n, g.n)),
                                  device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    adj_name, a = None, None
    for gname, H, dh in (s for s in SHAPES if s[0] in args.graphs):
        if gname != adj_name:
            a = None
            torch.cuda.empty_cache()
            adj_name, a = gname, graph(gname)
        m, n = a.shape
        K = H * dh
        iters = 5 if gname == "products" else 50
        src = torch.randn(m, H, device=dev, generator=gen)
        dst = torch.randn(n, H, device=dev, generator=gen)
        B = torch.randn(n, K, device=dev, generator=gen)
        g = torch.randn(m, K, device=dev, generator=gen)
        # One call of each wrapper: the tables, and the edge walks that
        # this checkout's launches count.
        kgat.reset_launches()
        kw = dict(slope=SLOPE, heads=H)
        out, mx, den = kgat.gat_forward(a.csr.indptr, a.csr.indices, src, dst,
                                        B, split=a.split, **kw)
        tables = (src, dst, B, g, mx, den, ref.gat_row_dot(g, out, H))
        del out
        kgat.gat_backward_rows(a.csr.indptr, a.csr.indices, *tables,
                               split=a.split, **kw)
        kgat.gat_backward_cols(a.csc.indptr, a.csc.indices, *tables,
                               split=a.split_t, **kw)
        print(f"{gname} H={H} dh={dh}: edge_walks {kgat.edge_walks} for the "
              f"three launches", flush=True)
        tabs = [t.data_ptr() for t in tables]
        split, split_t = (kgat._split_args(s, a.csr.indptr.device)
                          for s in (a.split, a.split_t))
        S, St = a.split.num_segments, a.split_t.num_segments
        csr = (a.csr.indptr.data_ptr(), a.csr.indices.data_ptr())
        csc = (a.csc.indptr.data_ptr(), a.csc.indices.data_ptr())
        empty = lambda r, c: torch.empty(r, c, device=dev)
        shapes = {kind: kgat.launch_shape(K, H, 3 if kind == "bwd_cols" else 1,
                                          B, g) for kind in KINDS}

        def call(fns, kind, ns=None):
            """fns[kind] once; ns None: the old build's arguments, 0: NS
            from launch_shape.  Returns the outputs."""
            vec, sw, chosen = shapes[kind]
            shape = (vec, sw) if ns is None else (vec, sw, ns or chosen)
            held = []  # the scratch buffers, until the launch is queued

            def scratch(r, c):
                if not r:
                    return None
                held.append(empty(r, c))
                return held[-1].data_ptr()

            if kind == "fwd":
                o, x, d = empty(m, K), empty(m, H), empty(m, H)
                err = fns[kind](m, K, H, *shape, 1, SLOPE, *split, *csr,
                                *tabs[:3], x.data_ptr(), o.data_ptr(),
                                d.data_ptr(), scratch(S, H), scratch(S, H),
                                scratch(S, K), stream())
                res = (o, x, d)
            elif kind == "bwd_rows":
                o = empty(m, H)
                err = fns[kind](m, K, H, *shape, SLOPE, *split, *csr, *tabs,
                                o.data_ptr(), scratch(S, H), stream())
                res = (o,)
            else:
                gd, gb = empty(n, H), empty(n, K)
                err = fns[kind](n, K, H, *shape, SLOPE, *split_t, *csc, *tabs,
                                gb.data_ptr(), gd.data_ptr(), scratch(St, K),
                                scratch(St, H), stream())
                res = (gd, gb)
            assert err == 0, (kind, err)
            return res

        for kind in KINDS:
            vec, sw, ns = shapes[kind]
            walks = -(-K // (sw * vec)) // ns
            same, diff = compare(call(new, kind, 0), call(old, kind))
            t = [timing.device_time(f, iters=iters) * 1e6 for f in (
                lambda: call(old, kind)[0], lambda: call(new, kind, 0)[0],
                lambda: call(new, kind, 0)[0], lambda: call(old, kind)[0])]
            row = {"kernel": f"gat_{kind}", "shape": f"{gname} H={H} dh={dh}",
                   "vec_sw_ns": [vec, sw, ns], "edge_walks": walks,
                   "old_us": [t[0], t[3]], "new_us": [t[1], t[2]],
                   "bitwise_equal": same, "rel_diff": diff, "card": card}
            rows.append(row)
            print(f"gat_{kind} {gname} H={H} dh={dh} (VEC, SW, NS) = "
                  f"{(vec, sw, ns)}, edge walks {walks}: old {t[0]:.2f}, "
                  f"{t[3]:.2f} us | new {t[1]:.2f}, {t[2]:.2f} us | "
                  f"{(t[0] + t[3]) / (t[1] + t[2]):.3f}x | outputs "
                  f"{'bitwise equal' if same else f'DIFFER by {diff:.2e}'} | "
                  f"{card}", flush=True)
            for tag, fns in builds.items():
                same, diff = compare(call(fns, kind, 0), call(new, kind, 0))
                t = [timing.device_time(f, iters=iters) * 1e6 for f in (
                    lambda: call(fns, kind, 0)[0],
                    lambda: call(new, kind, 0)[0],
                    lambda: call(new, kind, 0)[0],
                    lambda: call(fns, kind, 0)[0])]
                rows.append({"kernel": f"gat_{kind}",
                             "shape": f"{gname} H={H} dh={dh}",
                             "variant": tag, "variant_us": [t[0], t[3]],
                             "chosen_us": [t[1], t[2]],
                             "bitwise_equal": same, "card": card})
                print(f"gat_{kind} {gname} H={H} dh={dh}: {tag} {t[0]:.2f}, "
                      f"{t[3]:.2f} us | chosen {t[1]:.2f}, {t[2]:.2f} us | "
                      f"outputs {'bitwise equal' if same else 'DIFFER'} | "
                      f"{card}", flush=True)
            if gname != "products":
                continue
            # The same build at NS = 1 (a walk a K slab) against NS chosen.
            one, _ = compare(call(new, kind, 1), call(new, kind, 0))
            t = [timing.device_time(f, iters=iters) * 1e6 for f in (
                lambda: call(new, kind, 1)[0], lambda: call(new, kind, 0)[0],
                lambda: call(new, kind, 0)[0], lambda: call(new, kind, 1)[0])]
            rows.append({"kernel": f"gat_{kind}",
                         "shape": f"{gname} H={H} dh={dh}", "ns": [1, ns],
                         "ns1_us": [t[0], t[3]], "chosen_us": [t[1], t[2]],
                         "bitwise_equal": one, "card": card})
            print(f"gat_{kind} {gname} H={H} dh={dh}: NS=1 {t[0]:.2f}, "
                  f"{t[3]:.2f} us | NS={ns} {t[1]:.2f}, {t[2]:.2f} us | "
                  f"{(t[0] + t[3]) / (t[1] + t[2]):.3f}x | outputs "
                  f"{'bitwise equal' if one else 'DIFFER'} | {card}",
                  flush=True)
        del src, dst, B, g, mx, den, tables
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        sass_report(new_lib, args.sass, cuobjdump)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
