#!/usr/bin/env python3
"""Time an earlier build of kernel row 5 (the fused GAT forward and its two
backward kernels) against this checkout's, on one CUDA card.

    python3 scripts/gat_row5_ab.py OLD_DIR [--sass OUT_DIR] [--json PATH]

OLD_DIR holds an earlier ``gat_fused.cu``, for example the tree before the
split walks, unpacked with ``git archive f94ce7e | tar -x -C OLD_DIR``.  Its
entry points must take the first port's arguments (one warp a row, no
split): ``gespmm_gat_fwd_f32(m, K, H, vec, exact, slope, indptr, indices,
src, dst, B, mx, out, den, stream)``, ``gespmm_gat_bwd_rows_f32(m, K, H,
slope, indptr, indices, src, dst, B, g, mx, den, srow, grad_src, stream)``
and ``gespmm_gat_bwd_cols_f32(n, K, H, vec, slope, colptr, rows, src, dst,
B, g, mx, den, srow, grad_B, grad_dst, stream)``.

Both builds run the three kernels, f32, exact mode, on the SBM graph of the
GAT slice (pubmed scale, with self-loops) at (H, dh) = (1, 64), (1, 3),
(8, 8), (8, 3) and on rmat15 (scale 15, edge factor 8) at (1, 64) and
(8, 3), this checkout's with the adjacency's splits and carries.  Each
kernel is timed in the order old, new, new, old (device time, 50 calls a
group behind a spin kernel), and the two builds' outputs are compared.
Then this checkout's kernels at sbm H=1, dh = 64 and 3, with
``walk_shape``'s walker against one warp a row (SW = 32).
Prints one line a kernel and shape and the card's name and power limit;
``--json`` also writes the rows there.  ``--sass`` dumps the SASS of this
checkout's three kernels at the main shape's instantiation (f32, VEC = 4,
SW = 16) and at K = 3's (VEC = 1, SW = 4) into OUT_DIR, and prints, for
each, its global loads and branches and the loads that a branch can jump
over before the fold they feed.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("sbm", 1, 64), ("sbm", 1, 3), ("sbm", 8, 8), ("sbm", 8, 3),
          ("rmat15", 1, 64), ("rmat15", 8, 3))
SLOPE = 0.2


def old_entries(old_dir, nvcc, flags):
    """The earlier build's three f32 entry points."""
    src = os.path.join(old_dir, "gespmm_tpu_torch", "csrc", "gat_fused.cu")
    if not os.path.exists(src):
        src = os.path.join(old_dir, "gat_fused.cu")
    lib = os.path.join(tempfile.mkdtemp(), "libgat_old.so")
    subprocess.run([nvcc, *flags, "-o", lib, src], check=True)
    lib = ctypes.CDLL(lib)
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    entries = {}
    for kind, args in (("fwd", [i] * 5 + [f] + [p] * 9),
                       ("bwd_rows", [i] * 3 + [f] + [p] * 11),
                       ("bwd_cols", [i] * 4 + [f] + [p] * 12)):
        fn = getattr(lib, f"gespmm_gat_{kind}_f32")
        fn.argtypes, fn.restype = args, ctypes.c_int
        entries[kind] = fn
    return entries


def sass_report(lib_path, out_dir, cuobjdump):
    """Dump and summarise the SASS of the three kernels at two
    instantiations."""
    os.makedirs(out_dir, exist_ok=True)
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    for kernel in ("gat_fwd_kernel", "gat_bwd_rows_kernel",
                   "gat_bwd_cols_kernel"):
        for vec, sw in ((4, 16), (1, 4)):
            tag = f"{kernel}IfLi{vec}ELi{sw}E"  # the f32 instantiation
            body = next((f for f in funcs if tag in f.split("\n", 1)[0]),
                        None)
            if body is None:
                print(f"sass {kernel} VEC={vec} SW={sw}: not found")
                continue
            path = os.path.join(out_dir, f"{kernel}_f32_vec{vec}_sw{sw}.sass")
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
            print(f"sass {kernel} f32 VEC={vec} SW={sw}: {len(lines)} "
                  f"instructions, {len(ldg)} global loads ({vector} vector), "
                  f"{len(bra)} branches ({len(cond)} conditional), "
                  f"{len(guarded)} conditional branches right before a "
                  f"global load -> {path}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("--sass", default="", help="dump SASS here")
    ap.add_argument("--json", default="", help="also write the rows here")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import gat_fused as kgat
    from gespmm_tpu_torch.ops import reference as ref
    from gespmm_tpu_torch.ops.graph import add_self_loops
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.utils import timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph, sbm_graph

    if not torch.cuda.is_available():
        print("gat_row5_ab: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc = _build._nvcc()
    old = old_entries(args.old_dir, nvcc, _build.NVCC_FLAGS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    ds = sbm_graph(n_per_class=6573, num_classes=3, p_in=0.0006,
                   p_out=0.00002, feat_dim=128, seed=0)
    graphs = {"sbm": Adjacency.from_csr(add_self_loops(ds.csr), device=dev),
              "rmat15": Adjacency.from_csr(rmat_graph(15, 8, seed=0),
                                           device=dev)}
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for graph, H, dh in SHAPES:
        a = graphs[graph]
        m, n = a.shape
        K = H * dh
        src = torch.randn(m, H, device=dev, generator=gen)
        dst = torch.randn(n, H, device=dev, generator=gen)
        B = torch.randn(n, K, device=dev, generator=gen)
        g = torch.randn(m, K, device=dev, generator=gen)
        kw = dict(slope=SLOPE, heads=H)
        out, mx, den = kgat.gat_forward(a.csr.indptr, a.csr.indices, src, dst,
                                        B, split=a.split, **kw)
        s_row = ref.gat_row_dot(g, out, H)
        tabs = (src, dst, B, g, mx, den, s_row)
        # The first port's lane vector: 4 at K >= 128, 2 at K >= 64, else 1.
        vec = 4 if K % 4 == 0 and K >= 128 else 2 if K % 2 == 0 and K >= 64 \
            else 1

        def old_fwd():
            o = torch.empty(m, K, device=dev)
            x = torch.empty(m, H, device=dev)
            d = torch.empty(m, H, device=dev)
            err = old["fwd"](m, K, H, vec, 1, SLOPE, a.csr.indptr.data_ptr(),
                             a.csr.indices.data_ptr(), src.data_ptr(),
                             dst.data_ptr(), B.data_ptr(), x.data_ptr(),
                             o.data_ptr(), d.data_ptr(), stream())
            assert err == 0, err
            return o, x, d

        def old_rows():
            o = torch.empty(m, H, device=dev)
            err = old["bwd_rows"](m, K, H, SLOPE, a.csr.indptr.data_ptr(),
                                  a.csr.indices.data_ptr(),
                                  *(t.data_ptr() for t in tabs),
                                  o.data_ptr(), stream())
            assert err == 0, err
            return (o,)

        def old_cols():
            gd = torch.empty(n, H, device=dev)
            gb = torch.empty(n, K, device=dev)
            err = old["bwd_cols"](n, K, H, vec, SLOPE, a.csc.indptr.data_ptr(),
                                  a.csc.indices.data_ptr(),
                                  *(t.data_ptr() for t in tabs),
                                  gb.data_ptr(), gd.data_ptr(), stream())
            assert err == 0, err
            return gd, gb

        for name, old_call, new_call in (
                ("gat_fwd", old_fwd,
                 lambda: kgat.gat_forward(a.csr.indptr, a.csr.indices, src,
                                          dst, B, split=a.split, **kw)),
                ("gat_bwd_rows", old_rows,
                 lambda: (kgat.gat_backward_rows(
                     a.csr.indptr, a.csr.indices, *tabs, split=a.split,
                     **kw),)),
                ("gat_bwd_cols", old_cols,
                 lambda: kgat.gat_backward_cols(
                     a.csc.indptr, a.csc.indices, *tabs, split=a.split_t,
                     **kw))):
            diff = max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                         1.0)
                       for x, y in zip(new_call(), old_call()))
            t = [timing.device_time(f) * 1e6
                 for f in (old_call, new_call, new_call, old_call)]
            row = {"kernel": name, "shape": f"{graph} H={H} dh={dh}",
                   "old_us": [t[0], t[3]], "new_us": [t[1], t[2]],
                   "rel_diff": diff, "card": card}
            rows.append(row)
            print(f"{name} {graph} H={H} dh={dh}: old {t[0]:.2f}, {t[3]:.2f} "
                  f"us | new {t[1]:.2f}, {t[2]:.2f} us | "
                  f"{(t[0] + t[3]) / (t[1] + t[2]):.2f}x | outputs differ by "
                  f"{diff:.2e} of max(|old|, 1) | {card}", flush=True)
    # The walker width at the slice's two layers: this checkout's entry
    # points called with walk_shape's (VEC, SW) and with one warp a row
    # (SW = 32, the first port's VEC), in the order warp, chosen, chosen,
    # warp.  sbm has no segment, so no scratch and no carry.
    a = graphs["sbm"]
    fwd, rows_fn, cols_fn = (kgat._entry(kind, torch.float32)[0]
                             for kind in ("fwd", "bwd_rows", "bwd_cols"))
    split, split_t = (kgat._split_args(s, a.csr.indptr.device)
                      for s in (a.split, a.split_t))
    csr = (a.csr.indptr.data_ptr(), a.csr.indices.data_ptr())
    csc = (a.csc.indptr.data_ptr(), a.csc.indices.data_ptr())
    for H, dh, warp in ((1, 64, (2, 32)), (1, 3, (1, 32))):
        m, n = a.shape
        K = H * dh
        src = torch.randn(m, H, device=dev, generator=gen)
        dst = torch.randn(n, H, device=dev, generator=gen)
        B = torch.randn(n, K, device=dev, generator=gen)
        g = torch.randn(m, K, device=dev, generator=gen)
        out, mx, den = kgat.gat_forward(a.csr.indptr, a.csr.indices, src, dst,
                                        B, split=a.split, slope=SLOPE,
                                        heads=H)
        tabs = [t.data_ptr() for t in
                (src, dst, B, g, mx, den, ref.gat_row_dot(g, out, H))]

        def walk_fwd(vec, sw):
            o, x, d = (torch.empty(m, w, device=dev) for w in (K, H, H))
            err = fwd(m, K, H, vec, sw, 1, SLOPE, *split, *csr, *tabs[:3],
                      x.data_ptr(), o.data_ptr(), d.data_ptr(), None, None,
                      None, stream())
            assert err == 0, err
            return o

        def walk_rows(vec, sw):
            o = torch.empty(m, H, device=dev)
            err = rows_fn(m, K, H, vec, sw, SLOPE, *split, *csr, *tabs,
                          o.data_ptr(), None, stream())
            assert err == 0, err
            return o

        def walk_cols(vec, sw):
            gd = torch.empty(n, H, device=dev)
            gb = torch.empty(n, K, device=dev)
            err = cols_fn(n, K, H, vec, sw, SLOPE, *split_t, *csc, *tabs,
                          gb.data_ptr(), gd.data_ptr(), None, None, stream())
            assert err == 0, err
            return gb

        chosen = kgat.walk_shape(K, H, B)
        for name, call in (("gat_fwd", walk_fwd), ("gat_bwd_rows", walk_rows),
                           ("gat_bwd_cols", walk_cols)):
            t = [timing.device_time(lambda: call(*sh)) * 1e6
                 for sh in (warp, chosen, chosen, warp)]
            rows.append({"kernel": name, "shape": f"sbm H={H} dh={dh}",
                         "warp": list(warp), "chosen": list(chosen),
                         "warp_us": [t[0], t[3]], "chosen_us": [t[1], t[2]],
                         "card": card})
            print(f"{name} sbm H={H} dh={dh}: (VEC, SW) {warp} {t[0]:.2f}, "
                  f"{t[3]:.2f} us | {chosen} {t[1]:.2f}, {t[2]:.2f} us | "
                  f"{card}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        sass_report(_build.build("gat_fused"), args.sass, cuobjdump)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
