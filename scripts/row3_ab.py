#!/usr/bin/env python3
"""Time an earlier build of kernel row 3 (the max/min SpMM backward) against
this checkout's, on one CUDA card, and A/B two of this checkout's choices.

    python3 scripts/row3_ab.py OLD_DIR [--sass OUT_DIR] [--json PATH]
                               [--variants]

OLD_DIR holds an earlier checkout (``git archive 765e4df | tar -x -C
OLD_DIR``) whose ``gespmm_spmm_minmax_vjp_f32(n, K, nnz, vec, colptr, rows,
vals, B, out, gt, grad_B, grad_vals, stream)`` takes the folded table ``gt =
g / max(ties, 1)``: one warp a column, no split.  It is called as that
checkout's wrapper called it: the fold in two torch ops, then the kernel at
its lane vector (4 at K >= 128, 2 at K >= 64, else 1).  This checkout's
``spmm_minmax_vjp`` is called as the op calls it: g and ties, the CSC's
split.  Shapes (f32, binary, max, B relu'd as SAGE-pool's pool layer gives
it): the SBM graph of the SAGE slice (pubmed scale, no self-loops) at K=128
and K=16 and rmat15 (scale 15, edge factor 8) at K=128; then the sharded
tier's backward over each transposed block of rmat15's P=4 halo partition
at K=128: the earlier row 3 once a shard (what the earlier sharded tier
launched) against one stacked launch over the four shards.  Each pair is
timed in the order old, new, new, old (device time, 50 calls a group behind
a spin kernel); the outputs are compared.

Then, at the three single-device shapes, this checkout's wrapper with:
  * the kernel rebuilt with g and ties loaded only by lanes where a column
    achieves the output (a branch around the two loads; ``lazy_source``)
    against this build (all three rows gathered), in the order eager,
    lazy, lazy, eager;
  * at sbm K=16 and K=32, the narrow walker ``walk_shape`` picks against one
    warp a column at the earlier lane vector, in the order warp, chosen,
    chosen, warp.

With ``--variants``, this checkout's source rebuilt with one change each
(text substitutions, timed through the wrapper at the three single-device
shapes against the source as it is, in the order listed then reversed):
the batch depth (1, 4 and 8 edges against 2), register caps
(``__launch_bounds__(256, n)``, n = 4, 5, 6), and builds that drop part of
the work to show where the time goes: the exact division (g times ties in
its place), the ties gather with it (w = g), and the g gather too (w = 1).
The dropped-work builds compute another function: their times say what a
part costs, nothing else.  Then the walkers at sbm K=16 (VEC, SW) = (4, 4),
the shape walk_shape picks, against (2, 8) and (1, 16).

Prints one line a row and the card's name and power limit; ``--json`` also
writes the rows there.  ``--sass`` dumps into OUT_DIR the SASS of row 3's
walk (f32, binary, at (VEC, SW) = (4, 32) and (4, 4), with and without the
split) and of row 1's (``spmm_csr_kernel``, f32, VEC 4, one slab, with and
without the split), and prints for each its global loads and branches and the
conditional branches with a global load within the next 8 instructions (a
gather that a branch can skip).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("sbm", 128), ("sbm", 16), ("rmat15", 128))
# (kernel, mangled template arguments, label) of the SASS summary.
SASS = (("spmm_minmax_vjp_kernel", "IfLi4ELi32ELb0ELb0ELb0E", "VEC4 SW32"),
        ("spmm_minmax_vjp_kernel", "IfLi4ELi32ELb0ELb0ELb1E",
         "VEC4 SW32 split"),
        ("spmm_minmax_vjp_kernel", "IfLi4ELi4ELb0ELb0ELb0E", "VEC4 SW4"),
        ("spmm_csr_kernel", "IffLi4ELi32ELi1ELb0ELb0E", "VEC4"),
        ("spmm_csr_kernel", "IffLi4ELi32ELi1ELb0ELb1E", "VEC4 split"))


def nvcc_build(nvcc, flags, src, out):
    subprocess.run([nvcc, *flags, "-o", out, src], check=True)
    return out


def sass_report(libs, out_dir, cuobjdump):
    """Dump and summarise the SASS of the walks listed in SASS."""
    os.makedirs(out_dir, exist_ok=True)
    funcs = {}
    for lib in libs:
        text = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs[lib] = re.split(r"\n\s*Function : ", text)
    for kernel, targs, label in SASS:
        body = next((f for fs in funcs.values() for f in fs
                     if f"{kernel}{targs}" in f.split("\n", 1)[0]), None)
        if body is None:
            print(f"sass {kernel} {label}: not found", flush=True)
            continue
        path = os.path.join(out_dir, f"{kernel}_{label.replace(' ', '_')}"
                            ".sass")
        with open(path, "w") as fh:
            fh.write(body)
        lines = [ln for ln in body.splitlines() if "/*" in ln]
        ldg = [n for n, ln in enumerate(lines) if "LDG" in ln]
        bra = [n for n, ln in enumerate(lines) if re.search(r"\bBRA\b", ln)]
        cond = [n for n in bra if re.search(r"@!?U?P\d", lines[n])]
        guarded = [n for n in cond if any(0 < m - n <= 8 for m in ldg)]
        vector = sum("LDG.E.128" in lines[n] or "LDG.E.64" in lines[n]
                     for n in ldg)
        print(f"sass {kernel} f32 {label}: {len(lines)} instructions, "
              f"{len(ldg)} global loads ({vector} vector), {len(bra)} "
              f"branches ({len(cond)} conditional), {len(guarded)} "
              f"conditional branches right before a global load -> {path}",
              flush=True)


LOADS = """          gg[u] = *reinterpret_cast<const P*>(g_tab + off[u]);
          nn[u] = *reinterpret_cast<const F*>(n_tab + off[u]);
"""
FOLD = "          float part = 0.f;\n"
DIV = ("hit[x] ? __fdiv_rn(to_f32(gg[u].v[x]), fmaxf(nn[u].v[x], 1.f))\n"
       "                       : 0.f;")


def lazy_source(src):
    """This checkout's kernel with g and ties loaded only by lanes where a
    column achieves the output (a branch around the two loads)."""
    for text in (LOADS, FOLD):
        assert src.count(text) == 1, text
    lazy = ("          bool any = false;\n"
            "#pragma unroll\n"
            "          for (int x = 0; x < VEC; ++x) any = any || hit[x];\n"
            "          if (any) {\n"
            + LOADS.replace("          ", "            ") +
            "          } else {\n"
            "            gg[u] = P{};\n            nn[u] = F{};\n"
            "          }\n")
    return src.replace(LOADS, "").replace(FOLD, lazy + FOLD)


def variant_sources(src):
    """{name: source} of this checkout's kernel with one change each."""
    batch = "constexpr int kBatch = 2;"
    bounds = ("          bool SPLIT>\n__global__ void "
              "__launch_bounds__(kThreads)")
    g_load, ties_load = LOADS.splitlines(keepends=True)
    for text in (batch, bounds, DIV):
        assert text in src, text
    no_ties = src.replace(DIV, "hit[x] ? to_f32(gg[u].v[x]) : 0.f;").replace(
        ties_load, "          nn[u] = F{};\n")
    out = {f"batch {n}": src.replace(batch, f"constexpr int kBatch = {n};")
           for n in (1, 4, 8)}
    out.update({f"registers for {n} blocks": src.replace(
        bounds, bounds.replace("(kThreads)", f"(kThreads, {n})"))
        for n in (4, 5, 6)})
    out["drop the division"] = src.replace(
        DIV, "hit[x] ? to_f32(gg[u].v[x]) * nn[u].v[x] : 0.f;")
    out["drop ties"] = no_ties
    out["drop ties and g"] = no_ties.replace(
        "hit[x] ? to_f32(gg[u].v[x]) : 0.f;", "hit[x] ? 1.f : 0.f;").replace(
        g_load, "          gg[u] = P{};\n")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("--sass", default="", help="dump SASS here")
    ap.add_argument("--json", default="", help="also write the rows here")
    ap.add_argument("--variants", action="store_true",
                    help="also time rebuilt variants of this source")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import ctypes

    import torch
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import halo_spmm as khalo
    from gespmm_tpu_torch.kernels import spmm_minmax as kmm
    from gespmm_tpu_torch.kernels.spmm_csr import lane_vector
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.parallel import build_halo_partition, make_mesh
    from gespmm_tpu_torch.parallel.halo import make_exchange
    from gespmm_tpu_torch.utils import timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph, sbm_graph

    if not torch.cuda.is_available():
        print("row3_ab: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    tmp = tempfile.mkdtemp()
    old_src = os.path.join(args.old_dir, "gespmm_tpu_torch", "csrc",
                           "spmm_minmax.cu")
    lazy_src = os.path.join(tmp, "spmm_minmax_lazy.cu")
    with open(lazy_src, "w") as fh:
        fh.write(lazy_source(
            _build.CSRC_DIR.joinpath("spmm_minmax.cu").read_text()))
    with_csrc = (*flags, "-I", str(_build.CSRC_DIR))
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(nvcc_build, nvcc, flags, old_src,
                            os.path.join(tmp, "libmm_old.so")),
                pool.submit(nvcc_build, nvcc, with_csrc, lazy_src,
                            os.path.join(tmp, "libmm_lazy.so")),
                pool.submit(_build.build, "spmm_minmax"),
                pool.submit(_build.build, "spmm_csr")]
        old_lib, lazy_lib, new_lib, csr_lib = (j.result() for j in jobs)
    old = ctypes.CDLL(old_lib).gespmm_spmm_minmax_vjp_f32
    i, p = ctypes.c_int, ctypes.c_void_p
    old.argtypes, old.restype = [i] * 4 + [p] * 9, ctypes.c_int
    lazy_cdll = ctypes.CDLL(lazy_lib)
    lazy = lazy_cdll.gespmm_spmm_minmax_vjp_f32
    lazy.argtypes = [i] * 11 + [ctypes.c_int64] * 2 + [p] * 15
    lazy.restype = ctypes.c_int
    lazy_cdll.gespmm_cuda_error_string.restype = ctypes.c_char_p
    lazy_entry = (lazy, lazy_cdll.gespmm_cuda_error_string)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    ds = sbm_graph(n_per_class=6573, num_classes=3, p_in=0.0006,
                   p_out=0.00002, feat_dim=128, seed=0)
    rmat_host = rmat_graph(15, 8, seed=0)
    graphs = {"sbm": Adjacency.from_csr(ds.csr, device=dev),
              "rmat15": Adjacency.from_csr(rmat_host, device=dev)}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def old_vjp(colptr, rids, B, out, g, ties):
        """The earlier wrapper: the fold, then the one-warp-a-column
        kernel."""
        gt = g.to(torch.float32) / torch.clamp(ties, min=1.0)
        n, K = colptr.shape[0] - 1, B.shape[1]
        grad_B = torch.empty(n, K, device=dev)
        err = old(n, K, rids.shape[0], lane_vector(K, B, out, gt, grad_B),
                  colptr.data_ptr(), rids.data_ptr(), None, B.data_ptr(),
                  out.data_ptr(), gt.data_ptr(), grad_B.data_ptr(), None,
                  stream())
        assert err == 0, err
        return grad_B

    def patched(call, **attrs):
        """``call`` with attributes of the wrapper module replaced."""
        def run():
            saved = {k: getattr(kmm, k) for k in attrs}
            for k, v in attrs.items():
                setattr(kmm, k, v)
            try:
                return call()
            finally:
                for k, v in saved.items():
                    setattr(kmm, k, v)
        return run

    def ab(label, first, second, names):
        """Time first, second, second, first; the outputs' difference."""
        x, y = first(), second()
        diff = float((x.double() - y.double()).abs().max()) / max(
            float(y.double().abs().max()), 1.0)
        t = [timing.device_time(f) * 1e6
             for f in (first, second, second, first)]
        row = {"shape": label, names[0] + "_us": [t[0], t[3]],
               names[1] + "_us": [t[1], t[2]], "rel_diff": diff,
               "card": card}
        rows.append(row)
        print(f"{label}: {names[0]} {t[0]:.2f}, {t[3]:.2f} us | {names[1]} "
              f"{t[1]:.2f}, {t[2]:.2f} us | {(t[0] + t[3]) / (t[1] + t[2]):.2f}"
              f"x | outputs differ by {diff:.2e} of max(|{names[1]}|, 1) | "
              f"{card}", flush=True)

    tables = {}
    for graph, K in SHAPES:
        a = graphs[graph]
        B = torch.relu(torch.randn(a.shape[1], K, device=dev, generator=gen))
        g = torch.randn(a.shape[0], K, device=dev, generator=gen)
        out, ties = kmm.spmm_minmax(a.csr.indptr, a.csr.indices, None, B,
                                    "max")
        tables[graph, K] = (a, B, out, g, ties)

        def new(a=a, B=B, out=out, g=g, ties=ties):
            return kmm.spmm_minmax_vjp(a.csc.indptr, a.csc.indices, None, B,
                                       out, g, ties, split=a.split_t)[0]

        ab(f"row 3 {graph} K={K}: old / new", lambda: old_vjp(
            a.csc.indptr, a.csc.indices, B, out, g, ties), new,
            ("old", "new"))
    # The sharded tier: rmat15 at P=4, the max forward's joint out and ties.
    hp = build_halo_partition(rmat_host, 4, device=dev)
    mesh = make_mesh(4, device=dev)
    K = 128
    B = torch.relu(torch.randn(4 * hp.cpp, K, device=dev, generator=gen))
    halo = make_exchange(hp, mesh)(B)
    out, ties = khalo.halo_spmm_stacked(
        hp.diag_indptr, hp.diag_indices, None, B, hp.halo_indptr,
        hp.halo_indices, None, halo, "max", split=hp.joint_split)
    g = torch.randn(4 * hp.rpp, K, device=dev, generator=gen)
    for blk, table, split, n_t, nnz in (
            ("diag", B, hp.diag_t_split, hp.cpp, hp.diag_nnz),
            ("halo", halo.reshape(-1, K), hp.halo_t_split, hp.halo_rows,
             hp.halo_nnz)):
        t_indptr = getattr(hp, f"{blk}_t_indptr")
        t_rows = getattr(hp, f"{blk}_t_rows")

        def old_shards(t_indptr=t_indptr, t_rows=t_rows, table=table,
                       n_t=n_t, nnz=nnz):
            r = lambda q: slice(q * hp.rpp, (q + 1) * hp.rpp)  # noqa: E731
            return torch.cat([old_vjp(
                t_indptr[q], t_rows[q, :nnz[q]],
                table[q * n_t:(q + 1) * n_t], out[r(q)], g[r(q)],
                ties[r(q)]) for q in range(4)])

        def stacked(t_indptr=t_indptr, t_rows=t_rows, table=table,
                    split=split):
            return kmm.spmm_minmax_vjp_stacked(t_indptr, t_rows, None, table,
                                               out, g, ties, split=split)[0]

        print(f"rmat15 P=4 {blk}^T: {split.split.num_segments} segments in "
              f"{split.split.num_long_rows} columns above L, longest column "
              f"{int((t_indptr[:, 1:] - t_indptr[:, :-1]).max())}",
              flush=True)
        ab(f"row 3 rmat15 P=4 {blk}^T K={K}: old a shard / new stacked",
           old_shards, stacked, ("old", "new"))
    # The lazy g/ties loads and the walker width, through this wrapper.
    for graph, K in SHAPES:
        a, B, out, g, ties = tables[graph, K]

        def call(a=a, B=B, out=out, g=g, ties=ties):
            return kmm.spmm_minmax_vjp(a.csc.indptr, a.csc.indices, None, B,
                                       out, g, ties, split=a.split_t)[0]

        ab(f"row 3 {graph} K={K}: eager / lazy g,ties loads", call,
           patched(call, _entry=lambda kind, dtype: lazy_entry),
           ("eager", "lazy"))
    for K in (16, 32):
        a = graphs["sbm"]
        B = torch.relu(torch.randn(a.shape[1], K, device=dev, generator=gen))
        g = torch.randn(a.shape[0], K, device=dev, generator=gen)
        out, ties = kmm.spmm_minmax(a.csr.indptr, a.csr.indices, None, B,
                                    "max")

        def call(a=a, B=B, out=out, g=g, ties=ties):
            return kmm.spmm_minmax_vjp(a.csc.indptr, a.csc.indices, None, B,
                                       out, g, ties, split=a.split_t)[0]

        warp = (lane_vector(K, B), 32)
        ab(f"row 3 sbm K={K}: (VEC, SW) {warp} / "
           f"{kmm.walk_shape(K, 1, B)}",
           patched(call, walk_shape=lambda *_, w=warp: w), call,
           ("warp", "chosen"))
    if args.variants:
        src = _build.CSRC_DIR.joinpath("spmm_minmax.cu").read_text()
        variants = variant_sources(src)

        def build_variant(item):
            i, (name, text) = item
            path = os.path.join(tmp, f"variant{i}.cu")
            with open(path, "w") as fh:
                fh.write(text)
            lib = nvcc_build(nvcc, with_csrc, path, path[:-3] + ".so")
            cdll = ctypes.CDLL(lib)
            fn = cdll.gespmm_spmm_minmax_vjp_f32
            fn.argtypes, fn.restype = lazy.argtypes, ctypes.c_int
            cdll.gespmm_cuda_error_string.restype = ctypes.c_char_p
            return name, (fn, cdll.gespmm_cuda_error_string)

        with ThreadPoolExecutor(len(variants)) as pool:
            entries = dict(pool.map(build_variant,
                                    enumerate(variants.items())))
        for graph, K in SHAPES:
            a, B, out, g, ties = tables[graph, K]

            def call(a=a, B=B, out=out, g=g, ties=ties):
                return kmm.spmm_minmax_vjp(a.csc.indptr, a.csc.indices, None,
                                           B, out, g, ties, split=a.split_t)[0]

            names = ["as it is", *entries]
            calls = {"as it is": call, **{n: patched(
                call, _entry=lambda kind, dtype, e=e: e)
                for n, e in entries.items()}}
            t = {n: [] for n in names}
            for n in names + names[::-1]:
                t[n].append(timing.device_time(calls[n]) * 1e6)
            rows.append({"shape": f"row 3 {graph} K={K} variants",
                         "us": t, "card": card})
            print(f"row 3 {graph} K={K} variants: " + " | ".join(
                f"{n} {x[0]:.2f}, {x[1]:.2f} us" for n, x in t.items())
                + f" | {card}", flush=True)
        a, B, out, g, ties = tables["sbm", 16]

        def call16():
            return kmm.spmm_minmax_vjp(a.csc.indptr, a.csc.indices, None, B,
                                       out, g, ties, split=a.split_t)[0]

        shapes = ((4, 4), (2, 8), (1, 16))
        t = {sh: [] for sh in shapes}
        for sh in shapes + shapes[::-1]:
            t[sh].append(timing.device_time(patched(
                call16, walk_shape=lambda *_, w=sh: w)) * 1e6)
        rows.append({"shape": "row 3 sbm K=16 walkers",
                     "us": {str(k): v for k, v in t.items()}, "card": card})
        print("row 3 sbm K=16 walkers (VEC, SW): " + " | ".join(
            f"{sh} {x[0]:.2f}, {x[1]:.2f} us" for sh, x in t.items())
            + f" | {card}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        sass_report((new_lib, csr_lib), args.sass, cuobjdump)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
