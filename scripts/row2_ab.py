#!/usr/bin/env python3
"""Time an earlier build of kernel row 2 (the max/min SpMM forward) against
this checkout's, on one CUDA card, and take apart the earlier hub walk.

    python3 scripts/row2_ab.py OLD_DIR [--variants] [--pairs N] [--json PATH]

OLD_DIR holds an earlier checkout (``git archive 8f8c29d | tar -x -C
OLD_DIR``) whose ``gespmm_spmm_minmax_f32(m, K, vec, is_max, indptr,
indices, vals, B, out, ties, stream)`` walks one row a warp, no split; it is
called as that checkout's wrapper called it (its lane vector: 4 at K >= 128,
2 at K >= 64, else 1).  This checkout's ``spmm_minmax`` is called as the op
calls it, with the CSR's split.  Shapes (f32, binary, max, B relu'd as
SAGE-pool's pool layer gives it): the SAGE slice's SBM graph (pubmed scale,
no self-loops) at K=128 and K=16, and rmat15 (scale 15, edge factor 8) at
K=128.  Each pair is timed in the order old, new, new, old (device time, 50
calls a group behind a spin kernel), ``--pairs`` times at each shape (1 by
default); out and ties are compared bit for bit.

Then, at rmat15 K=128, the one-warp walks of the hub row of 3,866 edges
(why the earlier max forward took 22% longer than the earlier sum kernel,
unsplit, over the same edges), each against the earlier max forward:
  * the earlier max forward rebuilt without its ``if (active)`` branch (every
    lane loads, a lane past K at column 0);
  * the CSR sum kernel (row 1) without a split (one warp a row; its walk
    has loaded on every lane, without an ``if (active)`` branch, since it
    walks several K slabs at once);
  * this checkout's max forward without a split (one walker a row: the
    batched walk alone; built with the walker at S = 0, see below).
Then, through this checkout's wrapper, at sbm K=16 and K=128: the walker
``walk_shape`` picks against one warp a row at the earlier lane vector.
With ``--variants``: this source rebuilt, timed through the wrapper at
every shape in the order listed, then reversed, out and ties compared bit
for bit with this source's:
  * ``batch N``: the batch depth (1 and 2 edges against the forward's 4;
    ``kFwdBatch`` replaced);
  * ``4, tail T``: whole batches of 4 edges, the rest of a round in batches
    of T (``walk_edges``'s TAIL);
  * ``one kernel``: the split kernel launched also when the split has no
    segment, in place of the kernel built without the segment test (at
    K < 128);
  * ``walker at S = 0``: the walker kernel also for a launch of whole-warp
    walkers without segments, in place of the first port's kernel (K=128);
  * ``guarded 4``: each gather under the round's end in place of the last
    edge loaded again; ``unroll 4``: one edge at a time under ``#pragma
    unroll 4`` (``scripts/walk_variants.py``).

Prints one line a row and the card's name and power limit; ``--json`` also
writes the rows there.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("sbm", 128), ("sbm", 16), ("rmat15", 128))
BATCH = "constexpr int kFwdBatch = 4;"
WALK = "gespmm::walk_edges<T, VEC, SW, kFwdBatch, HAS_VALS>("
UNSPLIT = "spmm_minmax_kernel<T, VEC, SW, HAS_VALS, IS_MAX, false>"
ROW_KERNEL = "} else if constexpr (SW == 32) {"
# The gather behind `if (active)` in the earlier max forward, and the same
# load taken by every lane (column 0 past K).
OLD_MM_LOAD = """        if (active) {
          const P p = *reinterpret_cast<const P*>(B + (int64_t)cj * K + k);"""


def unbranched(src, load):
    assert src.count(load) == 1, load
    return src.replace(load, load.replace("if (active) {", "{").replace(
        "* K + k)", "* K + (active ? k : 0))"))


def nvcc_build(nvcc, flags, src, out):
    subprocess.run([nvcc, *flags, "-o", out, src], check=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("--json", default="", help="also write the rows here")
    ap.add_argument("--variants", action="store_true",
                    help="also time rebuilt variants of this source")
    ap.add_argument("--pairs", type=int, default=1,
                    help="old/new pairs timed at each shape")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import ctypes

    import torch
    import walk_variants
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import spmm_csr as kspmm
    from gespmm_tpu_torch.kernels import spmm_minmax as kmm
    from gespmm_tpu_torch.kernels.spmm_csr import lane_vector
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.sparse.partition import build_row_split
    from gespmm_tpu_torch.utils import profiling, timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph, sbm_graph

    if not torch.cuda.is_available():
        print("row2_ab: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    tmp = tempfile.mkdtemp()
    old_csrc = os.path.join(args.old_dir, "gespmm_tpu_torch", "csrc")
    new_csrc = str(_build.CSRC_DIR)
    old_src = open(os.path.join(old_csrc, "spmm_minmax.cu")).read()
    mm_src = _build.CSRC_DIR.joinpath("spmm_minmax.cu").read_text()
    assert all(mm_src.count(x) == 1
               for x in (BATCH, WALK, UNSPLIT, ROW_KERNEL))
    # (name, source, the csrc/ of its headers, entry) of each library.
    libs = [("old", old_src, old_csrc, "gespmm_spmm_minmax_f32"),
            ("old, no branch", unbranched(old_src, OLD_MM_LOAD), old_csrc,
             "gespmm_spmm_minmax_f32"),
            ("walker at S = 0", mm_src.replace(
                ROW_KERNEL, ROW_KERNEL.replace("SW == 32", "false")),
             new_csrc, "gespmm_spmm_minmax_f32")]
    if args.variants:
        libs += [(f"batch {n}", mm_src.replace(
            BATCH, f"constexpr int kFwdBatch = {n};"), new_csrc,
            "gespmm_spmm_minmax_f32") for n in (1, 2)]
        carry = _build.CSRC_DIR.joinpath("carry.cuh").read_text()

        def header(name, text):  # csrc/ with carry.cuh replaced
            return walk_variants.with_header(new_csrc, text,
                                             os.path.join(tmp, name))

        libs += [(f"4, tail {n}", mm_src.replace(
            WALK, WALK.replace("HAS_VALS>", f"HAS_VALS, {n}>")), new_csrc,
            "gespmm_spmm_minmax_f32") for n in (1, 2)]
        libs += [("one kernel", mm_src.replace(
            UNSPLIT, UNSPLIT.replace("false>", "true>")), new_csrc,
            "gespmm_spmm_minmax_f32")]
        libs += [(name, mm_src, header(name, fn(carry)),
                  "gespmm_spmm_minmax_f32")
                 for name, fn in (("guarded 4", walk_variants.guarded),
                                  ("unroll 4", walk_variants.unrolled))]

    def build(item):
        i, (name, text, csrc, entry) = item
        path = os.path.join(tmp, f"lib{i}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        cdll = ctypes.CDLL(nvcc_build(nvcc, (*flags, "-I", csrc), path,
                                      path[:-3] + ".so"))
        cdll.gespmm_cuda_error_string.restype = ctypes.c_char_p
        return name, (getattr(cdll, entry), cdll.gespmm_cuda_error_string)

    with ThreadPoolExecutor(min(len(libs) + 2, 8)) as pool:
        jobs = [pool.submit(_build.build, n) for n in ("spmm_minmax",
                                                       "spmm_csr")]
        built = dict(pool.map(build, enumerate(libs)))
        for j in jobs:
            j.result()
    i, p = ctypes.c_int, ctypes.c_void_p
    for name, (fn, _) in built.items():
        if name.startswith("old"):
            fn.argtypes, fn.restype = [i] * 4 + [p] * 7, ctypes.c_int
        else:
            fn.argtypes, fn.restype = [i] * 8 + [p] * 13, ctypes.c_int
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    ds = sbm_graph(n_per_class=6573, num_classes=3, p_in=0.0006,
                   p_out=0.00002, feat_dim=128, seed=0)
    graphs = {"sbm": Adjacency.from_csr(ds.csr, device=dev),
              "rmat15": Adjacency.from_csr(rmat_graph(15, 8, seed=0),
                                           device=dev)}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def old_fwd(fn, a, B):
        """The earlier wrapper: one warp a row."""
        m, K = a.shape[0], B.shape[1]
        out = torch.empty(m, K, device=dev)
        ties = torch.empty(m, K, device=dev)
        err = fn(m, K, lane_vector(K, B, out, ties), 1, a.csr.indptr.data_ptr(),
                 a.csr.indices.data_ptr(), None, B.data_ptr(), out.data_ptr(),
                 ties.data_ptr(), stream())
        assert err == 0, err
        return out, ties

    def patched(mod, call, **attrs):
        """``call`` with attributes of the wrapper module replaced."""
        def run():
            saved = {k: getattr(mod, k) for k in attrs}
            for k, v in attrs.items():
                setattr(mod, k, v)
            try:
                return call()
            finally:
                for k, v in saved.items():
                    setattr(mod, k, v)
        return run

    def ab(label, first, second, names, extra=None):
        """Time first, second, second, first; compare out (and ties)."""
        x, y = first(), second()
        x, y = (x, y) if isinstance(x, tuple) else ((x,), (y,))
        bitwise = all(torch.equal(u.view(torch.int32), v.view(torch.int32))
                      for u, v in zip(x, y))
        t = [timing.device_time(f) * 1e6
             for f in (first, second, second, first)]
        row = {"shape": label, names[0] + "_us": [t[0], t[3]],
               names[1] + "_us": [t[1], t[2]], "bitwise": bitwise,
               **(extra or {}), "card": card}
        rows.append(row)
        more = "".join(f" | {k} {v:.2f}" if isinstance(v, float) else
                       f" | {k} {v}" for k, v in (extra or {}).items())
        print(f"{label}: {names[0]} {t[0]:.2f}, {t[3]:.2f} us | {names[1]} "
              f"{t[1]:.2f}, {t[2]:.2f} us | {(t[0] + t[3]) / (t[1] + t[2]):.2f}"
              f"x | outputs {'bitwise equal' if bitwise else 'DIFFER'}{more} | "
              f"{card}", flush=True)

    tables = {}
    for graph, K in SHAPES:
        a = graphs[graph]
        m, n = a.shape
        B = torch.relu(torch.randn(n, K, device=dev, generator=gen))
        tables[graph, K] = (a, B)

        def new(a=a, B=B):
            return kmm.spmm_minmax(a.csr.indptr, a.csr.indices, None, B,
                                   "max", split=a.split)

        nbytes = (m + 1) * 4 + a.nnz * 4 + (n + 2 * m) * K * 4
        bound_us = profiling.bound(nbytes, 2 * a.nnz * K)[0] * 1e6
        row1_us = timing.device_time(lambda: kspmm.spmm_csr(
            a.csr.indptr, a.csr.indices, None, B, split=a.split)) * 1e6
        for _ in range(args.pairs):
            ab(f"row 2 {graph} K={K}: old / new",
               lambda a=a, B=B: old_fwd(built["old"][0], a, B), new,
               ("old", "new"), {"row1_us": row1_us, "bound_us": bound_us,
                                "bytes": nbytes,
                                "segments": a.split.num_segments})
    # The hub: one-warp walks at rmat15 K=128, each against the earlier
    # max forward.
    a, B = tables["rmat15", 128]
    whole = build_row_split(a.csr.indptr, 1 << 30).to(dev)  # no segment
    deg = a.csr.indptr[1:] - a.csr.indptr[:-1]
    print(f"rmat15: longest row {int(deg.max())} edges; "
          f"{a.split.num_long_rows} rows above L in "
          f"{a.split.num_segments} segments", flush=True)

    def old_max():
        return old_fwd(built["old"][0], a, B)

    def row1():
        return kspmm.spmm_csr(a.csr.indptr, a.csr.indices, None, B,
                              split=whole)

    ab("rmat15 K=128 hub walks: old max / old max without if (active)",
       old_max, lambda: old_fwd(built["old, no branch"][0], a, B),
       ("old max", "old max, no branch"))
    ab("rmat15 K=128 hub walks: old max / row 1 unsplit", old_max, row1,
       ("old max", "row 1 unsplit"))
    ab("rmat15 K=128 hub walks: old max / new max unsplit", old_max,
       patched(kmm, lambda: kmm.spmm_minmax(a.csr.indptr, a.csr.indices, None,
                                            B, "max", split=whole),
               _entry=lambda *_: built["walker at S = 0"]),
       ("old max", "new unsplit"))
    # The walker width through this wrapper.
    for graph, K in (("sbm", 16), ("sbm", 128)):
        a, B = tables[graph, K]

        def call(a=a, B=B):
            return kmm.spmm_minmax(a.csr.indptr, a.csr.indices, None, B,
                                   "max", split=a.split)

        warp = (lane_vector(K, B), 32)
        ab(f"row 2 {graph} K={K}: (VEC, SW) {warp} / "
           f"{kmm.walk_shape(K, 1, B)}",
           patched(kmm, call, walk_shape=lambda *_, w=warp: w), call,
           ("warp", "chosen"))
    if args.variants:
        entries = {n: e for n, e in built.items()
                   if not n.startswith(("old", "row 1"))}
        for graph, K in SHAPES:
            a, B = tables[graph, K]

            def call(a=a, B=B):
                return kmm.spmm_minmax(a.csr.indptr, a.csr.indices, None, B,
                                       "max", split=a.split)

            names = ["as it is", *entries]
            calls = {"as it is": call, **{n: patched(
                kmm, call, _entry=lambda kind, dtype, e=e: e)
                for n, e in entries.items()}}
            want = call()
            same = {n: all(torch.equal(u.view(torch.int32),
                                       v.view(torch.int32))
                           for u, v in zip(calls[n](), want)) for n in names}
            t = {n: [] for n in names}
            for n in names + names[::-1]:
                t[n].append(timing.device_time(calls[n]) * 1e6)
            rows.append({"shape": f"row 2 {graph} K={K} variants", "us": t,
                         "bitwise": same, "card": card})
            print(f"row 2 {graph} K={K} variants: " + " | ".join(
                f"{n} {x[0]:.2f}, {x[1]:.2f} us" for n, x in t.items())
                + f" | all bitwise equal: {all(same.values())} | {card}",
                flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
