#!/usr/bin/env python3
"""Time an earlier build of kernel row 8 (the nnz-chunked SpMM) against this
checkout's, on one CUDA card, and A/B this checkout's choices.

    python3 scripts/row8_ab.py OLD_DIR [--variants] [--json PATH]

OLD_DIR holds an earlier checkout (``git archive 8f8c29d | tar -x -C
OLD_DIR``) whose ``gespmm_spmm_chunk_f32(C, J, K, vec, indptr, indices,
vals, chunk_start, chunk_count, row_lo, row_hi, head_slot, tail_slot,
cut_rows, cut_ptr, B, out, partial, stream)`` walks one chunk a warp, its
rows in turn; it is called as that checkout's wrapper called it (its lane
vector: 4 at K >= 128, 2 at K >= 64, else 1).  This checkout's
``spmm_pallas`` walks the plan's pieces, a walker a piece.  Shapes (f32):
the GCN slice's SBM graph with self-loops (pubmed scale, valued) at K=32,
and the sweep's rmat15 (``synth_graph("rmat15")``, edge factor 16, binary)
at K=128 and K=32, each at (R, E) = (64, 64) and (128, 256).  Each pair is
timed in the order old, new, new, old (device time, 50 calls a group behind
a spin kernel); the outputs are compared bit for bit (a piece is summed
edge by edge in order, as the old warp summed a row's part of its chunk).
Beside them, at the same shape: the CSR kernel (row 1, with the adjacency's
split), ``torch.sparse.mm`` (the library call), the bound (the function's
bytes, each input read once and each output written once, over 3.35 TB/s)
and the rate at which the new kernel and row 1 gather B rows (nnz * K * 4
bytes over their time: every edge reads its K-wide row, mostly from L2).

Then, through this checkout's wrapper: the walker ``walk_shape`` picks
against one warp a piece at the earlier lane vector (sbm K=32, rmat15 K=32),
in the order warp, chosen, chosen, warp.  With ``--variants``: this source
rebuilt with other batch depths (the B rows a walker gathers before it adds
any), timed through the wrapper at every shape in the order listed, then
reversed, each output compared bit for bit with this source's:
  * ``batch N``: N edges at every walker width, whatever the pieces
    (``kBatchOf`` and ``kTailOf`` replaced);
  * ``2; 1 on a whole warp``: the depths before they followed the pieces;
  * ``4, tail T``: at every width, whole batches of 4 edges and the rest of
    a round in batches of T (``walk_edges``'s TAIL);
  * ``4 on long pieces``: 4 edges on a piece of more than two rounds (2 SW
    edges), 2 (1 on a whole warp) on the others;
  * ``guarded N``: N edges, each gather under the round's end in place of
    the last edge loaded again; ``unroll 4``: one edge at a time under
    ``#pragma unroll 4`` (``scripts/walk_variants.py``).

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
SIZES = ((64, 64), (128, 256))
BATCH = "constexpr int kBatchOf = SW == 32 || DEEP ? 4 : 2;"
TAIL = "constexpr int kTailOf = SW == 32 ? 1 : kBatchOf<SW, DEEP>;"
WALK = """    walk_edges<T, VEC, SW, kBatchOf<SW, DEEP>, HAS_VALS, kTailOf<SW, DEEP>>(
        w, s, t, K, kk, indices, vals, B, sum);"""
LONG_WALK = """    if (t - s > 2 * SW)
      walk_edges<T, VEC, SW, 4, HAS_VALS>(w, s, t, K, kk, indices, vals, B,
                                          sum);
    else
      walk_edges<T, VEC, SW, SW == 32 ? 1 : 2, HAS_VALS>(
          w, s, t, K, kk, indices, vals, B, sum);"""


def nvcc_build(nvcc, flags, src, out):
    subprocess.run([nvcc, *flags, "-o", out, src], check=True)
    return out


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
                    help="also time rebuilt variants of this source")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import ctypes

    import torch
    import walk_variants
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import spmm_csr as kspmm
    from gespmm_tpu_torch.kernels import spmm_pallas as kpal
    from gespmm_tpu_torch.kernels.spmm_csr import lane_vector
    from gespmm_tpu_torch.ops.graph import add_self_loops
    from gespmm_tpu_torch.ops.interop import csr_to_torch_sparse
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.sparse.partition import WORK_LIST, build_spmm_plan
    from gespmm_tpu_torch.utils import profiling, timing
    from gespmm_tpu_torch.utils.datasets import sbm_graph, synth_graph

    if not torch.cuda.is_available():
        print("row8_ab: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    tmp = tempfile.mkdtemp()
    old_src = os.path.join(args.old_dir, "gespmm_tpu_torch", "csrc",
                           "spmm_chunk.cu")
    src = _build.CSRC_DIR.joinpath("spmm_chunk.cu").read_text()
    assert all(src.count(x) == 1 for x in (BATCH, TAIL, WALK))
    carry = _build.CSRC_DIR.joinpath("carry.cuh").read_text()

    def depth(batch, tail=None):
        text = src.replace(BATCH, f"constexpr int kBatchOf = {batch};")
        return text.replace(TAIL, f"constexpr int kTailOf = {tail or batch};")

    # name: (kernel source, carry.cuh in its place or None)
    variants = {}
    if args.variants:
        for n in (1, 2, 4):
            variants[f"batch {n}"] = (depth(n), None)
        variants["2; 1 on a whole warp"] = (depth("SW == 32 ? 1 : 2"), None)
        for tail in (2, 1):
            variants[f"4, tail {tail}"] = (depth(4, tail), None)
        variants["4 on long pieces"] = (src.replace(WALK, LONG_WALK), None)
        for n in (2, 4):
            variants[f"guarded {n}"] = (depth(n), walk_variants.guarded(carry))
        variants["unroll 4"] = (src, walk_variants.unrolled(carry))

    def build_variant(item):
        i, (name, (text, header)) = item
        path = os.path.join(tmp, f"variant{i}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        inc = (str(_build.CSRC_DIR) if header is None else
               walk_variants.with_header(str(_build.CSRC_DIR), header,
                                         os.path.join(tmp, f"inc{i}")))
        cdll = ctypes.CDLL(nvcc_build(nvcc, (*flags, "-I", inc), path,
                                      path[:-3] + ".so"))
        fn = cdll.gespmm_spmm_chunk_f32
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 11
        fn.restype = ctypes.c_int
        cdll.gespmm_cuda_error_string.restype = ctypes.c_char_p
        return name, (fn, cdll.gespmm_cuda_error_string)

    with ThreadPoolExecutor(min(3 + len(variants), 8)) as pool:
        old_job = pool.submit(nvcc_build, nvcc, flags, old_src,
                              os.path.join(tmp, "libchunk_old.so"))
        jobs = [pool.submit(_build.build, name)
                for name in ("spmm_chunk", "spmm_csr")]
        entries = dict(pool.map(build_variant, enumerate(variants.items())))
        old_lib = old_job.result()
        for j in jobs:
            j.result()
    old = ctypes.CDLL(old_lib).gespmm_spmm_chunk_f32
    old.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 15
    old.restype = ctypes.c_int
    card = card_name()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ds = sbm_graph(n_per_class=6573, num_classes=3, p_in=0.0006,
                   p_out=0.00002, feat_dim=128, seed=0)
    sbm_host = add_self_loops(ds.csr)
    sweep_host = synth_graph("rmat15", seed=0)
    graphs = {"sbm": (sbm_host, Adjacency.from_csr(sbm_host, device=dev)),
              "rmat15-ef16": (sweep_host,
                              Adjacency.from_csr(sweep_host, device=dev))}
    rows = []

    def old_chunk(plan, data, B, m):
        """The earlier wrapper: one warp a chunk."""
        K = B.shape[1]
        out = torch.empty(m, K, device=dev)
        J = int(plan.cut_rows.shape[0])
        partial = torch.empty(max(plan.num_slots, 1), K, device=dev)
        err = old(plan.num_chunks, J, K, lane_vector(K, B, out, partial),
                  plan.indptr.data_ptr(), plan.indices.data_ptr(),
                  None if data is None else data.data_ptr(),
                  *(getattr(plan, n).data_ptr() for n in WORK_LIST),
                  B.data_ptr(), out.data_ptr(), partial.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
        assert err == 0, err
        return out

    def patched(call, **attrs):
        """``call`` with attributes of the wrapper module replaced."""
        def run():
            saved = {k: getattr(kpal, k) for k in attrs}
            for k, v in attrs.items():
                setattr(kpal, k, v)
            try:
                return call()
            finally:
                for k, v in saved.items():
                    setattr(kpal, k, v)
        return run

    def ab(label, first, second, names, extra=None):
        """Time first, second, second, first; the outputs' difference."""
        x, y = first(), second()
        diff = float((x - y).abs().max())
        bitwise = torch.equal(x.view(torch.int32), y.view(torch.int32))
        t = [timing.device_time(f) * 1e6
             for f in (first, second, second, first)]
        extra = dict(extra or {})
        if "row1_gather_TBps" in extra:  # the same bytes in the new time
            extra["new_gather_TBps"] = (extra["row1_gather_TBps"]
                                        * extra["row1_us"] * 2 / (t[1] + t[2]))
        row = {"shape": label, names[0] + "_us": [t[0], t[3]],
               names[1] + "_us": [t[1], t[2]], "max_abs_diff": diff,
               "bitwise": bitwise, **extra, "card": card}
        rows.append(row)
        more = "".join(f" | {k} {v:.2f}" if isinstance(v, float) else
                       f" | {k} {v}" for k, v in extra.items())
        print(f"{label}: {names[0]} {t[0]:.2f}, {t[3]:.2f} us | {names[1]} "
              f"{t[1]:.2f}, {t[2]:.2f} us | {(t[0] + t[3]) / (t[1] + t[2]):.2f}"
              f"x | outputs {'bitwise equal' if bitwise else 'differ'} (max "
              f"{diff:.2e}){more} | {card}", flush=True)

    cases = []
    for graph, K in (("sbm", 32), ("rmat15-ef16", 128), ("rmat15-ef16", 32)):
        host, a = graphs[graph]
        m, n = a.shape
        B = torch.randn(n, K, device=dev, generator=gen)
        lib = csr_to_torch_sparse(host.to(dev))
        lib_us = timing.device_time(lambda: torch.sparse.mm(lib, B)) * 1e6
        row1_us = timing.device_time(lambda: kspmm.spmm_csr(
            a.csr.indptr, a.csr.indices, a.data, B, split=a.split)) * 1e6
        bound_us = profiling.bound(
            profiling.spmm_bytes(a.nnz, m, K, n, valued=a.data is not None),
            2 * a.nnz * K)[0] * 1e6
        gathered = a.nnz * K * 4  # bytes of the B rows the edges read
        for R, E in SIZES:
            plan = build_spmm_plan(host, rows_per_block=R, chunk_nnz=E).to(dev)

            def new(plan=plan, a=a, B=B, m=m):
                return kpal.spmm_pallas(plan, a.data, B, m)

            cases.append((f"{graph} K={K} (R, E)=({R}, {E})", new, K))
            print(f"{graph} K={K} (R, E)=({R}, {E}): {plan.num_chunks} chunks,"
                  f" {plan.num_pieces} pieces, {plan.cut_rows.numel()} cut "
                  f"rows, nnz {a.nnz}", flush=True)
            ab(f"row 8 {graph} K={K} (R, E)=({R}, {E}): old / new",
               lambda plan=plan, a=a, B=B, m=m: old_chunk(plan, a.data, B, m),
               new, ("old", "new"),
               {"row1_us": row1_us, "torch.sparse.mm_us": lib_us,
                "bound_us": bound_us, "pieces": plan.num_pieces,
                "chunks": plan.num_chunks,
                "row1_gather_TBps": gathered / row1_us / 1e6})
    for label, call, K in cases:
        if K != 32 or "(64, 64)" not in label:
            continue
        warp = (lane_vector(K, torch.empty(1, K, device=dev)), 32)
        ab(f"{label}: (VEC, SW) {warp} / chosen",
           patched(call, walk_shape=lambda *_, w=warp: w), call,
           ("warp", "chosen"))
    if variants:
        for label, call, K in cases:
            names = ["as it is", *entries]
            calls = {"as it is": call, **{n: patched(
                call, _entry=lambda dtype, e=e: e)
                for n, e in entries.items()}}
            want = call()
            same = {n: torch.equal(calls[n]().view(torch.int32),
                                   want.view(torch.int32)) for n in names}
            t = {n: [] for n in names}
            for n in names + names[::-1]:
                t[n].append(timing.device_time(calls[n]) * 1e6)
            rows.append({"shape": f"{label} variants", "us": t,
                         "bitwise": same, "card": card})
            print(f"row 8 {label} variants: " + " | ".join(
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
