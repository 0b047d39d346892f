#!/usr/bin/env python3
"""Time an earlier build of kernel row 6 (the fused dot-product attention
kernels) against this checkout's, on one CUDA card, and A/B this
checkout's choices.

    python3 scripts/row6_ab.py OLD_DIR [--variants] [--json PATH]

OLD_DIR holds an earlier checkout (``git archive 24d878a | tar -x -C
OLD_DIR``) whose ``csrc/dot_attention.cu`` walks one CSR row (CSC column) a
warp, each lane taking its own edge's dots serially, with the entry points
``gespmm_dot_fwd_f32(m, K, Ka, vec, leaky, slope, vec4, ...)``,
``gespmm_dot_bwd_rows_f32`` and ``gespmm_dot_bwd_cols_f32(n, K, Ka, vb, vd,
...)``; they are called as that checkout's wrapper called them (lane
vectors from ``lane_vector``, vec4 where Ka % 4 == 0).  This checkout's
kernels take the adjacency's splits (``Adjacency.split``/``split_t``).
Shapes (f32, act identity): the SBM graph with self-loops (pubmed scale) at
(Ka, K) = (64, 64) and (16, 3), and rmat15 (edge factor 8: hub rows and
columns of 3,866 edges, 11,708 empty rows) at (64, 64).  Each kernel is
timed in the order old, new, new, old (device time, 50 calls a group behind
a spin kernel), its outputs compared (max |new - old|); beside it the plain
version (10 calls a group), the bound (``profiling.dot_attention_work``
over 3.35 TB/s), its carries a call, and for the forward
``scaled_dot_product_attention`` with the adjacency as a dense boolean
mask, compared with the kernel on the rows that have an edge (SDPA gives
NaN on an empty row; the rmat15 mask is 32,768² bytes, 1.07 GB).

With ``--variants``: this source rebuilt with one choice changed (a text
edit of ``csrc/dot_attention.cu``), each timed through the wrapper at every
shape in the order listed, then reversed: walker-wide dots at every lane
vector (this source takes lane-serial dots at VEC = 1), lane-serial dots at
every lane vector (each lane takes its own edge's dots, the first port's
arithmetic, inside the same split walk; over the CSR the D2 rows are
gathered again to accumulate grad_D1), each kernel's batch depth (the edges
whose rows are gathered before a fold; this source takes 4, 2 and 2), and
the forward's registers left to the compiler or bounded for two blocks of
256 threads an SM (this source bounds them for three).

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
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("dot_fwd", "dot_bwd_rows", "dot_bwd_cols")
WIDE = "constexpr bool kLaneDots = VEC == 1;"
FWD = "constexpr int kFwdBatch = 4;"
ROWS = "constexpr int kRowsBatch = 2;"
COLS = "constexpr int kColsBatch = 2;"
BOUND = "__launch_bounds__(kThreads, kFwdMinBlocks)"
# name: the (text, replacement) edits of this checkout's source.
VARIANTS = {"walker-wide dots": [(WIDE, "constexpr bool kLaneDots = false;")],
            "lane dots": [(WIDE, "constexpr bool kLaneDots = true;")],
            "fwd batch 2": [(FWD, "constexpr int kFwdBatch = 2;")],
            "fwd batch 8": [(FWD, "constexpr int kFwdBatch = 8;")],
            "rows batch 1": [(ROWS, "constexpr int kRowsBatch = 1;")],
            "rows batch 4": [(ROWS, "constexpr int kRowsBatch = 4;")],
            "cols batch 1": [(COLS, "constexpr int kColsBatch = 1;")],
            "cols batch 4": [(COLS, "constexpr int kColsBatch = 4;")],
            "fwd unbounded": [(BOUND, "__launch_bounds__(kThreads)")],
            "fwd two blocks an SM": [(BOUND, "__launch_bounds__(kThreads, 2)")]}


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
    import torch
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import gat_fused as kgat
    from gespmm_tpu_torch.kernels.spmm_csr import lane_vector
    from gespmm_tpu_torch.ops import reference as ref
    from gespmm_tpu_torch.ops.graph import add_self_loops
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.utils import profiling, timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph, sbm_graph

    if not torch.cuda.is_available():
        print("row6_ab: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS
    tmp = tempfile.mkdtemp()
    src = str(_build.CSRC_DIR / "dot_attention.cu")
    old_src = os.path.join(args.old_dir, "gespmm_tpu_torch", "csrc",
                           "dot_attention.cu")

    def build(item):
        k, (name, (path, edits)) = item
        if edits:
            text = open(path).read()
            for a, b in edits:
                assert text.count(a) == 1, (name, a)
                text = text.replace(a, b)
            path = os.path.join(tmp, f"dot{k}.cu")
            with open(path, "w") as fh:
                fh.write(text)
        out = os.path.join(tmp, f"libdot{k}.so")
        subprocess.run([nvcc, *flags, "-I", str(_build.CSRC_DIR), "-o", out,
                        path], check=True)
        return name, ctypes.CDLL(out)

    libs = {"old": (old_src, [])}
    if args.variants:
        libs.update({n: (src, edits) for n, edits in VARIANTS.items()})
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        new_job = pool.submit(_build.build, "dot_attention")
        built = dict(pool.map(build, enumerate(libs.items())))
        new_job.result()
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    old = built.pop("old")
    old_fns = {}
    for kind, argtypes in (("fwd", [i] * 5 + [f, i] + [p] * 9),
                           ("bwd_rows", [i] * 5 + [f, i] + [p] * 11),
                           ("bwd_cols", [i] * 6 + [f, i] + [p] * 12)):
        fn = getattr(old, f"gespmm_dot_{kind}_f32")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        old_fns[kind] = fn

    def entries(cdll):
        """_dot_entry for a rebuilt library (the wrapper's argtypes)."""
        head = [i] * 6 + [f] + [i] * 3 + [p] * 4
        out = {}
        for kind, more in (("fwd", 12), ("bwd_rows", 12), ("bwd_cols", 14)):
            fn = getattr(cdll, f"gespmm_dot_{kind}_f32")
            fn.argtypes, fn.restype = head + [p] * more, ctypes.c_int
            out[kind] = fn
        cdll.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
        cdll.gespmm_cuda_error_string.restype = ctypes.c_char_p
        return lambda kind, dtype, o=out: (o[kind],
                                           cdll.gespmm_cuda_error_string)

    variant_entries = {n: entries(c) for n, c in built.items()}
    card = card_name()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sbm = sbm_graph(n_per_class=6573, num_classes=3, p_in=0.0006,
                    p_out=0.00002, feat_dim=128, seed=0)
    graphs = {"sbm": Adjacency.from_csr(add_self_loops(sbm.csr), device=dev),
              "rmat15": Adjacency.from_csr(rmat_graph(15, 8, seed=0),
                                           device=dev)}
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    rows = []

    def patched(call, entry):
        def run():
            saved = kgat._dot_entry
            kgat._dot_entry = entry
            try:
                return call()
            finally:
                kgat._dot_entry = saved
        return run

    for graph, Ka, K in (("sbm", 64, 64), ("sbm", 16, 3), ("rmat15", 64, 64)):
        a = graphs[graph]
        m, n = a.shape
        D1 = torch.randn(m, Ka, device=dev, generator=gen) * Ka ** -0.25
        D2 = torch.randn(n, Ka, device=dev, generator=gen) * Ka ** -0.25
        B = torch.randn(n, K, device=dev, generator=gen)
        g = torch.randn(m, K, device=dev, generator=gen)
        out, mx, den = kgat.dot_forward(a.csr.indptr, a.csr.indices, D1, D2, B,
                                        split=a.split)
        tabs = (D1, D2, B, g, mx, den, ref.dot_row_dot(g, out))
        edges = (a.rows, a.csr.indices)
        vec4 = int(Ka % 4 == 0)

        def old_fwd():
            o = torch.empty(m, K, device=dev)
            x, d = torch.empty(m, device=dev), torch.empty(m, device=dev)
            assert old_fns["fwd"](m, K, Ka, lane_vector(K, B, o), 0, 0.0, vec4,
                                  a.csr.indptr.data_ptr(),
                                  a.csr.indices.data_ptr(), D1.data_ptr(),
                                  D2.data_ptr(), B.data_ptr(), o.data_ptr(),
                                  x.data_ptr(), d.data_ptr(), stream()) == 0
            return o

        def old_rows():
            o = torch.empty(m, Ka, device=dev)
            assert old_fns["bwd_rows"](
                m, K, Ka, lane_vector(Ka, D2, o), 0, 0.0, vec4,
                a.csr.indptr.data_ptr(), a.csr.indices.data_ptr(),
                *(t.data_ptr() for t in tabs), o.data_ptr(), stream()) == 0
            return o

        def old_cols():
            oD = torch.empty(n, Ka, device=dev)
            oB = torch.empty(n, K, device=dev)
            assert old_fns["bwd_cols"](
                n, K, Ka, lane_vector(K, g, oB), lane_vector(Ka, D1, oD), 0,
                0.0, vec4, a.csc.indptr.data_ptr(), a.csc.indices.data_ptr(),
                *(t.data_ptr() for t in tabs), oB.data_ptr(), oD.data_ptr(),
                stream()) == 0
            return oD, oB

        calls = {
            "dot_fwd": (old_fwd,
                        lambda: kgat.dot_forward(a.csr.indptr, a.csr.indices,
                                                 D1, D2, B, split=a.split)[0],
                        lambda: ref.dot_attention_rows(*edges, D1, D2, B,
                                                       m)[0]),
            "dot_bwd_rows": (old_rows,
                             lambda: kgat.dot_backward_rows(
                                 a.csr.indptr, a.csr.indices, *tabs,
                                 split=a.split),
                             lambda: ref.dot_attention_vjp_rows(*edges, *tabs,
                                                                m)),
            "dot_bwd_cols": (old_cols,
                             lambda: kgat.dot_backward_cols(
                                 a.csc.indptr, a.csc.indices, *tabs,
                                 split=a.split_t),
                             lambda: ref.dot_attention_vjp_cols(*edges,
                                                                *tabs))}
        shape = f"{graph} Ka={Ka} K={K}"
        for kind in KINDS:
            first, second, plain = calls[kind]
            carry = {"dot_fwd": "dot_carry_launches",
                     "dot_bwd_rows": "dot_bwd_rows_carry_launches",
                     "dot_bwd_cols": "dot_bwd_cols_carry_launches"}[kind]
            before = getattr(kgat, carry)
            x, y = first(), second()
            carries = getattr(kgat, carry) - before
            diff = max_diff(x, y)
            t = [timing.device_time(fn) * 1e6
                 for fn in (first, second, second, first)]
            plain_us = timing.device_time(plain, iters=10) * 1e6
            nbytes, ops = profiling.dot_attention_work(kind, m, n, a.nnz, K,
                                                       Ka)
            bound_us = profiling.bound(nbytes, ops)[0] * 1e6
            row = {"kernel": kind, "shape": shape, "old_us": [t[0], t[3]],
                   "new_us": [t[1], t[2]], "max_abs_diff": diff,
                   "plain_us": plain_us, "bound_us": bound_us,
                   "carries": carries, "card": card}
            if kind == "dot_fwd" and K == Ka:
                row["sdpa_us"] = sdpa_time(torch, timing, a, D1, D2, B, y)
            rows.append(row)
            more = (f" | SDPA {row['sdpa_us']:.2f}" if row.get("sdpa_us")
                    else "")
            print(f"{kind} {shape}: old {t[0]:.2f}, {t[3]:.2f} us | new "
                  f"{t[1]:.2f}, {t[2]:.2f} us | {(t[0] + t[3]) / (t[1] + t[2]):.2f}x"
                  f" | max |new - old| {diff:.2e} | plain {plain_us:.2f} | bound "
                  f"{bound_us:.2f} | carries {carries}{more} | {card}",
                  flush=True)
            if not variant_entries:
                continue
            names = ["as it is", *variant_entries]
            runs = {"as it is": second, **{
                nm: patched(second, e) for nm, e in variant_entries.items()}}
            want = second()
            diffs = {nm: max_diff(runs[nm](), want) for nm in names}
            tv = {nm: [] for nm in names}
            for nm in names + names[::-1]:
                tv[nm].append(timing.device_time(runs[nm]) * 1e6)
            rows.append({"kernel": kind, "shape": f"{shape} variants",
                         "us": tv, "max_abs_diff": diffs, "card": card})
            print(f"{kind} {shape} variants: " + " | ".join(
                f"{nm} {v[0]:.2f}, {v[1]:.2f} us" for nm, v in tv.items())
                + f" | max |variant - this| {max(diffs.values()):.2e} | "
                f"{card}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    print(card)
    return 0


def max_diff(x, y):
    """max |x - y| over the outputs of one call (a tensor or a tuple)."""
    xs, ys = ((x,), (y,)) if hasattr(x, "shape") else (x, y)
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


def sdpa_time(torch, timing, a, D1, D2, B, out):
    """Device µs of ``scaled_dot_product_attention`` with the adjacency as a
    dense mask, if it agrees with the kernel's ``out`` on the rows that have
    an edge (within 1e-3 of max |out|), else None."""
    m, n = a.shape
    mask = torch.zeros(m, n, dtype=torch.bool, device=D1.device)
    mask[a.rows.long(), a.csr.indices.long()] = True
    live = (a.csr.indptr[1:] > a.csr.indptr[:-1]).nonzero()[:, 0]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            D1[None, None], D2[None, None], B[None, None],
            attn_mask=mask[None, None], scale=1.0)[0, 0]

    got = call().index_select(0, live)
    want = out.index_select(0, live)
    err = float((got - want).abs().max())
    if not err <= 1e-3 * max(float(want.abs().max()), 1.0):
        print(f"SDPA disagrees with the kernel: {err:.3e}", flush=True)
        return None
    return timing.device_time(call, iters=10) * 1e6


if __name__ == "__main__":
    sys.exit(main())
