#!/usr/bin/env python3
"""Time an earlier build of kernel row 1 (the CSR sum SpMM) against this
checkout's, on one CUDA card, and this checkout's source at two other walker
shapes.

    python3 scripts/row1_ab.py OLD_DIR [--graphs rmat15 products]
        [--pairs N] [--products-seed N] [--json PATH]

OLD_DIR holds an earlier checkout, for example the tree before the slab
groups, unpacked with ``git archive a67042f | tar -x -C OLD_DIR``.  Its
``gespmm_spmm_csr_f32(m, K, vec, L, S, J, indptr, indices, vals, seg_row,
seg_start, long_rows, seg_ptr, B, out, partial, stream)`` walks one slab of
32·VEC columns a warp, at that checkout's lane vector (``lane_vector``: 4 at
K >= 128, 2 at K >= 64, else 1); this checkout's is called through its
wrapper (``spmm_csr``, the (VEC, SW, NS) ``csr_shape`` picks).

Graphs: rmat15 (scale 15, edge factor 8; a hub row of 3,866 edges) and the
products cells' graph (``gnnbench/graphgen.py``'s ``powerlaw`` traffic from
``--products-seed``, with self-loops as the GCN cell has it: 2,449,029
nodes, 126,167,309 nonzeros), each over its CSR and its CSC with the
adjacency's row splits, at K = 47, 100 and 256 (the widths of the GCN and
SAGE cells' SpMMs).  At each shape the two builds' outputs are compared bit
for bit, binary and with random values, and the binary call (the cells'
call) is timed in the order old, new, new, old (device time behind a spin
kernel: 50 calls a group, 5 on the products graph), ``--pairs`` times.
Then this checkout's source, built with two more entry points, at the same
shapes against the chosen one, in the order other, chosen, chosen, other:
  * K = 256: one walk of two slabs on whole warps (VEC 4, SW 32, NS 2)
    against two walks of one;
  * K = 47: whole warps holding two slabs (VEC 1, SW 32, NS 2, 47 of 64
    lanes busy) against 16-lane walkers holding three (two rows a warp, 47
    of 48 lanes busy).
Each line gives the call's gathered bytes (nnz · K · 4) over its time.
Prints the card's name and power limit, and the registers of this
checkout's f32 row-1 kernels and the two others (``cuobjdump -res-usage``);
``--json`` also writes the rows there.
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
KS = (47, 100, 256)
# Entry points of the other walker shapes, compiled into one unit with this
# checkout's spmm_csr.cu: (name, K, VEC, SW, NS).
OTHERS = (("row1_vec4_ns2_f32", 256, 4, 32, 2),
          ("row1_sw32_ns2_f32", 47, 1, 32, 2))
OTHER_ENTRY = """
extern "C" int {name}(int m, int K, int L, int S, int J, const int* indptr,
                      const int* indices, const float* vals,
                      const int* seg_row, const int* seg_start,
                      const int* long_rows, const int* seg_ptr,
                      const void* B, void* out, float* partial,
                      void* stream) {{
  const Call<float, float> a{{m, K, L, S, J, indptr, indices, vals, seg_row,
                             seg_start, long_rows, seg_ptr, (const float*)B,
                             (float*)out, partial, (cudaStream_t)stream}};
  return (int)launch_shape<float, float, {vec}, {sw}, {ns}>(a);
}}
"""


def build(nvcc, flags, units):
    """Build each (source path, include dir) of ``units`` in parallel; the
    loaded libraries."""
    tmp = tempfile.mkdtemp()
    libs = [os.path.join(tmp, f"lib{i}.so") for i in range(len(units))]
    procs = [subprocess.Popen([nvcc, *flags, "-I", inc, "-o", lib, src])
             for (src, inc), lib in zip(units, libs)]
    for p in procs:
        if p.wait():
            raise RuntimeError(f"nvcc failed: {p.args}")
    return libs


def registers(lib_path, cuobjdump):
    """(kernel's template arguments, resource line) of each f32 row-1
    kernel of the library."""
    usage = subprocess.run([cuobjdump, "-res-usage", lib_path],
                           capture_output=True, text=True, check=True).stdout
    out, name = [], None
    for line in usage.splitlines():
        if line.strip().startswith("Function"):
            name = line.strip().split()[-1].rstrip(":")
        elif name and "REG:" in line:
            m = re.search(r"spmm_csr_kernelIffLi(\d)ELi(\d+)ELi(\d)ELb(\d)"
                          r"ELb(\d)E", name)
            if m:
                vec, sw, ns, vals, split = m.groups()
                out.append((f"VEC={vec} SW={sw} NS={ns} vals={vals} "
                            f"split={split}", line.strip()))
            name = None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("--graphs", nargs="+", default=["rmat15", "products"],
                    help="rmat15 and/or products")
    ap.add_argument("--pairs", type=int, default=2,
                    help="old/new groups a shape")
    ap.add_argument("--products-seed", type=int, default=2400000011,
                    help="seed of the products graph")
    ap.add_argument("--json", default="", help="also write the rows here")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import spmm_csr as kspmm
    from gespmm_tpu_torch.ops.spmm import Adjacency
    from gespmm_tpu_torch.sparse.formats import CSR
    from gespmm_tpu_torch.utils import timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph
    from gnnbench import graphgen

    if not torch.cuda.is_available():
        print("row1_ab: needs a CUDA card", file=sys.stderr)
        return 2
    nvcc = _build._nvcc()
    old_csrc = os.path.join(args.old_dir, "gespmm_tpu_torch", "csrc")
    if not os.path.isdir(old_csrc):
        old_csrc = args.old_dir
    new_csrc = str(_build.CSRC_DIR)
    others_src = os.path.join(tempfile.mkdtemp(), "row1_others.cu")
    with open(others_src, "w") as fh:
        fh.write(f'#include "{os.path.join(new_csrc, "spmm_csr.cu")}"\n'
                 + "".join(OTHER_ENTRY.format(name=n, vec=v, sw=w, ns=s)
                           for n, _, v, w, s in OTHERS))
    old_lib, others_lib = build(
        nvcc, _build.NVCC_FLAGS,
        [(os.path.join(old_csrc, "spmm_csr.cu"), old_csrc),
         (others_src, new_csrc)])
    _build.build("spmm_csr")
    i, p = ctypes.c_int, ctypes.c_void_p
    old = ctypes.CDLL(old_lib).gespmm_spmm_csr_f32
    old.argtypes, old.restype = [i] * 6 + [p] * 11, ctypes.c_int
    cdll = ctypes.CDLL(others_lib)
    others = {}
    for name, K, vec, sw, ns in OTHERS:
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = [i] * 5 + [p] * 11, ctypes.c_int
        others[K] = (fn, (vec, sw, ns))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def graph(name):
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
    for gname in args.graphs:
        torch.cuda.empty_cache()
        a = graph(gname)
        iters = 5 if gname == "products" else 50
        vals = torch.randn(a.nnz, device=dev, generator=gen)
        for direction, indptr, indices, split in (
                ("csr", a.csr.indptr, a.csr.indices, a.split),
                ("csc", a.csc.indptr, a.csc.indices, a.split_t)):
            m, nnz = indptr.shape[0] - 1, int(indices.shape[0])
            S, J = split.num_segments, split.num_long_rows
            ptrs = [split.seg_len, S, J, indptr.data_ptr(),
                    indices.data_ptr()]
            tail = [getattr(split, n).data_ptr() for n in kspmm._SPLIT]
            for K in KS:
                n_in = a.shape[1] if direction == "csr" else a.shape[0]
                B = torch.randn(n_in, K, device=dev, generator=gen)

                def raw(fn, shape, data):
                    """One call of a raw entry point: the old one with its
                    lane vector (shape None), or another walker shape."""
                    out = torch.empty(m, K, device=dev)
                    part = torch.empty(S, K, device=dev) if S else None
                    d = None if data is None else data.data_ptr()
                    head = ([m, K, kspmm.lane_vector(
                        K, B, out, *(() if part is None else (part,)))]
                        if shape is None else [m, K])
                    err = fn(*head, *ptrs, d, *tail, B.data_ptr(),
                             out.data_ptr(),
                             None if part is None else part.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
                    assert err == 0, (direction, K, shape, err)
                    return out

                def new(data=None):
                    return kspmm.spmm_csr(indptr, indices, data, B,
                                          split=split)

                shape = kspmm.csr_shape(K, B)
                kspmm.reset_launches()
                new()
                walks = kspmm.edge_walks
                same = all(torch.equal(new(d), raw(old, None, d))
                           for d in (None, vals))
                gb = nnz * K * 4 / 1e9
                label = f"{gname} {direction} K={K}"
                for _ in range(args.pairs):
                    t = [timing.device_time(f, iters=iters) * 1e3 for f in (
                        lambda: raw(old, None, None), new, new,
                        lambda: raw(old, None, None))]
                    rows.append({"shape": label, "vec_sw_ns": list(shape),
                                 "edge_walks": walks, "old_ms": [t[0], t[3]],
                                 "new_ms": [t[1], t[2]], "gathered_gb": gb,
                                 "bitwise_equal": same, "card": card})
                    ratio = (t[0] + t[3]) / (t[1] + t[2])
                    print(f"{label}: (VEC, SW, NS) {shape}, edge walks "
                          f"{walks} | old {t[0]:.4f}, {t[3]:.4f} ms | new "
                          f"{t[1]:.4f}, {t[2]:.4f} ms | {ratio:.3f}x | new "
                          f"{2 * gb / (t[1] + t[2]):.3f} TB/s, old "
                          f"{2 * gb / (t[0] + t[3]):.3f} TB/s | outputs "
                          f"{'bitwise equal' if same else 'DIFFER'} | {card}",
                          flush=True)
                if K not in others:
                    continue
                fn, oshape = others[K]
                same = all(torch.equal(new(d), raw(fn, oshape, d))
                           for d in (None, vals))
                for _ in range(args.pairs):
                    t = [timing.device_time(f, iters=iters) * 1e3 for f in (
                        lambda: raw(fn, oshape, None), new, new,
                        lambda: raw(fn, oshape, None))]
                    rows.append({"shape": label, "other_vec_sw_ns":
                                 list(oshape), "other_ms": [t[0], t[3]],
                                 "chosen_ms": [t[1], t[2]],
                                 "gathered_gb": gb, "bitwise_equal": same,
                                 "card": card})
                    ratio = (t[0] + t[3]) / (t[1] + t[2])
                    print(f"{label}: (VEC, SW, NS) {oshape} {t[0]:.4f}, "
                          f"{t[3]:.4f} ms | chosen {shape} {t[1]:.4f}, "
                          f"{t[2]:.4f} ms | {ratio:.3f}x | outputs "
                          f"{'bitwise equal' if same else 'DIFFER'} | {card}",
                          flush=True)
                del B
        del a, vals
    # The others' unit holds the source's own kernels too.
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    for tag, line in registers(others_lib, cuobjdump):
        print(f"resources spmm_csr_kernel f32 {tag}: {line}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rows, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
