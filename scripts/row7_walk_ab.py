#!/usr/bin/env python3
"""Time the one-warp row walk of an earlier kernel row 7 against this
checkout's, on one CUDA card.

    python3 scripts/row7_walk_ab.py OLD_DIR

OLD_DIR holds an earlier ``halo_spmm.cu`` with the headers it includes, for
example the first port's, unpacked with
``git archive 1595ac2 gespmm_tpu_torch/csrc | tar -x -C OLD_DIR``.  Its
entry point must take one shard's blocks (the first port's signature:
``gespmm_halo_spmm_f32(m, K, vec, op, heads, d_indptr, d_indices, d_vals,
d_table, h_indptr, h_indices, h_vals, h_table, out, ties, stream)``).  Both
kernels walk each shard of rmat15 (scale 15, edge factor 8) cut into P = 4
row slabs, binary sum at K = 128, one launch a shard and no split, so every
row is walked by one warp and shard 0's launch waits on its hub row.
Prints each shard's device time (old, new, new, old), its longest row and
the microseconds an edge of that row, and the card's name and power limit.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(old_dir):
    sys.path.insert(0, HERE)
    import torch
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import halo_spmm as khalo
    from gespmm_tpu_torch.parallel import build_halo_partition, make_mesh
    from gespmm_tpu_torch.parallel.halo import make_exchange
    from gespmm_tpu_torch.utils import timing
    from gespmm_tpu_torch.utils.datasets import rmat_graph

    src = os.path.join(old_dir, "gespmm_tpu_torch", "csrc", "halo_spmm.cu")
    if not os.path.exists(src):
        src = os.path.join(old_dir, "halo_spmm.cu")
    lib = os.path.join(tempfile.mkdtemp(), "libhalo_old.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    old = ctypes.CDLL(lib).gespmm_halo_spmm_f32
    old.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 11
    old.restype = ctypes.c_int
    dev = torch.device("cuda")
    hp = build_halo_partition(rmat_graph(15, 8, seed=0), 4, device=dev)
    K = 128
    B = torch.randn(4 * hp.cpp, K, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    halo = make_exchange(hp, make_mesh(4, device=dev))(B)
    for p in range(4):
        blk = hp.blocks(p)
        Bs, hb = B[p * hp.cpp:(p + 1) * hp.cpp], halo[p]
        out = torch.empty(hp.rpp, K, device=dev)

        def run_old():
            err = old(hp.rpp, K, 4, 0, 0, blk.d_indptr.data_ptr(),
                      blk.d_indices.data_ptr(), None, Bs.data_ptr(),
                      blk.h_indptr.data_ptr(), blk.h_indices.data_ptr(),
                      None, hb.data_ptr(), out.data_ptr(), None,
                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"old kernel: CUDA error {err}")
            return out

        def run_new():
            return khalo.halo_spmm_rows(blk.d_indptr, blk.d_indices, None,
                                        Bs, blk.h_indptr, blk.h_indices, None,
                                        hb)[0]

        diff = float((run_old().clone() - run_new()).abs().max())
        ms = [timing.device_time(f) * 1e3
              for f in (run_old, run_new, run_new, run_old)]
        longest = int((torch.diff(blk.d_indptr)
                       + torch.diff(blk.h_indptr)).max())
        old_ms, new_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        print(f"shard {p}: old {ms[0]:.5f} {ms[3]:.5f} ms, new {ms[1]:.5f} "
              f"{ms[2]:.5f} ms | longest row {longest}: old "
              f"{old_ms * 1e3 / longest:.4f}, new "
              f"{new_ms * 1e3 / longest:.4f} us an edge | max |old - new| "
              f"{diff:.3e}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
