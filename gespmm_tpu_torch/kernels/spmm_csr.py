"""Wrapper of the fused CSR SpMM kernel ``csrc/spmm_csr.cu``.

Counterpart of ``gespmm_tpu/kernels/spmm_stream.py::spmm_tiled`` (sum): the
TPU's gather + Pallas stream-reduce pair becomes one CUDA kernel.  Rows longer
than the split's L edges are walked in segments of L by separate warps, and a
carry pass adds each long row's segments in order (``sparse/partition.py::
build_row_split``; ``ops/spmm.py::Adjacency`` builds the split of the CSR and
of the CSC once, on the host).  A tensor on the CPU goes to the plain version
(``ops/reference.py::spmm_split_rows``, or ``spmm_rows`` without a long row);
a CUDA tensor launches the kernel or raises — there is no fallback.

``launches`` counts the main pass, ``carry_launches`` the carry pass (one
call is one launch of each, or of the main pass alone when no row is longer
than L), plain ints, so a run can show that its SpMMs went through the
kernel; ``edge_walks`` counts the main pass's walks of the edges,
ceil(slabs / NS) a launch for ``csr_shape``'s NS slabs a walker.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.formats import expand_indptr
from gespmm_tpu_torch.sparse.partition import RowSplit, build_row_split

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/spmm_csr.cu"
REPLACES = "gespmm_tpu/kernels/spmm_stream.py:232"

launches = 0
carry_launches = 0
edge_walks = 0

# (B dtype, out dtype) -> entry point.
_ENTRY = {(torch.float32, torch.float32): "gespmm_spmm_csr_f32",
          (torch.bfloat16, torch.bfloat16): "gespmm_spmm_csr_bf16",
          (torch.bfloat16, torch.float32): "gespmm_spmm_csr_bf16_f32"}
_SPLIT = ("seg_row", "seg_start", "long_rows", "seg_ptr")


def reset_launches() -> None:
    global launches, carry_launches, edge_walks
    launches = carry_launches = edge_walks = 0


@functools.lru_cache(maxsize=None)
def _entry(b_dtype: torch.dtype, out_dtype: torch.dtype):
    lib = load_library("spmm_csr")
    fn = getattr(lib, _ENTRY[(b_dtype, out_dtype)])
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i] * 8 + [p] * 11
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def spmm_csr(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
             B: Tensor, rows: Optional[Tensor] = None,
             split: Optional[RowSplit] = None,
             out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """out = A @ B for the CSR (indptr, indices, data); ``data=None`` is 1.0.

    Accumulates in f32; the output takes ``out_dtype``, by default B's
    (a bf16 B with an f32 out is the bf16 stream of ``mode="fast"``).
    ``split`` is the structure's row split on B's device
    (``Adjacency.split``); without one, a CUDA call builds it from a host
    copy of ``indptr``, which synchronises (set-up, not a timed call).
    ``rows`` (the expanded indptr) is used only by the plain version on the
    CPU.
    """
    out_dtype = B.dtype if out_dtype is None else out_dtype
    if B.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, indices.shape[0])
        Bp = B.to(out_dtype)  # bf16 -> f32 is exact
        m = indptr.shape[0] - 1
        if split is not None and split.num_segments:
            return reference.spmm_split_rows(
                rows, indptr, indices, data, Bp, m, split.seg_row,
                split.long_rows, split.seg_ptr, split.seg_len)
        return reference.spmm_rows(rows, indices, data, Bp, m)
    if split is None:
        split = build_row_split(indptr).to(B.device)
    return spmm_csr_cuda(indptr, indices, data, B, split, out_dtype)


def lane_vector(K: int, *tensors: Tensor) -> int:
    """Columns per lane for the kernels of ``csrc/``: 4 (16-byte f32 loads)
    for K % 4 == 0 and K >= 128, 2 for K % 2 == 0 and K >= 64, else 1, if
    every table is aligned to it; narrow K stays scalar so that all 32
    lanes have a column (K=32 -> one per lane)."""
    for vec, min_k in ((4, 128), (2, 64)):
        if K % vec == 0 and K >= min_k and all(
                t.data_ptr() % (vec * t.element_size()) == 0 for t in tensors):
            return vec
    return 1


def csr_shape(K: int, *tensors: Tensor):
    """(VEC, SW, NS) of row 1: walkers of SW lanes, VEC columns a lane,
    holding NS slabs of SW·VEC columns, so that a launch walks the edges
    ceil(slabs / NS) times.  ``lane_vector``'s VEC on whole warps, one slab,
    where that covers K; else one walk where VEC 4 on a warp (K <= 128,
    K % 4 == 0, every table aligned to it) or three slabs of VEC 1 on 16
    lanes (K <= 48) cover K (K = 100: VEC 4, 25 lanes; K = 47: 47 of 48
    lanes, two rows a warp); else ``lane_vector``'s VEC on whole warps, a
    walk a slab (K = 256: VEC 4, two walks)."""
    vec = lane_vector(K, *tensors)
    if K <= 32 * vec:
        return vec, 32, 1
    if K <= 128 and K % 4 == 0 and all(
            t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors):
        return 4, 32, 1
    if K <= 48:
        return 1, 16, 3
    return vec, 32, 1


def walk_shape(K: int, heads: int, *tensors: Tensor):
    """(VEC, SW) of the walker kernels (rows 2, 3, 5 and 8): VEC columns a
    lane, the widest of 4, 2 and 1 that divides the head width (a lane's
    columns lie in one head) and to which every table is aligned; SW lanes
    a walker, the smallest power of two that covers K/VEC columns, from 4
    (eight rows a warp) to 32 (one; wider K walks 32·VEC-column slabs)."""
    dh = K // heads
    vec = next(v for v in (4, 2, 1) if dh % v == 0 and all(
        t.data_ptr() % (v * t.element_size()) == 0 for t in tensors))
    lanes = -(-K // vec)
    return vec, min(32, max(4, 1 << (lanes - 1).bit_length()))


def check_operands(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
                   B: Tensor) -> None:
    """Raise on a sparse operand or a dense ``B`` that the kernels of
    ``csrc/`` do not take (shared by every wrapper)."""
    if B.device.type != "cuda":
        raise ValueError(f"B must be a CUDA tensor, got device {B.device}")
    if B.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"B must be float32 or bfloat16, got {B.dtype}")
    if B.dim() != 2 or not B.is_contiguous():
        raise ValueError(f"B must be a contiguous 2-D tensor, got {tuple(B.shape)}")
    nnz = indices.shape[0]
    if nnz >= 2**31:
        raise ValueError(f"nnz={nnz} needs 64-bit indices; the kernel is int32")
    named = [("indptr", indptr), ("indices", indices)]
    if data is not None:
        named.append(("data", data))
    for name, t in named:
        if t.device != B.device:
            raise ValueError(f"{name} is on {t.device}, B on {B.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    for name, t in named[:2]:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if data is not None:
        if data.shape[0] != nnz:
            raise ValueError(f"data has {data.shape[0]} values for {nnz} nonzeros")
        if not data.is_floating_point():
            raise TypeError(f"data must be floating point, got {data.dtype}")


def check_table(name: str, t: Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``shape`` tensor of ``dtype`` on
    ``device`` (the dense side tables of the kernels of ``csrc/``)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, B on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor, "
                         f"got {tuple(t.shape)}")


def check_split(split: RowSplit, device) -> None:
    """Raise unless every list of the row split is a contiguous int32
    tensor on ``device`` (the split kernels of ``csrc/``)."""
    for name in _SPLIT:
        t = getattr(split, name)
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"split.{name} must be a contiguous int32 tensor "
                             f"on {device} (RowSplit.to)")


def raise_on(err: int, err_str, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")


def spmm_csr_cuda(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
                  B: Tensor, split: RowSplit,
                  out_dtype: torch.dtype) -> Tensor:
    """Launch the main pass, then the carry pass when the split has a long
    row, on the current stream of B's device."""
    global launches, carry_launches, edge_walks
    check_operands(indptr, indices, data, B)
    if (B.dtype, out_dtype) not in _ENTRY:
        raise TypeError(f"no kernel for B {B.dtype} with out {out_dtype}")
    check_split(split, B.device)
    m, K = indptr.shape[0] - 1, B.shape[1]
    if m == 0 or K == 0 or indices.shape[0] == 0:
        # A zero-size grid is an invalid launch; the answer is all zeros.
        return torch.zeros((m, K), dtype=out_dtype, device=B.device)
    fn, err_str = _entry(B.dtype, out_dtype)
    vals = None if data is None else data.to(torch.float32).contiguous()
    out = torch.empty((m, K), dtype=out_dtype, device=B.device)
    S, J = split.num_segments, split.num_long_rows
    partial = (torch.empty((S, K), dtype=torch.float32, device=B.device)
               if S else None)
    vec, sw, ns = csr_shape(K, B, out,
                            *(() if partial is None else (partial,)))
    with torch.cuda.device(B.device):
        err = fn(m, K, vec, sw, ns, split.seg_len, S, J, indptr.data_ptr(),
                 indices.data_ptr(),
                 None if vals is None else vals.data_ptr(),
                 *(getattr(split, name).data_ptr() for name in _SPLIT),
                 B.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 torch.cuda.current_stream(B.device).cuda_stream)
    raise_on(err, err_str, f"spmm_csr at m={m} K={K} vec={vec} lanes={sw} "
             f"slabs={ns} L={split.seg_len} segments={S} B {B.dtype} out "
             f"{out_dtype}")
    launches += 1
    carry_launches += int(J > 0)
    slabs = -(-K // (sw * vec))
    edge_walks += -(-slabs // ns)
    return out
