"""Wrapper of the edge segment-reduce kernel ``csrc/edge_reduce.cu``.

``edge_segment_reduce`` is the per-row sum or max of CSR-ordered (nnz, K)
edge values, counterpart of
``gespmm_tpu/kernels/spmm_stream.py::edge_segment_reduce``.  A walker of
``walk_width`` lanes takes a row; rows longer than the split's L edges are
walked in segments by separate walkers, and a carry pass adds (or takes the
maximum of) each long row's segments in order (``Adjacency.split`` over the
CSR, ``Adjacency.split_t`` over the CSC).  A tensor on the CPU goes to the
plain version (``ops/reference.py::edge_segment_rows``); a CUDA tensor
launches the kernel or raises — there is no fallback.  ``launches`` counts
the kernel's launches, ``carry_launches`` its carry passes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.kernels.spmm_csr import _SPLIT, check_split, raise_on
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.formats import expand_indptr
from gespmm_tpu_torch.sparse.partition import RowSplit, build_row_split

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/edge_reduce.cu"
REPLACES = "gespmm_tpu/kernels/spmm_stream.py:816"

launches = 0
carry_launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    global launches, carry_launches
    launches = carry_launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = load_library("edge_reduce")
    fn = getattr(lib, f"gespmm_edge_reduce_{_SUFFIX[dtype]}")
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i] * 7 + [p] * 9
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


KC = 4  # columns a lane carries at once (csrc/edge_reduce.cu's KC)


def walk_width(nnz: int, m: int, K: int) -> int:
    """Lanes a walker (4, 8, 16 or 32): the smallest power of two that
    covers half the mean degree nnz / m, so that a lane takes about two
    edges of a row and a warp walks 32 / SW rows; at least 8 where K > KC,
    since a lane then walks its row once a column chunk.  The fastest width
    at sbm and rmat15, K = 1 and 8 (PERF.md section 6)."""
    half = -(-nnz // max(2 * m, 1))
    return min(32, max(8 if K > KC else 4, 1 << (half - 1).bit_length()))


def edge_segment_reduce(indptr: Tensor, vals: Tensor, op: str = "sum",
                        rows: Optional[Tensor] = None,
                        split: Optional[RowSplit] = None) -> Tensor:
    """(m, K) per-row ``op`` ("sum" | "max") of the (nnz, K) ``vals``, which
    are in the edge order of the compressed matrix ``indptr``.

    Accumulates in f32; the output takes the values' dtype; a non-finite
    max (an empty row) becomes 0.  ``split`` is ``indptr``'s row split on
    the values' device (``Adjacency.split``, or ``split_t`` for the CSC);
    without one, a CUDA call builds it from a host copy of ``indptr``, which
    synchronises.  ``rows`` (the expanded indptr) is used only by the plain
    version, which walks every row whole.
    """
    if vals.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, vals.shape[0])
        return reference.edge_segment_rows(rows, vals, indptr.shape[0] - 1, op)
    return edge_segment_reduce_cuda(indptr, vals, op, split)


def edge_segment_reduce_cuda(indptr: Tensor, vals: Tensor, op: str,
                             split: Optional[RowSplit] = None) -> Tensor:
    """Launch the kernel, and its carry when the split has a segment, on the
    current stream of the values' device."""
    global launches, carry_launches
    if op not in reference.SEGMENT_OPS:
        raise ValueError(f"op must be one of {reference.SEGMENT_OPS}, got {op!r}")
    if vals.device.type != "cuda":
        raise ValueError(f"vals must be a CUDA tensor, got device {vals.device}")
    if vals.dtype not in _SUFFIX:
        raise TypeError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("vals must be a contiguous (nnz, K) tensor, got "
                         f"{tuple(vals.shape)}")
    if indptr.device != vals.device:
        raise ValueError(f"indptr is on {indptr.device}, vals on {vals.device}")
    if indptr.dtype != torch.int32 or indptr.dim() != 1 or not indptr.is_contiguous():
        raise TypeError("indptr must be a contiguous 1-D int32 tensor")
    nnz, K = vals.shape
    m = indptr.shape[0] - 1
    if m == 0 or K == 0 or nnz == 0:
        # A zero-size grid is an invalid launch; every row is empty.
        return torch.zeros((m, K), dtype=vals.dtype, device=vals.device)
    if split is None:
        split = build_row_split(indptr).to(vals.device)
    check_split(split, vals.device)
    fn, err_str = _entry(vals.dtype)
    out = torch.empty((m, K), dtype=vals.dtype, device=vals.device)
    S = split.num_segments
    part = (torch.empty((S, K), dtype=torch.float32, device=vals.device)
            if S else None)
    sw = walk_width(nnz, m, K)
    with torch.cuda.device(vals.device):
        err = fn(m, K, int(op == "max"), sw, split.seg_len, S,
                 split.num_long_rows,
                 *(getattr(split, name).data_ptr() for name in _SPLIT),
                 indptr.data_ptr(), vals.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(),
                 torch.cuda.current_stream(vals.device).cuda_stream)
    raise_on(err, err_str, f"edge_segment_reduce at m={m} K={K} lanes={sw} "
             f"segments={S} dtype={vals.dtype}")
    launches += 1
    carry_launches += int(S > 0)
    return out
