"""Wrapper of the edge segment-reduce kernel ``csrc/edge_reduce.cu``.

``edge_segment_reduce`` is the per-row sum or max of CSR-ordered (nnz, K)
edge values, counterpart of
``gespmm_tpu/kernels/spmm_stream.py::edge_segment_reduce``.  A tensor on the
CPU goes to the plain version (``ops/reference.py::edge_segment_rows``); a
CUDA tensor launches the kernel or raises — there is no fallback.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.kernels.spmm_csr import raise_on
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.formats import expand_indptr

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/edge_reduce.cu"
REPLACES = "gespmm_tpu/kernels/spmm_stream.py:816"

launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    global launches
    launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = load_library("edge_reduce")
    fn = getattr(lib, f"gespmm_edge_reduce_{_SUFFIX[dtype]}")
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def edge_segment_reduce(indptr: Tensor, vals: Tensor, op: str = "sum",
                        rows: Optional[Tensor] = None) -> Tensor:
    """(m, K) per-row ``op`` ("sum" | "max") of the (nnz, K) ``vals``, which
    are in the edge order of the compressed matrix ``indptr``.

    Accumulates in f32; the output takes the values' dtype; a non-finite
    max (an empty row) becomes 0.  ``rows`` (the expanded indptr) is used
    only by the plain version.
    """
    if vals.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, vals.shape[0])
        return reference.edge_segment_rows(rows, vals, indptr.shape[0] - 1, op)
    return edge_segment_reduce_cuda(indptr, vals, op)


def edge_segment_reduce_cuda(indptr: Tensor, vals: Tensor, op: str) -> Tensor:
    """Launch the kernel on the current stream of the values' device."""
    global launches
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
    fn, err_str = _entry(vals.dtype)
    out = torch.empty((m, K), dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        err = fn(m, K, int(op == "max"), indptr.data_ptr(), vals.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream(vals.device).cuda_stream)
    raise_on(err, err_str,
             f"edge_segment_reduce at m={m} K={K} dtype={vals.dtype}")
    launches += 1
    return out
