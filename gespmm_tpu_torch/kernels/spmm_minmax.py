"""Wrappers of the max/min SpMM kernels ``csrc/spmm_minmax.cu``.

``spmm_minmax`` is the forward: ``(out, ties)`` over the CSR, counterpart of
``gespmm_tpu/kernels/spmm_stream.py::spmm_tiled(reduce="max"|"min",
want_ties=True)``.  ``spmm_minmax_vjp`` is the backward over the CSC,
counterpart of ``spmm_minmax_vjp_tiled``: ``grad_B`` and, for a valued
matrix, ``grad_values`` in CSC order, with the gradient split evenly among
the ``ties`` edges that achieve each output.

A tensor on the CPU goes to the plain version (``ops/reference.py``); a
CUDA tensor launches the kernel or raises — there is no fallback.
``launches`` and ``vjp_launches`` count the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.kernels.spmm_csr import (check_operands, check_table,
                                               lane_vector, raise_on)
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.formats import expand_indptr

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/spmm_minmax.cu"
REPLACES = "gespmm_tpu/kernels/spmm_stream.py:123"
VJP_REPLACES = "gespmm_tpu/kernels/spmm_stream.py:920"
REDUCES = ("max", "min")

launches = 0
vjp_launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    global launches, vjp_launches
    launches = vjp_launches = 0


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype: torch.dtype):
    """(kernel entry point, error-string function) of ``kind`` "fwd"/"vjp"."""
    lib = load_library("spmm_minmax")
    name = {"fwd": "gespmm_spmm_minmax", "vjp": "gespmm_spmm_minmax_vjp"}[kind]
    fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = ([i, i, i, i] + [p] * 7 if kind == "fwd"
                   else [i, i, i, i] + [p] * 9)
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def _check_reduce(reduce: str) -> None:
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be 'max' or 'min', got {reduce!r}")


def spmm_minmax(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
                B: Tensor, reduce: str, rows: Optional[Tensor] = None):
    """(out, ties) of the max/min SpMM over the CSR (indptr, indices, data).

    ``data=None`` means 1.0.  ``out`` takes B's dtype; ``ties`` is f32, the
    count of edges achieving each output.  Empty rows give 0 and 0.
    ``rows`` (the expanded indptr) is used only by the plain version.
    """
    _check_reduce(reduce)
    if B.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, indices.shape[0])
        return reference.spmm_minmax_rows(rows, indices, data, B,
                                          indptr.shape[0] - 1, reduce)
    return spmm_minmax_cuda(indptr, indices, data, B, reduce)


def spmm_minmax_cuda(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
                     B: Tensor, reduce: str):
    """Launch the forward kernel on the current stream of B's device."""
    global launches
    _check_reduce(reduce)
    check_operands(indptr, indices, data, B)
    m, K = indptr.shape[0] - 1, B.shape[1]
    if m == 0 or K == 0 or indices.shape[0] == 0:
        # A zero-size grid is an invalid launch; the answer is all zeros.
        return (torch.zeros((m, K), dtype=B.dtype, device=B.device),
                torch.zeros((m, K), dtype=torch.float32, device=B.device))
    fn, err_str = _entry("fwd", B.dtype)
    vals = None if data is None else data.to(torch.float32).contiguous()
    out = torch.empty((m, K), dtype=B.dtype, device=B.device)
    ties = torch.empty((m, K), dtype=torch.float32, device=B.device)
    with torch.cuda.device(B.device):
        err = fn(m, K, lane_vector(K, B, out, ties), int(reduce == "max"),
                 indptr.data_ptr(), indices.data_ptr(),
                 None if vals is None else vals.data_ptr(),
                 B.data_ptr(), out.data_ptr(), ties.data_ptr(),
                 torch.cuda.current_stream(B.device).cuda_stream)
    raise_on(err, err_str, f"spmm_minmax at m={m} K={K} dtype={B.dtype}")
    launches += 1
    return out, ties


def spmm_minmax_vjp(colptr: Tensor, rows: Tensor, data: Optional[Tensor],
                    B: Tensor, out: Tensor, g: Tensor, ties: Tensor, *,
                    want_values: bool = True, cols: Optional[Tensor] = None):
    """(grad_B, grad_values) of the max/min SpMM, over the CSC.

    (colptr, rows, data) is the CSC of A (``data`` in CSC order); ``out`` and
    ``ties`` are the forward's, ``g`` the cotangent of ``out``; every row id
    in ``rows`` must be below ``out.shape[0]``, A's row count.  The even
    split ``g / max(ties, 1)`` is folded into one f32 table first.
    ``grad_values`` comes back in CSC order, or None for a binary matrix or
    when not ``want_values``.  ``cols`` (the expanded colptr) is used only
    by the plain version.
    """
    g_over_ties = g.to(torch.float32) / torch.clamp(ties, min=1.0)
    if B.device.type == "cpu":
        if cols is None:
            cols = expand_indptr(colptr, rows.shape[0])
        grad_B, grad_vals = reference.spmm_minmax_vjp_cols(
            cols, rows, data, B, out, g_over_ties, want_values)
        return grad_B.to(B.dtype), grad_vals
    return spmm_minmax_vjp_cuda(colptr, rows, data, B, out, g_over_ties,
                                want_values)


def spmm_minmax_vjp_cuda(colptr: Tensor, rows: Tensor, data: Optional[Tensor],
                         B: Tensor, out: Tensor, g_over_ties: Tensor,
                         want_values: bool = True):
    """Launch the backward kernel on the current stream of B's device."""
    global vjp_launches
    check_operands(colptr, rows, data, B)
    n, K, nnz = colptr.shape[0] - 1, B.shape[1], rows.shape[0]
    if n != B.shape[0]:
        raise ValueError(f"the CSC has {n} columns, B has {B.shape[0]} rows")
    m = out.shape[0]
    check_table("out", out, (m, K), B.dtype, B.device)
    check_table("g_over_ties", g_over_ties, (m, K), torch.float32,
                      B.device)
    want_values = want_values and data is not None
    if n == 0 or K == 0 or nnz == 0:
        return (torch.zeros((n, K), dtype=B.dtype, device=B.device),
                torch.zeros(nnz, dtype=torch.float32, device=B.device)
                if want_values else None)
    fn, err_str = _entry("vjp", B.dtype)
    vals = None if data is None else data.to(torch.float32).contiguous()
    grad_B = torch.empty((n, K), dtype=B.dtype, device=B.device)
    vec = lane_vector(K, B, out, g_over_ties, grad_B)
    slabs = -(-K // (32 * vec))
    partials = (torch.empty((slabs, nnz), dtype=torch.float32, device=B.device)
                if want_values else None)
    with torch.cuda.device(B.device):
        err = fn(n, K, nnz, vec, colptr.data_ptr(), rows.data_ptr(),
                 None if vals is None else vals.data_ptr(),
                 B.data_ptr(), out.data_ptr(), g_over_ties.data_ptr(),
                 grad_B.data_ptr(),
                 None if partials is None else partials.data_ptr(),
                 torch.cuda.current_stream(B.device).cuda_stream)
    raise_on(err, err_str, f"spmm_minmax_vjp at n={n} K={K} dtype={B.dtype}")
    vjp_launches += 1
    # Slab partials summed in slab order: deterministic.
    return grad_B, None if partials is None else partials.sum(0)
