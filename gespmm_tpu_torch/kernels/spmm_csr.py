"""Wrapper of the fused CSR SpMM kernel ``csrc/spmm_csr.cu``.

Counterpart of ``gespmm_tpu/kernels/spmm_stream.py::spmm_tiled`` (sum): the
TPU's gather + Pallas stream-reduce pair becomes one CUDA kernel.  A tensor
on the CPU goes to the plain version (``ops/reference.py::spmm_rows``); a
CUDA tensor launches the kernel or raises — there is no fallback.

``launches`` counts kernel launches (a plain int), so a run can show that
its SpMMs went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.formats import expand_indptr

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/spmm_csr.cu"
REPLACES = "gespmm_tpu/kernels/spmm_stream.py:232"

launches = 0

_ENTRY = {torch.float32: "gespmm_spmm_csr_f32",
          torch.bfloat16: "gespmm_spmm_csr_bf16"}


def reset_launches() -> None:
    global launches
    launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = load_library("spmm_csr")
    fn = getattr(lib, _ENTRY[dtype])
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, i, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def spmm_csr(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
             B: Tensor, rows: Optional[Tensor] = None) -> Tensor:
    """out = A @ B for the CSR (indptr, indices, data); ``data=None`` is 1.0.

    Accumulates in f32; the output takes B's dtype.  ``rows`` (the expanded
    indptr) is used only by the plain version on the CPU.
    """
    if B.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, indices.shape[0])
        return reference.spmm_rows(rows, indices, data, B, indptr.shape[0] - 1)
    return spmm_csr_cuda(indptr, indices, data, B)


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


def check_operands(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
                   B: Tensor) -> None:
    """Raise on a sparse operand or a dense ``B`` that the kernels of
    ``csrc/`` do not take (shared by every wrapper)."""
    if B.device.type != "cuda":
        raise ValueError(f"B must be a CUDA tensor, got device {B.device}")
    if B.dtype not in _ENTRY:
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


def raise_on(err: int, err_str, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")


def spmm_csr_cuda(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
                  B: Tensor) -> Tensor:
    """Launch the kernel on the current stream of B's device."""
    global launches
    check_operands(indptr, indices, data, B)
    m, K = indptr.shape[0] - 1, B.shape[1]
    if m == 0 or K == 0 or indices.shape[0] == 0:
        # A zero-size grid is an invalid launch; the answer is all zeros.
        return torch.zeros((m, K), dtype=B.dtype, device=B.device)
    fn, err_str = _entry(B.dtype)
    vals = None if data is None else data.to(torch.float32).contiguous()
    out = torch.empty((m, K), dtype=B.dtype, device=B.device)
    with torch.cuda.device(B.device):
        err = fn(m, K, lane_vector(K, B, out), indptr.data_ptr(),
                 indices.data_ptr(),
                 None if vals is None else vals.data_ptr(),
                 B.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(B.device).cuda_stream)
    raise_on(err, err_str, f"spmm_csr at m={m} K={K} dtype={B.dtype}")
    launches += 1
    return out
