"""Wrapper of the nnz-chunked SpMM kernel ``csrc/spmm_chunk.cu``.

Counterpart of ``gespmm_tpu/kernels/spmm_pallas.py::spmm_pallas``: the sum
SpMM over the per-row chunk plan (``sparse/partition.py::build_spmm_plan``),
the ``method="pallas"`` tier.  The kernel walks the plan's pieces (each
row's part in each chunk), one walker of ``walk_shape``'s 4-32 lanes a
piece.  A tensor on the CPU goes to the plain version
(``ops/reference.py::spmm_chunks``, which sums the same pieces); a CUDA
tensor launches the kernel or raises — there is no fallback.

``launches`` counts the chunk pass, ``carry_launches`` the carry pass that
adds up the rows cut by a chunk boundary (one call of ``spmm_pallas`` is one
launch of each, or of the chunk pass alone when no row is cut).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.kernels.spmm_csr import (check_operands, raise_on,
                                               walk_shape)
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.formats import expand_indptr
from gespmm_tpu_torch.sparse.partition import PIECE_LIST, SpmmPlan

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/spmm_chunk.cu"
REPLACES = "gespmm_tpu/kernels/spmm_pallas.py:48"

launches = 0
carry_launches = 0

_ENTRY = {torch.float32: "gespmm_spmm_chunk_f32",
          torch.bfloat16: "gespmm_spmm_chunk_bf16"}


def reset_launches() -> None:
    global launches, carry_launches
    launches = carry_launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = load_library("spmm_chunk")
    fn = getattr(lib, _ENTRY[dtype])
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i] * 6 + [p] * 11
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def spmm_pallas(plan: SpmmPlan, data: Optional[Tensor], B: Tensor,
                m: int) -> Tensor:
    """Sum-reduce SpMM over the chunk plan: out = A @ B, (m, K).

    ``data``: per-edge values in the CSR order of the plan's structure, or
    None for implicit 1.0.  Accumulates in f32; the output takes B's dtype.
    """
    if plan.shape[0] != m:
        raise ValueError(f"the plan has {plan.shape[0]} rows, m={m}")
    if B.dim() != 2 or B.shape[0] != plan.shape[1]:
        raise ValueError(f"B must be ({plan.shape[1]}, K), got {tuple(B.shape)}")
    if B.device.type == "cpu":
        rows = expand_indptr(plan.indptr, plan.nnz)
        return reference.spmm_chunks(plan.chunk_start, plan.chunk_count,
                                     plan.indices, data, B, rows, m)
    return spmm_chunk_cuda(plan, data, B)


def spmm_chunk_cuda(plan: SpmmPlan, data: Optional[Tensor],
                    B: Tensor) -> Tensor:
    """Launch the chunk pass over the plan's pieces, then the carry pass, on
    the current stream of B's device."""
    global launches, carry_launches
    check_operands(plan.indptr, plan.indices, data, B)
    for name in PIECE_LIST:
        t = getattr(plan, name)
        if (t is None or t.device != B.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"plan.{name} must be a contiguous int32 tensor on "
                             f"{B.device} (build_spmm_plan, SpmmPlan.to)")
    (m, _), K = plan.shape, B.shape[1]
    if m == 0 or K == 0 or plan.nnz == 0:
        # A zero-size grid is an invalid launch; the answer is all zeros.
        return torch.zeros((m, K), dtype=B.dtype, device=B.device)
    fn, err_str = _entry(B.dtype)
    vals = None if data is None else data.to(torch.float32).contiguous()
    out = torch.empty((m, K), dtype=B.dtype, device=B.device)
    J = int(plan.cut_rows.shape[0])
    partial = (torch.empty((plan.num_slots, K), dtype=torch.float32,
                           device=B.device) if J else None)
    vec, sw = walk_shape(K, 1, B, out,
                         *(() if partial is None else (partial,)))
    with torch.cuda.device(B.device):
        err = fn(plan.num_pieces, J, K, vec, sw, plan.nnz,
                 plan.indices.data_ptr(),
                 None if vals is None else vals.data_ptr(),
                 *(getattr(plan, name).data_ptr() for name in PIECE_LIST),
                 B.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 torch.cuda.current_stream(B.device).cuda_stream)
    raise_on(err, err_str, f"spmm_chunk at m={m} K={K} pieces="
             f"{plan.num_pieces} dtype={B.dtype}")
    launches += 1
    carry_launches += int(J > 0)
    return out
