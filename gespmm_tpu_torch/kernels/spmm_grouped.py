"""Wrapper of the grouped-gather SpMM kernel ``csrc/spmm_grouped.cu``.

Counterpart of ``gespmm_tpu/kernels/spmm_grouped.py::spmm_grouped``: the sum
SpMM over the grouped plan (``sparse/partition.py::build_grouped_plan``),
which stages each chunk's distinct aligned groups of B rows in shared
memory once.  It is the ``method="pallas"`` and ``method="auto"`` tier of an
``Adjacency`` built with ``plan="grouped"``.  A tensor on the CPU goes to the
plain version (``ops/reference.py::spmm_grouped_chunks``); a CUDA tensor
launches the kernel or raises — there is no fallback.

``launches`` counts the chunk pass, ``carry_launches`` the carry pass that
adds up the rows cut by a chunk boundary (one call of ``spmm_grouped`` is one
launch of each, or of the chunk pass alone when no row is cut).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.kernels.spmm_csr import (check_operands, lane_vector,
                                               raise_on)
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.formats import expand_indptr
from gespmm_tpu_torch.sparse.partition import WORK_LIST, GroupedSpmmPlan

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/spmm_grouped.cu"
REPLACES = "gespmm_tpu/kernels/spmm_grouped.py:44"

launches = 0
carry_launches = 0

_ENTRY = {torch.float32: "gespmm_spmm_grouped_f32",
          torch.bfloat16: "gespmm_spmm_grouped_bf16"}
_WORK_LIST = WORK_LIST + ("groups", "group_count", "slots")
# Shared memory of one CTA on sm_90: at most 227 KiB (232,448 bytes) after
# the opt-in; two CTAs fit an SM's 228 KiB at 113 KiB each (1 KiB of each
# CTA's share is reserved).
SMEM_MAX = 232_448
SMEM_TWO_PER_SM = 113 * 1024
MAX_LANES = 256  # threads that own columns in one CTA


def reset_launches() -> None:
    global launches, carry_launches
    launches = carry_launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = load_library("spmm_grouped")
    fn = getattr(lib, _ENTRY[dtype])
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i] * 9 + [p] * 17
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def header_bytes(E: int, NG: int) -> int:
    """Shared-memory bytes before the staged rows (csrc ``header_bytes``):
    a chunk's edge slots and values, and its group ids, 16-byte aligned."""
    return ((2 * E + NG) * 4 + 15) // 16 * 16


def k_tile(K: int, vec: int, staged_rows: int, itemsize: int,
           header: int) -> int:
    """The K tile of one CTA: as wide as the shared memory of two CTAs an
    SM allows (of one, where a tile of ``vec`` columns does not fit that),
    at most MAX_LANES lanes of ``vec`` columns, and split evenly over the
    tiles K needs.  Raises ValueError where ``staged_rows`` rows of ``vec``
    columns do not fit a CTA at all."""
    per_col = staged_rows * itemsize
    for budget in (SMEM_TWO_PER_SM, SMEM_MAX):
        widest = min((budget - header) // max(per_col, 1) // vec,
                     MAX_LANES) * vec
        if widest >= vec:
            break
    else:
        raise ValueError(
            f"the grouped plan stages {staged_rows} rows a chunk: "
            f"{vec} columns of them need more than {SMEM_MAX} bytes of "
            "shared memory; use fewer groups_per_chunk or group_rows")
    tiles = -(-K // widest)
    width = -(-K // tiles)
    return -(-width // vec) * vec


def spmm_grouped(plan: GroupedSpmmPlan, data: Optional[Tensor], B: Tensor,
                 m: int) -> Tensor:
    """Sum-reduce SpMM over the grouped plan: out = A @ B, (m, K).

    ``data``: per-edge values in the CSR order of the plan's structure, or
    None for implicit 1.0.  Accumulates in f32; the output takes B's dtype.
    """
    if plan.shape[0] != m:
        raise ValueError(f"the plan has {plan.shape[0]} rows, m={m}")
    if B.dim() != 2 or B.shape[0] != plan.shape[1]:
        raise ValueError(f"B must be ({plan.shape[1]}, K), got {tuple(B.shape)}")
    if B.device.type == "cpu":
        rows = expand_indptr(plan.indptr, plan.nnz)
        return reference.spmm_grouped_chunks(
            plan.chunk_count, plan.groups, plan.group_count, plan.slots,
            plan.group_rows, data, B, rows, m)
    return spmm_grouped_cuda(plan, data, B)


def spmm_grouped_cuda(plan: GroupedSpmmPlan, data: Optional[Tensor],
                      B: Tensor) -> Tensor:
    """Launch the chunk pass, then the carry pass, on the current stream of
    B's device."""
    global launches, carry_launches
    check_operands(plan.indptr, plan.indices, data, B)
    for name in _WORK_LIST:
        t = getattr(plan, name)
        if t.device != B.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"plan.{name} must be a contiguous int32 tensor on "
                             f"{B.device} (GroupedSpmmPlan.to)")
    (m, n), K = plan.shape, B.shape[1]
    if m == 0 or K == 0 or plan.nnz == 0:
        # A zero-size grid is an invalid launch; the answer is all zeros.
        return torch.zeros((m, K), dtype=B.dtype, device=B.device)
    fn, err_str = _entry(B.dtype)
    vals = None if data is None else data.to(torch.float32).contiguous()
    out = torch.empty((m, K), dtype=B.dtype, device=B.device)
    J = int(plan.cut_rows.shape[0])
    partial = (torch.empty((plan.num_slots, K), dtype=torch.float32,
                           device=B.device) if J else None)
    vec = lane_vector(K, B, out, *(() if partial is None else (partial,)))
    E, NG, G = plan.edges_per_chunk, plan.groups_per_chunk, plan.group_rows
    KT = k_tile(K, vec, NG * G, B.element_size(), header_bytes(E, NG))
    with torch.cuda.device(B.device):
        err = fn(plan.num_chunks, J, n, K, KT, vec, E, NG, G,
                 plan.indptr.data_ptr(),
                 None if vals is None else vals.data_ptr(),
                 *(getattr(plan, name).data_ptr() for name in _WORK_LIST),
                 B.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 torch.cuda.current_stream(B.device).cuda_stream)
    raise_on(err, err_str, f"spmm_grouped at m={m} K={K} K tile={KT} chunks="
             f"{plan.num_chunks} groups={NG}x{G} dtype={B.dtype}")
    launches += 1
    carry_launches += int(J > 0)
    return out
