"""Wrapper of the grouped-gather SpMM kernel ``csrc/spmm_grouped.cu``.

Counterpart of ``gespmm_tpu/kernels/spmm_grouped.py::spmm_grouped``: the sum
SpMM over the grouped plan (``sparse/partition.py::build_grouped_plan``).
The kernel stages only the B rows each chunk's edges reference (the plan's
``ref_rows``), each once, in a ring of shared-memory stages: in each
persistent CTA a producer warp fills them with ``cp.async`` while the
consumer warps walk the previous chunk.  It is
the ``method="pallas"`` tier of an ``Adjacency`` built with
``plan="grouped"``.  A tensor on the CPU goes to the plain version
(``ops/reference.py::spmm_grouped_chunks``); a CUDA tensor launches the
kernel or raises — there is no fallback.

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
_WORK_LIST = WORK_LIST + ("ref_ptr", "ref_rows", "ref_slot")
# Shared memory of one CTA on sm_90: at most 227 KiB (232,448 bytes) after
# the opt-in; two CTAs fit an SM's 228 KiB at 113 KiB each (1 KiB of each
# CTA's share is reserved).
SMEM_MAX = 232_448
SMEM_TWO_PER_SM = 113 * 1024
# The widest K tile (one consumer thread a column; the kernel takes up to
# 256) and the producer warps of a CTA: the card's best of 32-256 columns
# and 1, 2 or 4 producers at sweep rmat15 K=128 and RCM sbm-pubmed K=32
# (PERF.md, PR 7): more, narrower CTAs keep more producer chains in flight.
MAX_COLS = 32
PRODUCERS = 2
BARRIER_BYTES = 64  # the ring's mbarriers, before the stages (csrc)


def reset_launches() -> None:
    global launches, carry_launches
    launches = carry_launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = load_library("spmm_grouped")
    fn = getattr(lib, _ENTRY[dtype])
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i] * 11 + [p] * 17
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def header_bytes(E: int, R: int) -> int:
    """Shared-memory bytes of a stage's header (csrc ``header_bytes``): six
    scalars and two spare ints, a chunk's R + 1 row offsets, and its E edge
    slots and E values, 16-byte aligned."""
    return ((8 + R + 1 + 2 * E) * 4 + 15) // 16 * 16


def stage_bytes(header: int, staged_rows: int, KT: int, itemsize: int) -> int:
    """Bytes of one stage: the header and ``staged_rows`` rows of KT
    columns, 16-byte aligned (csrc ``stage_bytes``)."""
    return header + (staged_rows * KT * itemsize + 15) // 16 * 16


def k_tile(K: int, unit: int, staged_rows: int, itemsize: int,
           header: int) -> int:
    """The K tile of one CTA: as wide as two stages in the shared memory of
    two CTAs an SM allow (of one, where a tile of ``unit`` columns does not
    fit that), at most MAX_COLS columns, a multiple of ``unit`` (the
    staging copy's columns), and split evenly over the tiles K needs.
    Raises ValueError where two stages of ``staged_rows`` rows of ``unit``
    columns do not fit a CTA at all."""
    per_col = staged_rows * itemsize
    for budget in (SMEM_TWO_PER_SM, SMEM_MAX):
        per_stage = (budget - BARRIER_BYTES) // 2 - header - 16
        widest = min(per_stage // max(per_col, 1) // unit,
                     MAX_COLS // unit) * unit
        if widest >= unit:
            break
    else:
        raise ValueError(
            f"the grouped plan stages up to {staged_rows} rows a chunk: two "
            f"stages of {unit} columns of them need more than {SMEM_MAX} "
            "bytes of shared memory; use fewer edges_per_chunk")
    tiles = -(-K // widest)
    width = -(-K // tiles)
    return -(-width // unit) * unit


def stages(KT: int, staged_rows: int, itemsize: int, header: int) -> int:
    """Stages of the ring: 3 where three fit the shared memory that two fit
    in (two CTAs an SM, else one), else 2."""
    sb = stage_bytes(header, staged_rows, KT, itemsize)
    budget = (SMEM_TWO_PER_SM if BARRIER_BYTES + 2 * sb <= SMEM_TWO_PER_SM
              else SMEM_MAX)
    return 3 if BARRIER_BYTES + 3 * sb <= budget else 2


def copy_width(K: int, itemsize: int, B: Tensor) -> int:
    """Bytes of one staging copy: the widest of 16, 8, 4 that divides a row
    of K elements and B's address; 2 (a bf16 B with odd K) otherwise."""
    for cw in (16, 8, 4):
        if (K * itemsize) % cw == 0 and B.data_ptr() % cw == 0:
            return cw
    return itemsize


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
    carry_vec = lane_vector(K, B, out,
                            *(() if partial is None else (partial,)))
    E, R, S = plan.edges_per_chunk, plan.rows_per_block, plan.max_refs
    itemsize = B.element_size()
    cw = copy_width(K, itemsize, B)
    header = header_bytes(E, R)
    KT = k_tile(K, max(cw // itemsize, 1), S, itemsize, header)
    NS = stages(KT, S, itemsize, header)
    with torch.cuda.device(B.device):
        err = fn(plan.num_chunks, J, K, KT, NS, PRODUCERS, cw, carry_vec, E,
                 R, S,
                 plan.indptr.data_ptr(),
                 None if vals is None else vals.data_ptr(),
                 *(getattr(plan, name).data_ptr() for name in _WORK_LIST),
                 B.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 torch.cuda.current_stream(B.device).cuda_stream)
    raise_on(err, err_str, f"spmm_grouped at m={m} K={K} K tile={KT} "
             f"stages={NS} copy={cw} B chunks={plan.num_chunks} rows a "
             f"chunk<={S} dtype={B.dtype}")
    launches += 1
    carry_launches += int(J > 0)
    return out
