"""Wrapper of the joint diag+halo SpMM kernel ``csrc/halo_spmm.cu`` (kernel row 7).

The sharded tier (``parallel/halo.py``): each shard's output rows reduce its
diag block's edges over its own B rows together with its halo block's edges
over the halo table that the exchange delivered.  Counterpart of
``gespmm_tpu/parallel/halo.py``'s stream reduces (``_tiled_apply``,
``_minmax_block_raw`` + ``_minmax_fwd_raw``).  ``halo_spmm_stacked`` takes
the stacked blocks of n shards (``HaloPartition``'s layout) and runs ONE
launch over all of them; a row of more than L joint edges (diag, then halo)
is walked in segments of L by separate warps, and a carry pass adds the
segments in order, or folds their (extremum, count) pairs for max/min
(``sparse/partition.py::build_shard_split``, built with the partition).
With the halo block left out (``h_indptr=None``) the same kernel is the sum
backward over the stacked transposed blocks.  ``halo_spmm_rows`` is the
same call over one shard's blocks.

A tensor on the CPU goes to the plain split walk
(``ops/reference.py::halo_spmm_split_rows``); a CUDA tensor launches the
kernel or raises — there is no fallback.  ``launches`` counts the main
pass, ``carry_launches`` the carry (one of each a call, or the main pass
alone when the launch has no segment).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.kernels.spmm_csr import check_table, lane_vector, raise_on
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.partition import (RowSplit, ShardSplit,
                                               local_split)

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/halo_spmm.cu"
REPLACES = "gespmm_tpu/parallel/halo.py:373"
REDUCES = ("sum", "max", "min")

launches = 0
carry_launches = 0

_OP = {"sum": 0, "max": 1, "min": 2}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SPLIT = ("seg_row", "seg_start", "long_rows", "seg_ptr")


def reset_launches() -> None:
    global launches, carry_launches
    launches = carry_launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = load_library("halo_spmm")
    fn = getattr(lib, f"gespmm_halo_spmm_{_SUFFIX[dtype]}")
    i, p, w = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = ([i] * 11 + [p] * 4 + [w] * 2 + [p] * 4 + [w] * 2
                   + [p] * 9)
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def _heads(vals: Optional[Tensor]) -> int:
    """Values a edge of stacked (n, stride) or per-head (n, stride, H)
    values."""
    return 1 if vals is None or vals.dim() == 2 else int(vals.shape[2])


def _check(reduce: str, d_vals, h_indptr, h_vals, B_d: Tensor) -> int:
    """The launch's argument checks; returns the head count."""
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    heads = _heads(d_vals)
    if h_indptr is not None and (h_vals is None) != (d_vals is None):
        raise ValueError("give values for both blocks or for neither")
    if h_indptr is not None and _heads(h_vals) != heads:
        raise ValueError("the two blocks' values have different head counts")
    if heads > 1 and reduce != "sum":
        raise ValueError("per-head edge values are not supported with "
                         "reduce=max/min")
    if B_d.shape[1] % heads:
        raise ValueError(f"B width {B_d.shape[1]} must be heads={heads} blocks")
    return heads


def halo_spmm_stacked(d_indptr: Tensor, d_indices: Tensor,
                      d_vals: Optional[Tensor], B_d: Tensor,
                      h_indptr: Optional[Tensor] = None,
                      h_indices: Optional[Tensor] = None,
                      h_vals: Optional[Tensor] = None,
                      B_h: Optional[Tensor] = None, reduce: str = "sum", *,
                      split: Optional[ShardSplit] = None, first: int = 0):
    """(out, ties) of the joint SpMM over n stacked shards: out row i * m +
    r reduces shard i's diag row r over its slab of ``B_d`` joined with its
    halo row r over its slab of ``B_h``.

    Blocks are stacked CSRs, (n, m + 1) indptrs and (n, stride) indices
    (``HaloPartition``'s rows for those shards); ``*_vals`` are None (1.0),
    (n, stride) or, for sum, per-head (n, stride, H) over head-blocked
    tables (column k takes head k // (K / H)).  ``B_d`` is (n * rows, K),
    ``B_h`` (n * rows, K) or (n, rows, K): n equal slabs.  ``out`` takes
    the tables' dtype; ``ties`` (f32, the joint count of achieving edges)
    is None for sum.  Rows without an edge give 0 and 0.  ``h_indptr=None``
    leaves the halo block out.  ``split`` is the partition's
    ``ShardSplit`` of these blocks and ``first`` the first shard given;
    without it every row is walked by one warp.
    """
    n, m = d_indptr.shape[0], d_indptr.shape[1] - 1
    rs, row0, slot0 = local_split(split, first, n, m)
    if B_d.device.type == "cpu":
        empty = torch.zeros(0, dtype=torch.int32)
        return reference.halo_spmm_split_rows(
            d_indptr, d_indices, d_vals, B_d, h_indptr, h_indices, h_vals,
            B_h, reduce, empty if rs is None else rs.seg_row,
            empty if rs is None else rs.long_rows,
            torch.zeros(1, dtype=torch.int32) if rs is None else rs.seg_ptr,
            1 if rs is None else rs.seg_len, row0, slot0)
    return halo_spmm_cuda(d_indptr, d_indices, d_vals, B_d, h_indptr,
                          h_indices, h_vals, B_h, reduce, rs, row0, slot0)


def halo_spmm_rows(d_indptr: Tensor, d_indices: Tensor,
                   d_vals: Optional[Tensor], B_d: Tensor,
                   h_indptr: Optional[Tensor] = None,
                   h_indices: Optional[Tensor] = None,
                   h_vals: Optional[Tensor] = None,
                   B_h: Optional[Tensor] = None, reduce: str = "sum", *,
                   split: Optional[ShardSplit] = None, shard: int = 0):
    """``halo_spmm_stacked`` over one shard's blocks: (m + 1,) indptrs,
    (nnz,) indices, (nnz,) or (nnz, H) values, (rows, K) tables; ``split``
    and ``shard`` select that shard's segments."""
    one = lambda t: None if t is None else t[None]  # noqa: E731
    return halo_spmm_stacked(one(d_indptr), one(d_indices), one(d_vals), B_d,
                             one(h_indptr), one(h_indices), one(h_vals), B_h,
                             reduce, split=split, first=shard)


def _check_block(name: str, indptr: Tensor, indices: Tensor,
                 vals: Optional[Tensor], n: int, m: int, device) -> None:
    for what, t, dims in (("indptr", indptr, 2), ("indices", indices, 2)):
        if t.device != device:
            raise ValueError(f"{name} {what} is on {t.device}, B on {device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} {what} must be int32, got {t.dtype}")
        if t.dim() != dims or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name} {what} must be a contiguous ({n}, ...) "
                             f"tensor, got {tuple(t.shape)}")
    if indptr.shape[1] != m + 1:
        raise ValueError(f"{name} indptr has {indptr.shape[1] - 1} rows, "
                         f"the diag block {m}")
    if indices.shape[1] >= 2**31:
        raise ValueError(f"{name}: {indices.shape[1]} edges a shard need "
                         "64-bit indices; the kernel is int32")
    if vals is None:
        return
    if vals.device != device:
        raise ValueError(f"{name} values are on {vals.device}, B on {device}")
    if vals.dim() not in (2, 3) or tuple(vals.shape[:2]) != tuple(indices.shape):
        raise ValueError(f"{name} values must be {tuple(indices.shape)} or "
                         f"{tuple(indices.shape)} + (H,), got "
                         f"{tuple(vals.shape)}")
    if not vals.is_floating_point():
        raise TypeError(f"{name} values must be floating point, got "
                        f"{vals.dtype}")


def _f32(vals: Optional[Tensor]) -> Optional[Tensor]:
    return None if vals is None else vals.to(torch.float32).contiguous()


def halo_spmm_cuda(d_indptr: Tensor, d_indices: Tensor,
                   d_vals: Optional[Tensor], B_d: Tensor,
                   h_indptr: Optional[Tensor], h_indices: Optional[Tensor],
                   h_vals: Optional[Tensor], B_h: Optional[Tensor],
                   reduce: str, split: Optional[RowSplit], row0: int,
                   slot0: int):
    """Launch the main pass, then the carry when the split has a segment,
    on the current stream of B_d's device."""
    global launches, carry_launches
    heads = _check(reduce, d_vals, h_indptr, h_vals, B_d)
    if B_d.device.type != "cuda":
        raise ValueError(f"B must be a CUDA tensor, got device {B_d.device}")
    if B_d.dtype not in _SUFFIX:
        raise TypeError(f"B must be float32 or bfloat16, got {B_d.dtype}")
    n, m = d_indptr.shape[0], d_indptr.shape[1] - 1
    if B_d.dim() != 2 or B_d.shape[0] % max(n, 1) or not B_d.is_contiguous():
        raise ValueError(f"B must be a contiguous ({n} * rows, K) tensor, "
                         f"got {tuple(B_d.shape)}")
    K = B_d.shape[1]
    _check_block("diag", d_indptr, d_indices, d_vals, n, m, B_d.device)
    tables = [B_d]
    if h_indptr is not None:
        _check_block("halo", h_indptr, h_indices, h_vals, n, m, B_d.device)
        B_h = B_h.reshape(-1, B_h.shape[-1])  # (n, rows, K) -> a view
        if B_h.shape[0] % n:
            raise ValueError(f"the halo tables' {B_h.shape[0]} rows are not "
                             f"{n} equal slabs")
        check_table("B_h", B_h, (B_h.shape[0], K), B_d.dtype, B_d.device)
        tables.append(B_h)
    S = J = 0
    if split is not None:
        for name in _SPLIT:
            t = getattr(split, name)
            if (t.device != B_d.device or t.dtype != torch.int32
                    or not t.is_contiguous()):
                raise ValueError(f"split.{name} must be a contiguous int32 "
                                 f"tensor on {B_d.device} (ShardSplit.to)")
        S, J = split.num_segments, split.num_long_rows
    want_ties = reduce != "sum"
    if n == 0 or m == 0 or K == 0:
        # A zero-size grid is an invalid launch; the answer is empty.
        return (torch.zeros((n * m, K), dtype=B_d.dtype, device=B_d.device),
                torch.zeros((n * m, K), dtype=torch.float32,
                            device=B_d.device) if want_ties else None)
    fn, err_str = _entry(B_d.dtype)
    dv, hv = _f32(d_vals), _f32(h_vals)
    dev = B_d.device
    out = torch.empty((n * m, K), dtype=B_d.dtype, device=dev)
    f32 = lambda: torch.empty((S, K), dtype=torch.float32, device=dev)  # noqa: E731
    ties = (torch.empty((n * m, K), dtype=torch.float32, device=dev)
            if want_ties else None)
    partial = f32() if S else None
    partial_count = f32() if S and want_ties else None
    vec = lane_vector(K, *tables, out, *(t for t in (ties, partial,
                                                     partial_count)
                                         if t is not None))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    h_rows = 0 if h_indptr is None else tables[1].shape[0] // n
    with torch.cuda.device(dev):
        err = fn(n, m, K, vec, _OP[reduce], 0 if dv is None else heads,
                 0 if split is None else split.seg_len, S, J, row0, slot0,
                 ptr(d_indptr), ptr(d_indices), ptr(dv), ptr(B_d),
                 d_indices.shape[1], B_d.shape[0] // n,
                 ptr(h_indptr), ptr(h_indices), ptr(hv),
                 ptr(None if h_indptr is None else tables[1]),
                 0 if h_indptr is None else h_indices.shape[1], h_rows,
                 *(ptr(getattr(split, name)) if split is not None else None
                   for name in _SPLIT),
                 ptr(out), ptr(ties), ptr(partial), ptr(partial_count),
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, err_str, f"halo_spmm at n={n} m={m} K={K} segments={S} "
             f"reduce={reduce} dtype={B_d.dtype}")
    launches += 1
    carry_launches += int(J > 0)
    return out, ties
