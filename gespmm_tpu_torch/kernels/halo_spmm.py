"""Wrapper of the joint diag+halo SpMM kernel ``csrc/halo_spmm.cu`` (kernel row 7).

One shard of the sharded tier (``parallel/halo.py``): the shard's output rows
reduce its diag block's edges over its own B rows together with its halo
block's edges over the halo table that the exchange delivered.  Counterpart
of ``gespmm_tpu/parallel/halo.py``'s stream reduces (``_tiled_apply``,
``_minmax_block_raw`` + ``_minmax_fwd_raw``): one launch a shard.  With the
halo block left out (``h_indptr=None``) the same kernel is the sum backward
over one transposed block.

A tensor on the CPU goes to the plain version
(``ops/reference.py::halo_spmm_rows``); a CUDA tensor launches the kernel or
raises — there is no fallback.  ``launches`` counts kernel launches.
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

SOURCE = "gespmm_tpu_torch/csrc/halo_spmm.cu"
REPLACES = "gespmm_tpu/parallel/halo.py:373"
REDUCES = ("sum", "max", "min")

launches = 0

_OP = {"sum": 0, "max": 1, "min": 2}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    global launches
    launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = load_library("halo_spmm")
    fn = getattr(lib, f"gespmm_halo_spmm_{_SUFFIX[dtype]}")
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, i, i, i, i] + [p] * 11
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def _heads(vals: Optional[Tensor]) -> int:
    return 1 if vals is None or vals.dim() == 1 else int(vals.shape[1])


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


def halo_spmm_rows(d_indptr: Tensor, d_indices: Tensor,
                   d_vals: Optional[Tensor], B_d: Tensor,
                   h_indptr: Optional[Tensor] = None,
                   h_indices: Optional[Tensor] = None,
                   h_vals: Optional[Tensor] = None,
                   B_h: Optional[Tensor] = None, reduce: str = "sum", *,
                   d_rows: Optional[Tensor] = None,
                   h_rows: Optional[Tensor] = None):
    """(out, ties) of the joint SpMM: out[r] reduces the diag block's row r
    over ``B_d`` joined with the halo block's row r over ``B_h``.

    The blocks are CSRs with the same row count; ``*_vals`` are None (1.0),
    (nnz,) or, for sum, per-head (nnz, H) over head-blocked tables (column
    k takes the value of head k // (K / H)).  ``out`` takes the tables'
    dtype; ``ties`` (f32, the joint count of achieving edges) is None for
    sum.  Rows without an edge give 0 and 0.  ``h_indptr=None`` leaves the
    halo block out.  ``d_rows``/``h_rows`` (the expanded indptrs) are used
    only by the plain version.  The op (``parallel/halo.py::halo_spmm``)
    validates its arguments; the card's route checks them again before it
    launches.
    """
    if B_d.device.type == "cpu":
        m = d_indptr.shape[0] - 1
        if d_rows is None:
            d_rows = expand_indptr(d_indptr, d_indices.shape[0])
        if h_indptr is not None and h_rows is None:
            h_rows = expand_indptr(h_indptr, h_indices.shape[0])
        return reference.halo_spmm_rows(d_rows, d_indices, d_vals, B_d, h_rows,
                                        h_indices, h_vals, B_h, m, reduce)
    return halo_spmm_cuda(d_indptr, d_indices, d_vals, B_d, h_indptr,
                          h_indices, h_vals, B_h, reduce)


def _check_vals(name: str, vals: Optional[Tensor], nnz: int, device) -> None:
    if vals is None:
        return
    if vals.device != device:
        raise ValueError(f"{name} is on {vals.device}, B on {device}")
    if vals.shape[0] != nnz or vals.dim() not in (1, 2):
        raise ValueError(f"{name} must be (nnz,) or (nnz, H) with nnz={nnz}, "
                         f"got {tuple(vals.shape)}")
    if not vals.is_floating_point():
        raise TypeError(f"{name} must be floating point, got {vals.dtype}")


def _f32(vals: Optional[Tensor]) -> Optional[Tensor]:
    return None if vals is None else vals.to(torch.float32).contiguous()


def halo_spmm_cuda(d_indptr: Tensor, d_indices: Tensor,
                   d_vals: Optional[Tensor], B_d: Tensor,
                   h_indptr: Optional[Tensor], h_indices: Optional[Tensor],
                   h_vals: Optional[Tensor], B_h: Optional[Tensor],
                   reduce: str = "sum"):
    """Launch the kernel on the current stream of B_d's device."""
    global launches
    heads = _check(reduce, d_vals, h_indptr, h_vals, B_d)
    check_operands(d_indptr, d_indices, None, B_d)
    _check_vals("d_vals", d_vals, d_indices.shape[0], B_d.device)
    m, K = d_indptr.shape[0] - 1, B_d.shape[1]
    tables = [B_d]
    if h_indptr is not None:
        check_operands(h_indptr, h_indices, None, B_h)
        _check_vals("h_vals", h_vals, h_indices.shape[0], B_d.device)
        if h_indptr.shape[0] != m + 1:
            raise ValueError(f"the halo block has {h_indptr.shape[0] - 1} rows, "
                             f"the diag block {m}")
        check_table("B_h", B_h, (B_h.shape[0], K), B_d.dtype, B_d.device)
        tables.append(B_h)
    want_ties = reduce != "sum"
    if m == 0 or K == 0:
        # A zero-size grid is an invalid launch; the answer is empty.
        return (torch.zeros((m, K), dtype=B_d.dtype, device=B_d.device),
                torch.zeros((m, K), dtype=torch.float32, device=B_d.device)
                if want_ties else None)
    fn, err_str = _entry(B_d.dtype)
    dv, hv = _f32(d_vals), _f32(h_vals)
    out = torch.empty((m, K), dtype=B_d.dtype, device=B_d.device)
    ties = (torch.empty((m, K), dtype=torch.float32, device=B_d.device)
            if want_ties else None)
    vec = lane_vector(K, *tables, out, *([ties] if want_ties else []))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(B_d.device):
        err = fn(m, K, vec, _OP[reduce], 0 if dv is None else heads,
                 ptr(d_indptr), ptr(d_indices),
                 ptr(dv), ptr(B_d), ptr(h_indptr), ptr(h_indices), ptr(hv),
                 ptr(B_h), ptr(out), ptr(ties),
                 torch.cuda.current_stream(B_d.device).cuda_stream)
    raise_on(err, err_str, f"halo_spmm at m={m} K={K} reduce={reduce} "
             f"dtype={B_d.dtype}")
    launches += 1
    return out, ties
