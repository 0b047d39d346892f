"""Wrappers of the max/min SpMM kernels ``csrc/spmm_minmax.cu``.

``spmm_minmax`` is the forward (kernel row 2): ``(out, ties)`` over the CSR,
counterpart of ``gespmm_tpu/kernels/spmm_stream.py::spmm_tiled(reduce=
"max"|"min", want_ties=True)``.  Rows longer than the split's L edges are
walked in segments by separate walkers, and a pair carry folds each long
row's (extremum, count) pairs in segment order.  ``spmm_minmax_vjp`` is the
backward over the CSC (kernel row 3), counterpart of
``spmm_minmax_vjp_tiled``: ``grad_B`` and, for a valued matrix,
``grad_values`` in CSC order, with the gradient split evenly among the
``ties`` edges that achieve each output.  Columns longer than the split's L
edges are walked in segments by separate walkers, and a carry pass adds
each long column's segments in order.
``spmm_minmax_vjp_stacked`` is the same kernel over the stacked transposed
blocks of n shards in one launch (the sharded tier's max/min backward).

A tensor on the CPU goes to the plain version (``ops/reference.py``); a
CUDA tensor launches the kernel or raises — there is no fallback.
``launches`` and ``vjp_launches`` count the launches of each kernel,
``carry_launches`` the forward's pair carry and ``vjp_carry_launches`` the
backward's carry pass; ``edge_walks`` and ``vjp_edge_walks`` count each
kernel's walks of the edges, one a K slab of ``walk_shape``'s SW·VEC
columns (the launch's second grid dimension), as row 1's ``edge_walks``
does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.kernels.spmm_csr import (_SPLIT, check_operands,
                                               check_split, check_table,
                                               raise_on, walk_shape)
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.formats import expand_indptr
from gespmm_tpu_torch.sparse.partition import (RowSplit, ShardSplit,
                                               build_row_split, local_split)

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/spmm_minmax.cu"
REPLACES = "gespmm_tpu/kernels/spmm_stream.py:123"
VJP_REPLACES = "gespmm_tpu/kernels/spmm_stream.py:920"
REDUCES = ("max", "min")

launches = 0
carry_launches = 0
vjp_launches = 0
vjp_carry_launches = 0
edge_walks = 0
vjp_edge_walks = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    global launches, carry_launches, vjp_launches, vjp_carry_launches
    global edge_walks, vjp_edge_walks
    launches = carry_launches = vjp_launches = vjp_carry_launches = 0
    edge_walks = vjp_edge_walks = 0


def _slabs(K: int, vec: int, sw: int) -> int:
    """The K slabs of a walker of ``sw`` lanes of ``vec`` columns: the
    launch's second grid dimension, each slab a walk of the edges."""
    return -(-K // (sw * vec))


def _check_dense(B: Tensor) -> None:
    if B.device.type != "cuda":
        raise ValueError(f"B must be a CUDA tensor, got device {B.device}")
    if B.dtype not in _SUFFIX:
        raise TypeError(f"B must be float32 or bfloat16, got {B.dtype}")
    if B.dim() != 2 or not B.is_contiguous():
        raise ValueError(f"B must be a contiguous 2-D tensor, got "
                         f"{tuple(B.shape)}")


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype: torch.dtype):
    """(kernel entry point, error-string function) of ``kind`` "fwd"/"vjp"."""
    lib = load_library("spmm_minmax")
    name = {"fwd": "gespmm_spmm_minmax", "vjp": "gespmm_spmm_minmax_vjp"}[kind]
    fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
    i, w, p = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = ([i] * 8 + [p] * 13 if kind == "fwd"
                   else [i] * 11 + [w] * 2 + [p] * 15)
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def _check_reduce(reduce: str) -> None:
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be 'max' or 'min', got {reduce!r}")


def spmm_minmax(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
                B: Tensor, reduce: str, rows: Optional[Tensor] = None,
                split: Optional[RowSplit] = None):
    """(out, ties) of the max/min SpMM over the CSR (indptr, indices, data).

    ``data=None`` means 1.0.  ``out`` takes B's dtype; ``ties`` is f32, the
    count of edges achieving each output.  Empty rows give 0 and 0.
    ``split`` is the CSR's row split on B's device (``Adjacency.split``):
    rows above its L edges are walked in segments whose (extremum, count)
    pairs a carry folds.  Without one, a CUDA call builds it from a host
    copy of ``indptr``, which synchronises (set-up, not a timed call).
    ``rows`` (the expanded indptr) is used only by the plain version.
    """
    _check_reduce(reduce)
    if B.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, indices.shape[0])
        m = indptr.shape[0] - 1
        if split is not None and split.num_segments:
            return reference.spmm_minmax_split_rows(
                rows, indptr, indices, data, B, m, reduce, split.seg_row,
                split.long_rows, split.seg_ptr, split.seg_len)
        return reference.spmm_minmax_rows(rows, indices, data, B, m, reduce)
    if split is None:
        split = build_row_split(indptr).to(B.device)
    return spmm_minmax_cuda(indptr, indices, data, B, reduce, split)


def spmm_minmax_cuda(indptr: Tensor, indices: Tensor, data: Optional[Tensor],
                     B: Tensor, reduce: str, split: RowSplit):
    """Launch the forward kernel, then the pair carry when the split has a
    long row, on the current stream of B's device."""
    global launches, carry_launches, edge_walks
    _check_reduce(reduce)
    check_operands(indptr, indices, data, B)
    check_split(split, B.device)
    m, K = indptr.shape[0] - 1, B.shape[1]
    if m == 0 or K == 0 or indices.shape[0] == 0:
        # A zero-size grid is an invalid launch; the answer is all zeros.
        return (torch.zeros((m, K), dtype=B.dtype, device=B.device),
                torch.zeros((m, K), dtype=torch.float32, device=B.device))
    fn, err_str = _entry("fwd", B.dtype)
    vals = None if data is None else data.to(torch.float32).contiguous()
    out = torch.empty((m, K), dtype=B.dtype, device=B.device)
    ties = torch.empty((m, K), dtype=torch.float32, device=B.device)
    S, J = split.num_segments, split.num_long_rows
    # The segments' (extremum, count) pairs, f32.
    pair = [torch.empty((S, K), dtype=torch.float32, device=B.device)
            for _ in range(2 if S else 0)]
    vec, sw = walk_shape(K, 1, B, out, ties, *pair)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(B.device):
        err = fn(m, K, vec, sw, int(reduce == "max"), split.seg_len, S, J,
                 ptr(indptr), ptr(indices), ptr(vals),
                 *(ptr(getattr(split, name)) for name in _SPLIT),
                 ptr(B), ptr(out), ptr(ties),
                 *(ptr(t) for t in pair or (None, None)),
                 torch.cuda.current_stream(B.device).cuda_stream)
    raise_on(err, err_str, f"spmm_minmax at m={m} K={K} L={split.seg_len} "
             f"segments={S} dtype={B.dtype}")
    launches += 1
    carry_launches += int(J > 0)
    edge_walks += _slabs(K, vec, sw)
    return out, ties


def _fold(g: Tensor, ties: Tensor) -> Tensor:
    """The even tie split ``g / max(ties, 1)`` as one f32 table (the plain
    versions' operand; the kernel forms it per achieving edge)."""
    return g.to(torch.float32) / torch.clamp(ties, min=1.0)


def spmm_minmax_vjp(colptr: Tensor, rows: Tensor, data: Optional[Tensor],
                    B: Tensor, out: Tensor, g: Tensor, ties: Tensor, *,
                    want_values: bool = True, cols: Optional[Tensor] = None,
                    split: Optional[RowSplit] = None):
    """(grad_B, grad_values) of the max/min SpMM, over the CSC.

    (colptr, rows, data) is the CSC of A (``data`` in CSC order); ``out`` and
    ``ties`` are the forward's, ``g`` the cotangent of ``out`` (B's dtype on
    the card); every row id in ``rows`` must be below ``out.shape[0]``, A's
    row count.  The gradient of each output is split evenly among the
    ``ties`` edges that achieve it, ``g / max(ties, 1)``: folded into one f32
    table first on the CPU, per achieving edge inside the kernel.
    ``split`` is the CSC's column split on B's device
    (``Adjacency.split_t``): columns above its L edges are walked in
    segments, added by a carry pass.  Without one, a CUDA call builds it
    from a host copy of ``colptr``, which synchronises (set-up, not a timed
    call).  ``grad_values`` comes back in CSC order, or None for a binary
    matrix or when not ``want_values``.  ``cols`` (the expanded colptr) is
    used only by the plain version.
    """
    if B.device.type == "cpu":
        if cols is None:
            cols = expand_indptr(colptr, rows.shape[0])
        if split is not None and split.num_segments:
            grad_B, grad_vals = reference.spmm_minmax_vjp_split_cols(
                cols, colptr, rows, data, B, out, _fold(g, ties),
                split.seg_row, split.long_rows, split.seg_ptr, split.seg_len,
                want_values)
        else:
            grad_B, grad_vals = reference.spmm_minmax_vjp_cols(
                cols, rows, data, B, out, _fold(g, ties), want_values)
        return grad_B.to(B.dtype), grad_vals
    check_operands(colptr, rows, data, B)
    if split is None:
        split = build_row_split(colptr).to(B.device)
    grad_B, grad_vals = spmm_minmax_vjp_cuda(
        colptr[None], rows[None], None if data is None else data[None], B,
        out, g, ties, want_values, split, 0, 0, False)
    return grad_B, None if grad_vals is None else grad_vals[0]


def spmm_minmax_vjp_stacked(t_indptr: Tensor, t_rows: Tensor,
                            t_vals: Optional[Tensor], B: Tensor, out: Tensor,
                            g: Tensor, ties: Tensor, *,
                            want_values: bool = True,
                            split: Optional[ShardSplit] = None,
                            first: int = 0):
    """(grad_B, grad_values) of the max/min SpMM over n stacked shards, in
    one launch (the sharded tier's backward over one transposed block).

    Shard i's CSC of ``cols`` columns is row i of ``t_indptr`` (n, cols + 1)
    with its row ids ``t_rows[i]`` and values ``t_vals[i]`` ((n, stride) or
    None), padded past its edges; its rows of ``out``, ``g`` and ``ties``
    (n * rows, K) start at i * rows, and its columns' rows of ``B`` (n *
    cols, K) at i * cols.  ``split`` is the partition's ``ShardSplit`` of
    these blocks (``HaloPartition.diag_t_split``/``halo_t_split``) and
    ``first`` the first shard given; without one every column is walked
    whole.  grad_B is (n * cols, K) in B's dtype; grad_values (n, stride)
    f32 in each shard's CSC order, 0 past its edges, or None.
    """
    n, ncols = t_indptr.shape[0], t_indptr.shape[1] - 1
    rs, row0, slot0 = local_split(split, first, n, ncols)
    if B.device.type == "cpu":
        empty = torch.zeros(0, dtype=torch.int32)
        grad_B, grad_vals = reference.spmm_minmax_vjp_split_stacked(
            t_indptr, t_rows, t_vals, B, out, _fold(g, ties),
            empty if rs is None else rs.seg_row,
            empty if rs is None else rs.long_rows,
            torch.zeros(1, dtype=torch.int32) if rs is None else rs.seg_ptr,
            1 if rs is None else rs.seg_len, row0, slot0, want_values)
        return grad_B.to(B.dtype), grad_vals
    return spmm_minmax_vjp_cuda(t_indptr, t_rows, t_vals, B, out, g, ties,
                                want_values, rs, row0, slot0, True)


def spmm_minmax_vjp_cuda(colptr: Tensor, rows: Tensor, data: Optional[Tensor],
                         B: Tensor, out: Tensor, g: Tensor, ties: Tensor,
                         want_values: bool, split: Optional[RowSplit],
                         row0: int, slot0: int, seg_rel: bool):
    """Launch the backward kernel over n stacked CSCs ((n, cols + 1)
    ``colptr``, (n, stride) ``rows`` and ``data``), then the carry when the
    split has a segment, on the current stream of B's device.  ``seg_rel``:
    the split's ``seg_start`` counts from its column's first edge
    (``ShardSplit``), else from the shard's first edge (``RowSplit``).
    Returns grad_B and the (n, stride) grad_values (None without values)."""
    global vjp_launches, vjp_carry_launches, vjp_edge_walks
    _check_dense(B)
    n, ncols, K = colptr.shape[0], colptr.shape[1] - 1, B.shape[1]
    stride = rows.shape[1]
    for name, t in (("colptr", colptr), ("rows", rows)):
        if t.device != B.device or t.dtype != torch.int32 or t.dim() != 2 \
                or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 ({n}, ...) "
                             f"tensor on {B.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if stride >= 2**31:
        raise ValueError(f"{stride} edges a shard need 64-bit indices; the "
                         "kernel is int32")
    if data is not None and (data.device != B.device
                             or tuple(data.shape) != (n, stride)
                             or not data.is_floating_point()):
        raise ValueError(f"data must be a floating ({n}, {stride}) tensor on "
                         f"{B.device}, got {data.dtype} {tuple(data.shape)}")
    if B.shape[0] != n * ncols:
        raise ValueError(f"the CSC has {n} x {ncols} columns, B has "
                         f"{B.shape[0]} rows")
    if out.dim() != 2 or out.shape[0] % max(n, 1):
        raise ValueError(f"out must be ({n} * rows, {K}), got "
                         f"{tuple(out.shape)}")
    mrows = out.shape[0]
    check_table("out", out, (mrows, K), B.dtype, B.device)
    check_table("g", g, (mrows, K), B.dtype, B.device)
    check_table("ties", ties, (mrows, K), torch.float32, B.device)
    S = J = 0
    if split is not None:
        check_split(split, B.device)
        S, J = split.num_segments, split.num_long_rows
    want_values = want_values and data is not None
    if n == 0 or ncols == 0 or K == 0 or (n == 1 and stride == 0):
        return (torch.zeros((n * ncols, K), dtype=B.dtype, device=B.device),
                torch.zeros((n, stride), dtype=torch.float32,
                            device=B.device) if want_values else None)
    fn, err_str = _entry("vjp", B.dtype)
    vals = None if data is None else data.to(torch.float32).contiguous()
    grad_B = torch.empty((n * ncols, K), dtype=B.dtype, device=B.device)
    partial = (torch.empty((S, K), dtype=torch.float32, device=B.device)
               if S else None)
    vec, sw = walk_shape(K, 1, B, out, g, ties, grad_B,
                         *(() if partial is None else (partial,)))
    slabs = _slabs(K, vec, sw)
    # One shard writes every edge slot; stacked shards leave their padding.
    alloc = torch.empty if n == 1 else torch.zeros
    partials = (alloc((slabs, n * stride), dtype=torch.float32,
                      device=B.device) if want_values else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(B.device):
        err = fn(n, ncols, K, vec, sw, 0 if split is None else split.seg_len,
                 S, J, row0, slot0, int(seg_rel), stride, mrows // n,
                 ptr(colptr), ptr(rows), ptr(vals), ptr(B), ptr(out), ptr(g),
                 ptr(ties),
                 *(ptr(None if split is None else getattr(split, name))
                   for name in _SPLIT),
                 ptr(grad_B), ptr(partials), ptr(partial),
                 torch.cuda.current_stream(B.device).cuda_stream)
    raise_on(err, err_str, f"spmm_minmax_vjp at n={n} cols={ncols} K={K} "
             f"segments={S} dtype={B.dtype}")
    vjp_launches += 1
    vjp_carry_launches += int(J > 0)
    vjp_edge_walks += slabs
    # Slab partials summed in slab order: deterministic.
    return grad_B, (None if partials is None
                    else partials.sum(0).view(n, stride))
