"""Launches of kernel rows 5 and 6, the fused attention kernels — port of
the Pallas passes of ``gespmm_tpu/kernels/gat_fused.py``.

Row 5 is GATv1's additive attention,

    out[r] = Σ_c softmax_c(leaky(src[r] + dst[c])) · B[c]   per head,

as three hand-written CUDA kernels in ``csrc/gat_fused.cu``:

  * ``gat_forward``: (out, mx, den) over the CSR, replacing ``_forward``;
  * ``gat_backward_rows``: grad_src over the CSR, replacing the pass of
    ``_gat_bwd`` over ``plan``;
  * ``gat_backward_cols``: (grad_dst, grad_B) over the CSC, replacing the
    pass of ``_gat_bwd`` over ``plan_t``.

Rows (columns) longer than the split's L edges are walked in segments by
separate warps, and a carry pass merges each long row's partial states in
segment order (``Adjacency.split`` for the forward and the CSR backward,
``Adjacency.split_t`` for the CSC backward).  The backward recomputes every
per-edge factor from the node tables and the forward's residuals ``mx``
(the softmax shift) and ``den`` (the clamped denominator), with
``s = <g, out>`` per head taken from the STORED ``out`` as the JAX package
takes it.  A tensor on the CPU goes to the plain versions
(``ops/reference.py``); a CUDA tensor launches the kernels or raises —
there is no fallback.  ``launches``, ``bwd_rows_launches`` and
``bwd_cols_launches`` count the launches of each kernel;
``carry_launches``, ``bwd_rows_carry_launches`` and
``bwd_cols_carry_launches`` their carry passes (the CSC backward's two
carries, grad_B and grad_dst, count two); ``edge_walks`` the walks of the
edges by all three kernels: a launch walks them once for every group of
``launch_shape``'s NS K slabs, once in all where NS covers K.

Row 6 is dot-product attention, per head h of H (D1, D2 and B in head
blocks), with a scale sc and an edge factor m~ (the dropout mask's
1/keep_prob or 0 a (edge, head), applied after the softmax),

    out[r]_h = Σ_c softmax_c(act(sc·<D1[r], D2[c]>_h)) · m~ · B[c]_h,

as the three kernels of ``csrc/dot_attention.cu``: ``dot_forward``
(replacing ``_dot_forward``), ``dot_backward_rows`` (grad_D1, the pass of
``_dot_bwd`` over ``plan``) and ``dot_backward_cols`` (grad_D2 and grad_B,
its pass over ``plan_t``), with the same splits and the same CPU route,
counted by ``dot_launches``, ``dot_bwd_rows_launches`` and
``dot_bwd_cols_launches`` and their carries by ``dot_carry_launches``,
``dot_bwd_rows_carry_launches`` and ``dot_bwd_cols_carry_launches`` (two a
CSC call with segments); ``dot_edge_walks`` counts their walks of the
edges.  One head with no scale and no mask runs the single-head kernels,
which walk the edges once a K (Ka) slab of their ``dot_walk_shape``;
anything else runs the multi-head kernels at a ``dot_heads_shape``, one
walk a launch for every head and slab, with a head's dot summed over a
group of ``dot_head_group`` lanes by one butterfly where G > 0
(``dot_grouped_walks`` counts those walks) and head by head where G = 0.
Their row-side tables (mx, den, s_row) are (m, H), and (m,) at one head.

The ops over both rows, ``gat_attention_aggregate`` and
``dot_attention_aggregate`` with their autograd Functions, are in
``ops/graph.py``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from gespmm_tpu_torch.kernels._build import load_library
from gespmm_tpu_torch.kernels.spmm_csr import (_SPLIT, check_operands,
                                               check_split, check_table,
                                               raise_on, walk_shape)
from gespmm_tpu_torch.ops import reference
from gespmm_tpu_torch.sparse.formats import expand_indptr
from gespmm_tpu_torch.sparse.partition import RowSplit, build_row_split

Tensor = torch.Tensor

SOURCE = "gespmm_tpu_torch/csrc/gat_fused.cu"
REPLACES = "gespmm_tpu/kernels/gat_fused.py:103"
BWD_ROWS_REPLACES = "gespmm_tpu/kernels/gat_fused.py:223"
BWD_COLS_REPLACES = "gespmm_tpu/kernels/gat_fused.py:260"
MAX_MODES = ("exact", "bound")

DOT_SOURCE = "gespmm_tpu_torch/csrc/dot_attention.cu"
DOT_REPLACES = "gespmm_tpu/kernels/gat_fused.py:317"
DOT_BWD_ROWS_REPLACES = "gespmm_tpu/kernels/gat_fused.py:401"
DOT_BWD_COLS_REPLACES = "gespmm_tpu/kernels/gat_fused.py:430"

launches = 0
bwd_rows_launches = 0
bwd_cols_launches = 0
carry_launches = 0
bwd_rows_carry_launches = 0
bwd_cols_carry_launches = 0
edge_walks = 0
dot_launches = 0
dot_bwd_rows_launches = 0
dot_bwd_cols_launches = 0
dot_carry_launches = 0
dot_bwd_rows_carry_launches = 0
dot_bwd_cols_carry_launches = 0
dot_edge_walks = 0
dot_grouped_walks = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_F32 = torch.float32


def reset_launches() -> None:
    global launches, bwd_rows_launches, bwd_cols_launches
    global carry_launches, bwd_rows_carry_launches, bwd_cols_carry_launches
    global edge_walks
    global dot_launches, dot_bwd_rows_launches, dot_bwd_cols_launches
    global dot_carry_launches, dot_bwd_rows_carry_launches
    global dot_bwd_cols_carry_launches, dot_edge_walks, dot_grouped_walks
    launches = bwd_rows_launches = bwd_cols_launches = 0
    carry_launches = bwd_rows_carry_launches = bwd_cols_carry_launches = 0
    edge_walks = 0
    dot_launches = dot_bwd_rows_launches = dot_bwd_cols_launches = 0
    dot_carry_launches = dot_bwd_rows_carry_launches = 0
    dot_bwd_cols_carry_launches = dot_edge_walks = dot_grouped_walks = 0


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype: torch.dtype):
    """(entry point, error-string function) of ``kind`` "fwd"/"bwd_rows"/"bwd_cols"."""
    lib = load_library("gat_fused")
    fn = getattr(lib, f"gespmm_gat_{kind}_{_SUFFIX[dtype]}")
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    split = [i] * 3 + [p] * 4  # L, S, J and the four lists
    fn.argtypes = {"fwd": [i] * 7 + [f] + split + [p] * 12,
                   "bwd_rows": [i] * 6 + [f] + split + [p] * 12,
                   "bwd_cols": [i] * 6 + [f] + split + [p] * 14}[kind]
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _f32(t: Tensor) -> Tensor:
    return t.to(_F32).contiguous()


def _heads_of(B: Tensor, heads: int) -> int:
    if heads < 1 or B.shape[1] % heads:
        raise ValueError(f"B has {B.shape[1]} columns, not a multiple of "
                         f"heads={heads}")
    return heads


# --- the walk's launch shape and split ------------------------------------

# The K slabs a walker of lane vector VEC holds at once where it holds more
# than one, as csrc/gat_fused.cu's ``dispatch_walk`` instantiates them: only
# on whole warps (SW = 32, the only walkers whose K spans several slabs), at
# the products GAT's K = 512 (VEC 4, 4 slabs) and K = 188 (VEC 1, 6 slabs).
# Every other (VEC, SW) holds one slab a walk.
WALK_SLABS = {4: 4, 1: 6}
# The most bytes of [head][edge] tables a block of walkers holding several
# slabs may take: the default without an opt-in, a fifth of an SM's shared
# memory, so that the tables never cost a block of occupancy that the
# registers allow.
SLAB_TABLE_BYTES = 48 * 1024
_THREADS = 256  # a block of walkers (carry.cuh::kThreads)


def heads_per_slab(K: int, dh: int, width: int) -> int:
    """The most heads that any run of ``width`` columns of K, from a
    multiple of ``width``, touches (gat_fused.cu's ``heads_per_slab``)."""
    return max((min(K, k0 + width) - 1) // dh - k0 // dh + 1
               for k0 in range(0, K, width))


def launch_shape(K: int, heads: int, tables: int, *tensors: Tensor):
    """(VEC, SW, NS) of a fused GAT kernel: ``walk_shape``'s lanes and
    lane vector, and NS, how many of K's slabs of SW·VEC columns a walker
    holds at once, so that it walks the edges ceil(slabs / NS) times.  NS is
    ``WALK_SLABS``' value at VEC on a whole warp where it divides the slabs,
    every group of NS slabs touches at most SW heads (lane j holds head j's
    row-side entries), and the group's ``tables`` [head][edge] tables a
    walker (1 forward and over the CSR, 3 over the CSC) fit
    ``SLAB_TABLE_BYTES`` a block; else 1, a walk a slab."""
    vec, sw = walk_shape(K, heads, *tensors)
    dh, width = K // heads, sw * vec
    ns = WALK_SLABS.get(vec, 1) if sw == 32 else 1
    nh = heads_per_slab(K, dh, ns * width)
    if (-(-K // width) % ns == 0 and nh <= sw
            and (_THREADS // sw) * tables * nh * (sw + 1) * 4
            <= SLAB_TABLE_BYTES):
        return vec, sw, ns
    return vec, sw, 1


def _walked(K: int, vec: int, sw: int, ns: int) -> None:
    """Count a launch's walks of the edges in ``edge_walks``."""
    global edge_walks
    edge_walks += -(-K // (sw * vec)) // ns


# --- the walk's split ------------------------------------------------------


def _split_args(split: RowSplit, device: torch.device):
    """(L, S, J, seg_row, seg_start, long_rows, seg_ptr pointers) of a row
    split on ``device``."""
    check_split(split, device)
    return (split.seg_len, split.num_segments, split.num_long_rows,
            *(getattr(split, name).data_ptr() for name in _SPLIT))


def _scratch(rows: int, cols: int, device: torch.device) -> Optional[Tensor]:
    """An f32 (rows, cols) scratch buffer of the segments' partial states, or
    None without a segment."""
    return (torch.empty((rows, cols), dtype=_F32, device=device) if rows
            else None)


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


# --- forward -------------------------------------------------------------


def gat_forward(indptr: Tensor, indices: Tensor, src2: Tensor, dst2: Tensor,
                B: Tensor, *, slope: float = 0.2, heads: int = 1,
                max_mode: str = "exact", rows: Optional[Tensor] = None,
                split: Optional[RowSplit] = None):
    """(out, mx, den) of the fused forward over the CSR (indptr, indices).

    src2 (m, H), dst2 (n, H), B (n, H·dh).  ``out`` takes B's dtype; ``mx``
    and ``den`` (m, H) are f32 (f64 from the plain version for f64 inputs).
    In "bound" mode the shift leaky(src + max_c dst) is computed with torch
    ops and handed to the kernel, as the JAX package computes it outside
    Pallas.  ``split`` is the CSR's row split on B's device
    (``Adjacency.split``); without one, a CUDA call builds it from a host
    copy of ``indptr``, which synchronises.  ``rows`` (the expanded indptr)
    is used only by the plain version.
    """
    if max_mode not in MAX_MODES:
        raise ValueError(f"max_mode must be exact|bound, got {max_mode!r}")
    m = indptr.shape[0] - 1
    if B.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, indices.shape[0])
        return reference.gat_fused_rows(rows, indices, src2, dst2, B, m, slope,
                                        max_mode, heads)
    src2, dst2 = _f32(src2), _f32(dst2)
    mx = (reference.gat_bound_shift(src2, dst2, slope) if max_mode == "bound"
          else None)
    return gat_forward_cuda(indptr, indices, src2, dst2, B, slope, heads, mx,
                            split)


def gat_forward_cuda(indptr: Tensor, indices: Tensor, src2: Tensor,
                     dst2: Tensor, B: Tensor, slope: float, heads: int,
                     mx: Optional[Tensor] = None,
                     split: Optional[RowSplit] = None):
    """Launch the forward kernel, and its carry when the split has a
    segment, on the current stream of B's device.  With ``mx`` given (f32
    (m, H)) the kernel shifts by it and takes no maximum.  ``split`` as in
    ``gat_forward``."""
    global launches, carry_launches
    check_operands(indptr, indices, None, B)
    H = _heads_of(B, heads)
    m, (n, K) = indptr.shape[0] - 1, B.shape
    check_table("src", src2, (m, H), _F32, B.device)
    check_table("dst", dst2, (n, H), _F32, B.device)
    if mx is not None:
        check_table("mx", mx, (m, H), _F32, B.device)
    if m == 0 or K == 0 or indices.shape[0] == 0:
        # Every row is empty: out 0, shift 0, denominator at its floor.
        return (torch.zeros((m, K), dtype=B.dtype, device=B.device),
                torch.zeros((m, H), dtype=_F32, device=B.device)
                if mx is None else mx,
                torch.full((m, H), reference.DENOM_EPS, dtype=_F32,
                           device=B.device))
    if split is None:
        split = build_row_split(indptr).to(B.device)
    fn, err_str = _entry("fwd", B.dtype)
    out = torch.empty((m, K), dtype=B.dtype, device=B.device)
    den = torch.empty((m, H), dtype=_F32, device=B.device)
    exact = mx is None
    if exact:
        mx = torch.empty((m, H), dtype=_F32, device=B.device)
    S = split.num_segments
    pm, pz, pacc = (_scratch(S, H, B.device), _scratch(S, H, B.device),
                    _scratch(S, K, B.device))
    vec, sw, ns = launch_shape(K, H, 1, B, out,
                               *(() if pacc is None else (pacc,)))
    with torch.cuda.device(B.device):
        err = fn(m, K, H, vec, sw, ns, int(exact), float(slope),
                 *_split_args(split, B.device), indptr.data_ptr(),
                 indices.data_ptr(), src2.data_ptr(), dst2.data_ptr(),
                 B.data_ptr(), mx.data_ptr(), out.data_ptr(), den.data_ptr(),
                 _ptr(pm), _ptr(pz), _ptr(pacc), _stream(B))
    raise_on(err, err_str, f"gat forward at m={m} K={K} H={H} vec={vec} "
             f"lanes={sw} slabs={ns} segments={S} dtype={B.dtype}")
    launches += 1
    _walked(K, vec, sw, ns)
    carry_launches += int(S > 0)
    return out, mx, den


# --- backward ------------------------------------------------------------


def gat_backward_rows(indptr: Tensor, indices: Tensor, src2: Tensor,
                      dst2: Tensor, B: Tensor, g: Tensor, mx: Tensor,
                      den: Tensor, s_row: Tensor, *, slope: float = 0.2,
                      heads: int = 1, rows: Optional[Tensor] = None,
                      split: Optional[RowSplit] = None) -> Tensor:
    """grad_src (m, H) = Σ_{e in row r} dpre_e over the CSR, with
    dpre = alpha·(<g[r], B[c]>_h − s[r])·leaky'(pre).  f32 (f64 from the
    plain version for f64 inputs).  ``split``: the CSR's row split, as in
    ``gat_forward``; ``rows`` is used only by the plain version."""
    m = indptr.shape[0] - 1
    if B.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, indices.shape[0])
        return reference.gat_fused_vjp_rows(rows, indices, src2, dst2, B, g,
                                            mx, den, s_row, m, slope, heads)
    return gat_backward_rows_cuda(indptr, indices, _f32(src2), _f32(dst2), B,
                                  _f32(g), _f32(mx), _f32(den), _f32(s_row),
                                  slope, heads, split)


def _check_bwd_tables(m, n, K, H, B, src2, dst2, g, mx, den, s_row) -> None:
    check_table("src", src2, (m, H), _F32, B.device)
    check_table("dst", dst2, (n, H), _F32, B.device)
    check_table("g", g, (m, K), _F32, B.device)
    for name, t in (("mx", mx), ("den", den), ("s_row", s_row)):
        check_table(name, t, (m, H), _F32, B.device)


def gat_backward_rows_cuda(indptr: Tensor, indices: Tensor, src2: Tensor,
                           dst2: Tensor, B: Tensor, g: Tensor, mx: Tensor,
                           den: Tensor, s_row: Tensor, slope: float,
                           heads: int, split: Optional[RowSplit] = None
                           ) -> Tensor:
    """Launch the backward kernel over the CSR, and the sum carry of its
    segments' H-wide partials when the split has one, on B's device's
    stream."""
    global bwd_rows_launches, bwd_rows_carry_launches
    check_operands(indptr, indices, None, B)
    H = _heads_of(B, heads)
    m, (n, K) = indptr.shape[0] - 1, B.shape
    _check_bwd_tables(m, n, K, H, B, src2, dst2, g, mx, den, s_row)
    if m == 0 or K == 0 or indices.shape[0] == 0:
        return torch.zeros((m, H), dtype=_F32, device=B.device)
    if split is None:
        split = build_row_split(indptr).to(B.device)
    fn, err_str = _entry("bwd_rows", B.dtype)
    grad_src = torch.empty((m, H), dtype=_F32, device=B.device)
    S = split.num_segments
    part = _scratch(S, H, B.device)
    vec, sw, ns = launch_shape(K, H, 1, B, g)
    with torch.cuda.device(B.device):
        err = fn(m, K, H, vec, sw, ns, float(slope),
                 *_split_args(split, B.device),
                 indptr.data_ptr(), indices.data_ptr(), src2.data_ptr(),
                 dst2.data_ptr(), B.data_ptr(), g.data_ptr(), mx.data_ptr(),
                 den.data_ptr(), s_row.data_ptr(), grad_src.data_ptr(),
                 _ptr(part), _stream(B))
    raise_on(err, err_str, f"gat backward (rows) at m={m} K={K} H={H} "
             f"vec={vec} lanes={sw} slabs={ns} segments={S} dtype={B.dtype}")
    bwd_rows_launches += 1
    _walked(K, vec, sw, ns)
    bwd_rows_carry_launches += int(S > 0)
    return grad_src


def gat_backward_cols(colptr: Tensor, rows: Tensor, src2: Tensor,
                      dst2: Tensor, B: Tensor, g: Tensor, mx: Tensor,
                      den: Tensor, s_row: Tensor, *, slope: float = 0.2,
                      heads: int = 1, cols: Optional[Tensor] = None,
                      split: Optional[RowSplit] = None):
    """(grad_dst (n, H), grad_B (n, K)) over the CSC (colptr, rows):
    grad_dst[c] = Σ_{e in col c} dpre_e and grad_B[c] = Σ_{e in col c}
    alpha_e·g[r_e] per head block.  grad_dst is f32 and grad_B takes B's
    dtype (the plain version returns both in the accumulation dtype).
    ``split``: the CSC's column split (``Adjacency.split_t``), as in
    ``gat_forward``; ``cols`` (the expanded colptr) is used only by the
    plain version."""
    if B.device.type == "cpu":
        if cols is None:
            cols = expand_indptr(colptr, rows.shape[0])
        return reference.gat_fused_vjp_cols(rows, cols, src2, dst2, B, g, mx,
                                            den, s_row, slope, heads)
    return gat_backward_cols_cuda(colptr, rows, _f32(src2), _f32(dst2), B,
                                  _f32(g), _f32(mx), _f32(den), _f32(s_row),
                                  slope, heads, split)


def gat_backward_cols_cuda(colptr: Tensor, rows: Tensor, src2: Tensor,
                           dst2: Tensor, B: Tensor, g: Tensor, mx: Tensor,
                           den: Tensor, s_row: Tensor, slope: float,
                           heads: int, split: Optional[RowSplit] = None):
    """Launch the backward kernel over the CSC, and the sum carries of its
    segments' grad_B and grad_dst partials (two launches) when the split has
    a segment, on B's device's stream."""
    global bwd_cols_launches, bwd_cols_carry_launches
    check_operands(colptr, rows, None, B)
    H = _heads_of(B, heads)
    n, K = B.shape
    if colptr.shape[0] - 1 != n:
        raise ValueError(f"the CSC has {colptr.shape[0] - 1} columns, B has "
                         f"{n} rows")
    m = src2.shape[0]
    _check_bwd_tables(m, n, K, H, B, src2, dst2, g, mx, den, s_row)
    if n == 0 or K == 0 or rows.shape[0] == 0:
        return (torch.zeros((n, H), dtype=_F32, device=B.device),
                torch.zeros((n, K), dtype=B.dtype, device=B.device))
    if split is None:
        split = build_row_split(colptr).to(B.device)
    fn, err_str = _entry("bwd_cols", B.dtype)
    grad_dst = torch.empty((n, H), dtype=_F32, device=B.device)
    grad_B = torch.empty((n, K), dtype=B.dtype, device=B.device)
    S = split.num_segments
    part_B, part_dst = _scratch(S, K, B.device), _scratch(S, H, B.device)
    vec, sw, ns = launch_shape(K, H, 3, B, g, grad_B,
                               *(() if part_B is None else (part_B,)))
    with torch.cuda.device(B.device):
        err = fn(n, K, H, vec, sw, ns, float(slope),
                 *_split_args(split, B.device),
                 colptr.data_ptr(), rows.data_ptr(), src2.data_ptr(),
                 dst2.data_ptr(), B.data_ptr(), g.data_ptr(), mx.data_ptr(),
                 den.data_ptr(), s_row.data_ptr(), grad_B.data_ptr(),
                 grad_dst.data_ptr(), _ptr(part_B), _ptr(part_dst), _stream(B))
    raise_on(err, err_str, f"gat backward (cols) at n={n} K={K} H={H} "
             f"vec={vec} lanes={sw} slabs={ns} segments={S} dtype={B.dtype}")
    bwd_cols_launches += 1
    _walked(K, vec, sw, ns)
    bwd_cols_carry_launches += 2 * int(S > 0)
    return grad_dst, grad_B


# --- dot-product attention (kernel row 6) ---------------------------------


@functools.lru_cache(maxsize=None)
def _dot_entry(kind: str, dtype: torch.dtype):
    """(entry point, error-string function) of ``kind`` "fwd"/"bwd_rows"/
    "bwd_cols" in ``csrc/dot_attention.cu``: the single-head kernels."""
    lib = load_library("dot_attention")
    fn = getattr(lib, f"gespmm_dot_{kind}_{_SUFFIX[dtype]}")
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    head = [i] * 6 + [f] + [i] * 3 + [p] * 4  # shape, act, split
    fn.argtypes = head + [p] * {"fwd": 12, "bwd_rows": 12, "bwd_cols": 14}[kind]
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


@functools.lru_cache(maxsize=None)
def _dot_heads_entry(kind: str, dtype: torch.dtype):
    """(entry point, error-string function) of the multi-head kernel
    ``kind`` "fwd"/"bwd_rows"/"bwd_cols" in ``csrc/dot_attention.cu``, which
    builds them for an f32 B alone."""
    if dtype != _F32:
        raise TypeError(f"the multi-head dot-attention kernels take an f32 "
                        f"B, got {dtype}")
    lib = load_library("dot_attention")
    fn = getattr(lib, f"gespmm_dot_heads_{kind}_f32")
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    head = [i] * 9 + [f] * 3 + [i] * 3 + [p] * 4  # shape, act, split
    fn.argtypes = head + [p] * {"fwd": 13, "bwd_rows": 13, "bwd_cols": 16}[kind]
    fn.restype = ctypes.c_int
    lib.gespmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gespmm_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.gespmm_cuda_error_string


def _act_args(slope: Optional[float]):
    """(leaky flag, slope) for the kernels: identity act when slope is None."""
    return (0, 0.0) if slope is None else (1, float(slope))


def dot_walk_shape(K: int, Ka: int, *tensors: Tensor):
    """(VEC, SW) of the single-head dot-attention kernels: ``walk_shape``
    over the wider of K and Ka taken as heads of gcd(K, Ka) columns, so that
    VEC divides both widths and SW·VEC covers the wider.  The forward takes
    it from (D1, D2, B), and so do the backward kernels, so that all three
    compute each logit with the same lanes (``csrc/dot_attention.cu``)."""
    wide = max(K, Ka)
    return walk_shape(wide, wide // math.gcd(K, Ka), *tensors)


def _slab_walks(width: int, vec: int, sw: int) -> int:
    """Walks of the edges by a single-head launch: one a slab of SW·VEC
    columns of ``width``."""
    return -(-width // (sw * vec))


# The multi-head walkers that csrc/dot_attention.cu's ``dispatch_heads``
# instantiates, (VEC, SW, NS): whole warps whose lanes hold VEC columns of
# each of NS slabs, so that one walk covers both widths: 2-column lanes and
# one slab (K, Ka <= 64 with even heads: the UniMP cell's hidden layers,
# heads of 32), 1-column lanes and three slabs (K, Ka <= 96: its output
# layer, heads of 47).
DOT_HEAD_WALKS = ((2, 32, 1), (1, 32, 3))


def dot_heads_shape(K: int, Ka: int, heads: int, *tensors: Tensor):
    """(VEC, SW, NS) of the multi-head kernels: the first of
    ``DOT_HEAD_WALKS`` whose VEC divides both head widths (Ka/H, K/H), to
    which every table is aligned, and whose SW·VEC·NS columns cover K and
    Ka.  All three kernels take it from (D1, D2, B), so that each computes
    every logit with the same lanes.  Raises where none covers the widths."""
    dk, dv = Ka // heads, K // heads
    for vec, sw, ns in DOT_HEAD_WALKS:
        if (dk % vec == 0 and dv % vec == 0 and max(K, Ka) <= sw * vec * ns
                and all(t.data_ptr() % (vec * t.element_size()) == 0
                        for t in tensors)):
            return vec, sw, ns
    raise ValueError(
        f"no multi-head walker of csrc/dot_attention.cu covers K={K}, "
        f"Ka={Ka} at heads={heads} (instantiated (VEC, SW, NS): "
        f"{DOT_HEAD_WALKS}; max(K, Ka) <= 96)")


def dot_head_group(K: int, Ka: int, heads: int, vec: int, sw: int,
                   ns: int) -> int:
    """G, the lanes of a head's group in the multi-head walker (VEC, SW, NS)
    (``csrc/dot_attention.cu``'s multi-head walk), or 0 for head by head.
    With K = Ka: a head's dk/VEC lanes where that is a power of two of at
    most SW (the UniMP cell's hidden layers, heads of 32 at (2, 32, 1): 16);
    else the least power of two G whose NS slabs of G·VEC columns cover a
    head, where the H groups fit the walker's SW lanes (its output layer,
    heads of 47 at (1, 32, 3): 16; one head of 94: 32).  0 where K != Ka or
    the groups would not fit (three heads of 30 at (1, 32, 3)).  All three
    kernels take it from the same shape, so that each sums every dot with
    the same lanes in the same order."""
    if K != Ka:
        return 0
    dk = Ka // heads
    g = dk // vec
    if g <= sw and g & (g - 1) == 0:
        return g
    g = 1
    while g * vec * ns < dk:
        g *= 2
    return g if heads * g <= sw else 0


def _heads(K: int, Ka: int, heads: int) -> int:
    if heads < 1 or K % heads or Ka % heads:
        raise ValueError(f"K={K} and Ka={Ka} must be multiples of "
                         f"heads={heads}")
    return int(heads)


def _multi(heads: int, scale: Optional[float],
           edge_keep: Optional[Tensor]) -> bool:
    """Whether a call takes the multi-head kernels: more than one head, a
    scale or a mask (one head with neither takes the single-head ones)."""
    return heads != 1 or scale is not None or edge_keep is not None


def _keep_args(edge_keep: Optional[Tensor], keep_prob: Optional[float],
               nnz: int, heads: int, device: torch.device):
    """(mask pointer or None, 1/keep_prob) for the multi-head kernels."""
    if edge_keep is None:
        return None, 1.0
    if keep_prob is None or not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob must be in (0, 1] with edge_keep, got "
                         f"{keep_prob}")
    if (edge_keep.dtype != torch.bool or edge_keep.device != device
            or tuple(edge_keep.shape) != (nnz, heads)
            or not edge_keep.is_contiguous()):
        raise ValueError(f"edge_keep must be a contiguous bool ({nnz}, "
                         f"{heads}) tensor on {device}, got "
                         f"{edge_keep.dtype} {tuple(edge_keep.shape)} on "
                         f"{edge_keep.device}")
    return edge_keep.data_ptr(), 1.0 / float(keep_prob)


def _row_tables(m: int, heads: int):
    """The shape of the row-side tables mx, den and s_row."""
    return (m,) if heads == 1 else (m, heads)


def _aligned(t: Tensor, vec: int) -> Tensor:
    """``t``, or a copy of it where its start is not aligned to VEC floats
    (a view into a larger buffer): the backward's g must not narrow the
    forward's walker shape."""
    return t if t.data_ptr() % (vec * t.element_size()) == 0 else t.clone()


def _check_dot_tables(m: int, n: int, Ka: int, B: Tensor, D1: Tensor,
                      D2: Tensor) -> None:
    if Ka < 1:
        raise ValueError("the dot-attention kernels need Ka >= 1")
    check_table("D1", D1, (m, Ka), _F32, B.device)
    check_table("D2", D2, (n, Ka), _F32, B.device)


def dot_forward(indptr: Tensor, indices: Tensor, D1: Tensor, D2: Tensor,
                B: Tensor, *, slope: Optional[float] = None, heads: int = 1,
                scale: Optional[float] = None,
                edge_keep: Optional[Tensor] = None,
                keep_prob: Optional[float] = None,
                rows: Optional[Tensor] = None,
                split: Optional[RowSplit] = None):
    """(out, mx, den) of the dot-attention forward over the CSR.

    D1 (m, Ka), D2 (n, Ka), B (n, K), each in ``heads`` head blocks.
    ``out`` takes B's dtype; ``mx`` and ``den`` ((m,) at one head, else
    (m, H)) are f32 (f64 from the plain version for f64 inputs).  ``slope``
    None is the identity act, else leaky ReLU.  ``scale`` multiplies each
    dot before the act; ``edge_keep`` ((nnz, H) bool, CSR edge order)
    multiplies each weight by 1/``keep_prob`` where True and by 0 where
    False.  ``split`` is the CSR's row split on B's device
    (``Adjacency.split``); without one, a CUDA call builds it from a host
    copy of ``indptr``, which synchronises.  ``rows`` (the expanded indptr)
    is used only by the plain version.
    """
    m = indptr.shape[0] - 1
    if B.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, indices.shape[0])
        return reference.dot_attention_rows(
            rows, indices, D1, D2, B, m, slope, heads=heads, scale=scale,
            keep=edge_keep, keep_prob=keep_prob)
    return dot_forward_cuda(indptr, indices, _f32(D1), _f32(D2), B, slope,
                            split, heads=heads, scale=scale,
                            edge_keep=edge_keep, keep_prob=keep_prob)


def dot_forward_cuda(indptr: Tensor, indices: Tensor, D1: Tensor, D2: Tensor,
                     B: Tensor, slope: Optional[float],
                     split: Optional[RowSplit] = None, *, heads: int = 1,
                     scale: Optional[float] = None,
                     edge_keep: Optional[Tensor] = None,
                     keep_prob: Optional[float] = None):
    """Launch the forward kernel, and its softmax carry when the split has a
    segment, on the current stream of B's device."""
    global dot_launches, dot_carry_launches, dot_edge_walks
    global dot_grouped_walks
    check_operands(indptr, indices, None, B)
    m, (n, K), Ka = indptr.shape[0] - 1, B.shape, D1.shape[1]
    _check_dot_tables(m, n, Ka, B, D1, D2)
    H = _heads(K, Ka, heads)
    nnz = indices.shape[0]
    if m == 0 or K == 0 or nnz == 0:
        # Every row is empty: out 0, shift 0, denominator at its floor.
        return (torch.zeros((m, K), dtype=B.dtype, device=B.device),
                torch.zeros(_row_tables(m, H), dtype=_F32, device=B.device),
                torch.full(_row_tables(m, H), reference.DENOM_EPS,
                           dtype=_F32, device=B.device))
    if split is None:
        split = build_row_split(indptr).to(B.device)
    multi = _multi(H, scale, edge_keep)
    out = torch.empty((m, K), dtype=B.dtype, device=B.device)
    mx = torch.empty(_row_tables(m, H), dtype=_F32, device=B.device)
    den = torch.empty(_row_tables(m, H), dtype=_F32, device=B.device)
    S = split.num_segments
    pm, pz, pacc = (_scratch(S, H, B.device), _scratch(S, H, B.device),
                    _scratch(S, K, B.device))
    with torch.cuda.device(B.device):
        if multi:
            fn, err_str = _dot_heads_entry("fwd", B.dtype)
            keep, inv_keep = _keep_args(edge_keep, keep_prob, nnz, H, B.device)
            vec, sw, ns = dot_heads_shape(K, Ka, H, D1, D2, B)
            G = dot_head_group(K, Ka, H, vec, sw, ns)
            err = fn(m, K, Ka, H, vec, sw, ns, G, *_act_args(slope),
                     1.0 if scale is None else float(scale), inv_keep,
                     *_split_args(split, B.device), indptr.data_ptr(),
                     indices.data_ptr(), D1.data_ptr(), D2.data_ptr(),
                     B.data_ptr(), keep, out.data_ptr(), mx.data_ptr(),
                     den.data_ptr(), _ptr(pm), _ptr(pz), _ptr(pacc),
                     _stream(B))
            walks = 1
        else:
            fn, err_str = _dot_entry("fwd", B.dtype)
            vec, sw = dot_walk_shape(K, Ka, D1, D2, B)
            ns, G, walks = 1, 0, _slab_walks(K, vec, sw)
            err = fn(m, K, Ka, vec, sw, *_act_args(slope),
                     *_split_args(split, B.device), indptr.data_ptr(),
                     indices.data_ptr(), D1.data_ptr(), D2.data_ptr(),
                     B.data_ptr(), out.data_ptr(), mx.data_ptr(),
                     den.data_ptr(), _ptr(pm), _ptr(pz), _ptr(pacc),
                     _stream(B))
    raise_on(err, err_str, f"dot forward at m={m} K={K} Ka={Ka} H={H} "
             f"vec={vec} lanes={sw} slabs={ns} group={G} segments={S} "
             f"dtype={B.dtype}")
    dot_launches += 1
    dot_edge_walks += walks
    dot_grouped_walks += walks if G > 0 else 0
    dot_carry_launches += int(S > 0)
    return out, mx, den


def dot_backward_rows(indptr: Tensor, indices: Tensor, D1: Tensor, D2: Tensor,
                      B: Tensor, g: Tensor, mx: Tensor, den: Tensor,
                      s_row: Tensor, *, slope: Optional[float] = None,
                      heads: int = 1, scale: Optional[float] = None,
                      edge_keep: Optional[Tensor] = None,
                      keep_prob: Optional[float] = None,
                      rows: Optional[Tensor] = None,
                      split: Optional[RowSplit] = None) -> Tensor:
    """grad_D1 (m, Ka) = Σ_{e in row r} sc·dpre_e·D2[c_e] per head over the
    CSR, f32 (f64 from the plain version for f64 inputs).  ``heads``,
    ``scale``, ``edge_keep`` and ``keep_prob`` as in ``dot_forward``;
    ``split``: the CSR's row split, as there; ``rows`` is used only by the
    plain version."""
    m = indptr.shape[0] - 1
    if B.device.type == "cpu":
        if rows is None:
            rows = expand_indptr(indptr, indices.shape[0])
        return reference.dot_attention_vjp_rows(
            rows, indices, D1, D2, B, g, mx, den, s_row, m, slope,
            heads=heads, scale=scale, keep=edge_keep, keep_prob=keep_prob)
    return dot_backward_rows_cuda(indptr, indices, _f32(D1), _f32(D2), B,
                                  _f32(g), _f32(mx), _f32(den), _f32(s_row),
                                  slope, split, heads=heads, scale=scale,
                                  edge_keep=edge_keep, keep_prob=keep_prob)


def _check_dot_bwd_tables(m, n, K, Ka, H, B, D1, D2, g, mx, den,
                          s_row) -> None:
    _check_dot_tables(m, n, Ka, B, D1, D2)
    check_table("g", g, (m, K), _F32, B.device)
    for name, t in (("mx", mx), ("den", den), ("s_row", s_row)):
        check_table(name, t, _row_tables(m, H), _F32, B.device)


def dot_backward_rows_cuda(indptr: Tensor, indices: Tensor, D1: Tensor,
                           D2: Tensor, B: Tensor, g: Tensor, mx: Tensor,
                           den: Tensor, s_row: Tensor, slope: Optional[float],
                           split: Optional[RowSplit] = None, *,
                           heads: int = 1, scale: Optional[float] = None,
                           edge_keep: Optional[Tensor] = None,
                           keep_prob: Optional[float] = None) -> Tensor:
    """Launch the backward kernel over the CSR, and the sum carry of its
    segments' Ka-wide partials when the split has one, on B's device's
    stream."""
    global dot_bwd_rows_launches, dot_bwd_rows_carry_launches, dot_edge_walks
    global dot_grouped_walks
    check_operands(indptr, indices, None, B)
    m, (n, K), Ka = indptr.shape[0] - 1, B.shape, D1.shape[1]
    H = _heads(K, Ka, heads)
    _check_dot_bwd_tables(m, n, K, Ka, H, B, D1, D2, g, mx, den, s_row)
    nnz = indices.shape[0]
    if m == 0 or K == 0 or nnz == 0:
        return torch.zeros((m, Ka), dtype=_F32, device=B.device)
    if split is None:
        split = build_row_split(indptr).to(B.device)
    grad_D1 = torch.empty((m, Ka), dtype=_F32, device=B.device)
    S = split.num_segments
    part = _scratch(S, Ka, B.device)
    with torch.cuda.device(B.device):
        if _multi(H, scale, edge_keep):
            fn, err_str = _dot_heads_entry("bwd_rows", B.dtype)
            keep, inv_keep = _keep_args(edge_keep, keep_prob, nnz, H, B.device)
            vec, sw, ns = dot_heads_shape(K, Ka, H, D1, D2, B)
            G = dot_head_group(K, Ka, H, vec, sw, ns)
            g = _aligned(g, vec)
            err = fn(m, K, Ka, H, vec, sw, ns, G, *_act_args(slope),
                     1.0 if scale is None else float(scale), inv_keep,
                     *_split_args(split, B.device), indptr.data_ptr(),
                     indices.data_ptr(), D1.data_ptr(), D2.data_ptr(),
                     B.data_ptr(), g.data_ptr(), keep, mx.data_ptr(),
                     den.data_ptr(), s_row.data_ptr(), grad_D1.data_ptr(),
                     _ptr(part), _stream(B))
            walks = 1
        else:
            fn, err_str = _dot_entry("bwd_rows", B.dtype)
            vec, sw = dot_walk_shape(K, Ka, D1, D2, B)
            ns, G, walks = 1, 0, _slab_walks(Ka, vec, sw)
            g = _aligned(g, vec)
            err = fn(m, K, Ka, vec, sw, *_act_args(slope),
                     *_split_args(split, B.device), indptr.data_ptr(),
                     indices.data_ptr(), D1.data_ptr(), D2.data_ptr(),
                     B.data_ptr(), g.data_ptr(), mx.data_ptr(),
                     den.data_ptr(), s_row.data_ptr(), grad_D1.data_ptr(),
                     _ptr(part), _stream(B))
    raise_on(err, err_str, f"dot backward (rows) at m={m} K={K} Ka={Ka} "
             f"H={H} vec={vec} lanes={sw} slabs={ns} group={G} segments={S} "
             f"dtype={B.dtype}")
    dot_bwd_rows_launches += 1
    dot_edge_walks += walks
    dot_grouped_walks += walks if G > 0 else 0
    dot_bwd_rows_carry_launches += int(S > 0)
    return grad_D1


def dot_backward_cols(colptr: Tensor, rows: Tensor, D1: Tensor, D2: Tensor,
                      B: Tensor, g: Tensor, mx: Tensor, den: Tensor,
                      s_row: Tensor, *, slope: Optional[float] = None,
                      heads: int = 1, scale: Optional[float] = None,
                      edge_keep: Optional[Tensor] = None,
                      keep_prob: Optional[float] = None,
                      perm: Optional[Tensor] = None,
                      cols: Optional[Tensor] = None,
                      split: Optional[RowSplit] = None):
    """(grad_D2 (n, Ka), grad_B (n, K)) over the CSC (colptr, rows), per
    head: grad_D2[c] = Σ_{e in col c} sc·dpre_e·D1[r_e] and grad_B[c] =
    Σ_{e in col c} alpha_e·m~_e·g[r_e].  grad_D2 is f32 and grad_B takes
    B's dtype (the plain version returns both in the accumulation dtype).
    ``heads``, ``scale``, ``edge_keep`` and ``keep_prob`` as in
    ``dot_forward``; ``edge_keep`` is in CSR edge order and read through
    ``perm`` (the CSR position of each CSC edge, ``Adjacency.perm``),
    which it then requires.  ``split``:
    the CSC's column split (``Adjacency.split_t``), as in ``dot_forward``;
    ``cols`` (the expanded colptr) is used only by the plain version."""
    if edge_keep is not None and perm is None:
        raise ValueError("edge_keep needs perm: the mask is in CSR edge "
                         "order")
    if B.device.type == "cpu":
        if cols is None:
            cols = expand_indptr(colptr, rows.shape[0])
        keep = (None if edge_keep is None
                else edge_keep.index_select(0, perm.long()))
        return reference.dot_attention_vjp_cols(
            rows, cols, D1, D2, B, g, mx, den, s_row, slope, heads=heads,
            scale=scale, keep=keep, keep_prob=keep_prob)
    return dot_backward_cols_cuda(colptr, rows, _f32(D1), _f32(D2), B,
                                  _f32(g), _f32(mx), _f32(den), _f32(s_row),
                                  slope, split, heads=heads, scale=scale,
                                  edge_keep=edge_keep, keep_prob=keep_prob,
                                  perm=perm)


def dot_backward_cols_cuda(colptr: Tensor, rows: Tensor, D1: Tensor,
                           D2: Tensor, B: Tensor, g: Tensor, mx: Tensor,
                           den: Tensor, s_row: Tensor, slope: Optional[float],
                           split: Optional[RowSplit] = None, *,
                           heads: int = 1, scale: Optional[float] = None,
                           edge_keep: Optional[Tensor] = None,
                           keep_prob: Optional[float] = None,
                           perm: Optional[Tensor] = None):
    """Launch the backward kernel over the CSC, and the sum carries of its
    segments' grad_B and grad_D2 partials (two launches) when the split has
    a segment, on B's device's stream.  ``edge_keep`` and ``perm`` as in
    ``dot_backward_cols``."""
    global dot_bwd_cols_launches, dot_bwd_cols_carry_launches, dot_edge_walks
    global dot_grouped_walks
    check_operands(colptr, rows, None, B)
    n, K = B.shape
    if colptr.shape[0] - 1 != n:
        raise ValueError(f"the CSC has {colptr.shape[0] - 1} columns, B has "
                         f"{n} rows")
    m, Ka = D1.shape
    H = _heads(K, Ka, heads)
    _check_dot_bwd_tables(m, n, K, Ka, H, B, D1, D2, g, mx, den, s_row)
    nnz = rows.shape[0]
    if n == 0 or K == 0 or nnz == 0:
        return (torch.zeros((n, Ka), dtype=_F32, device=B.device),
                torch.zeros((n, K), dtype=B.dtype, device=B.device))
    if split is None:
        split = build_row_split(colptr).to(B.device)
    grad_D2 = torch.empty((n, Ka), dtype=_F32, device=B.device)
    grad_B = torch.empty((n, K), dtype=B.dtype, device=B.device)
    S = split.num_segments
    part_B, part_D = _scratch(S, K, B.device), _scratch(S, Ka, B.device)
    with torch.cuda.device(B.device):
        if _multi(H, scale, edge_keep):
            fn, err_str = _dot_heads_entry("bwd_cols", B.dtype)
            keep, inv_keep = _keep_args(edge_keep, keep_prob, nnz, H, B.device)
            if keep is not None:
                check_table("perm", perm, (nnz,), torch.int32, B.device)
            vec, sw, ns = dot_heads_shape(K, Ka, H, D1, D2, B)
            G = dot_head_group(K, Ka, H, vec, sw, ns)
            g = _aligned(g, vec)
            err = fn(n, K, Ka, H, vec, sw, ns, G, *_act_args(slope),
                     1.0 if scale is None else float(scale), inv_keep,
                     *_split_args(split, B.device), colptr.data_ptr(),
                     rows.data_ptr(), D1.data_ptr(), D2.data_ptr(),
                     B.data_ptr(), g.data_ptr(), keep,
                     None if keep is None else _ptr(perm), mx.data_ptr(),
                     den.data_ptr(), s_row.data_ptr(), grad_B.data_ptr(),
                     grad_D2.data_ptr(), _ptr(part_B), _ptr(part_D),
                     _stream(B))
            walks = 1
        else:
            fn, err_str = _dot_entry("bwd_cols", B.dtype)
            vec, sw = dot_walk_shape(K, Ka, D1, D2, B)
            ns, G, walks = 1, 0, _slab_walks(max(K, Ka), vec, sw)
            g = _aligned(g, vec)
            err = fn(n, K, Ka, vec, sw, *_act_args(slope),
                     *_split_args(split, B.device), colptr.data_ptr(),
                     rows.data_ptr(), D1.data_ptr(), D2.data_ptr(),
                     B.data_ptr(), g.data_ptr(), mx.data_ptr(),
                     den.data_ptr(), s_row.data_ptr(), grad_B.data_ptr(),
                     grad_D2.data_ptr(), _ptr(part_B), _ptr(part_D),
                     _stream(B))
    raise_on(err, err_str, f"dot backward (cols) at n={n} K={K} Ka={Ka} "
             f"H={H} vec={vec} lanes={sw} slabs={ns} group={G} segments={S} "
             f"dtype={B.dtype}")
    dot_bwd_cols_launches += 1
    dot_edge_walks += walks
    dot_grouped_walks += walks if G > 0 else 0
    dot_bwd_cols_carry_launches += 2 * int(S > 0)
    return grad_D2, grad_B
