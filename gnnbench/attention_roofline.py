"""The work of the fused GAT op's three walks (kernel row 5,
``gespmm_tpu_torch/csrc/gat_fused.cu``), from shapes alone.

A call over m rows, n columns, nnz edges, H heads and K = H·dh f32 columns.
Bytes count each input read once and each output written once, whatever
the kernel reads again (the edges' B or g rows are gathered about nnz / n
times each), int32 indices and f32 tables:

* ``fwd`` (over the CSR): indptr, indices, src (m, H), dst (n, H) and B
  (n, K) in; out (m, K), mx and den (m, H) out;
* ``bwd_rows`` (over the CSR, to the source scores): the forward's inputs
  and g (m, K), out (m, K), mx, den and s_row (m, H) in, out for s_row =
  <g, out> per head, which the op forms before the walk; grad_src (m, H)
  out;
* ``bwd_cols`` (over the CSC, to B and the destination scores): colptr
  (n + 1) and rows (nnz) in place of the CSR's, src, dst, B, g, mx, den and
  s_row in; grad_B (n, K) and grad_dst (n, H) out.

Operations: two (a multiply and an add) for every edge and column a walk
accumulates (the forward's weighted sum, the CSR backward's w·B, the CSC
backward's alpha·g and w·g), two for every row and column of a dot taken
once a row (s_row and the CSR backward's <g, acc>, the CSC backward's
<B, acc>), and for every edge and head the logit's sum, LeakyReLU, shift,
exp and sums: 6 forward, 8 over the CSR, 10 over the CSC.  Each call is
bounded alone by ``roofline.bound``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from gnnbench.roofline import bound

KINDS = ("fwd", "bwd_rows", "bwd_cols")


def gat_work(kind: str, m: int, n: int, nnz: int, K: int,
             H: int) -> Tuple[int, int]:
    """(bytes, operations) of one walk of ``kind``."""
    tables = (m + n) * H * 4 + n * K * 4  # src, dst, B
    if kind == "fwd":
        return ((m + 1) * 4 + nnz * 4 + tables + m * K * 4 + 2 * m * H * 4,
                nnz * (2 * K + 6 * H))
    if kind == "bwd_rows":
        return ((m + 1) * 4 + nnz * 4 + tables + 2 * m * K * 4
                + 3 * m * H * 4 + m * H * 4,
                nnz * (2 * K + 8 * H) + 4 * m * K)
    if kind == "bwd_cols":
        return ((n + 1) * 4 + nnz * 4 + tables + m * K * 4 + 3 * m * H * 4
                + n * K * 4 + n * H * 4,
                nnz * (4 * K + 10 * H) + 2 * n * K)
    raise ValueError(f"unknown walk {kind!r}; expected one of {KINDS}")


def gat_bound_s(calls: Iterable[Tuple[int, int, int, int, int]]) -> float:
    """The least time of a step's fused calls, each (m, n, nnz, K, H)
    walked forward and twice backward, each walk bounded alone."""
    return sum(bound(*gat_work(kind, *call))[0]
               for call in calls for kind in KINDS)
