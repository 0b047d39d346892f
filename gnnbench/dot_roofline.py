"""The work of the fused dot-attention op's three walks (kernel row 6,
``gespmm_tpu_torch/csrc/dot_attention.cu``), from shapes alone.

A call over m rows, n columns, nnz edges, H heads, D1 (m, Ka), D2 (n, Ka)
and B (n, K) f32 tables in head blocks, and, where ``masked``, the
attention dropout's (nnz, H) byte mask in CSR edge order.  Bytes count each
input read once and each output written once, whatever the kernel reads
again (an edge's D2 and B rows, or D1 and g rows, are gathered about
nnz / n times each), int32 indices and f32 tables:

* ``fwd`` (over the CSR): indptr, indices, D1, D2, B and the mask in; out
  (m, K), mx and den (m, H) out;
* ``bwd_rows`` (over the CSR, to D1): the forward's inputs and g (m, K),
  out (m, K), mx, den and s_row (m, H) in, out for s_row = <g, out> per
  head, which the op forms before the walk; grad_D1 (m, Ka) out;
* ``bwd_cols`` (over the CSC, to D2 and B): colptr (n + 1) and rows (nnz)
  in place of the CSR's, with the mask the CSC's edge permutation (nnz
  int32), D1, D2, B, g, the mask, mx, den and s_row in; grad_D2 (n, Ka) and
  grad_B (n, K) out.

Operations: two (a multiply and an add) for every edge and column of each
dot a walk takes (the forward's <D1, D2>, the backward's <D1, D2> and
<g, B>) and of each row it accumulates (the forward's weighted sum of B,
the CSR backward's of D2, the CSC backward's of D1 and of g), two for every
row and column of s_row, and for every edge and head the logit's scale,
maximum, shift, exp, sum and edge factor: 6 forward, 10 backward.  Each
walk is bounded alone by ``roofline.bound``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from gnnbench.roofline import bound

KINDS = ("fwd", "bwd_rows", "bwd_cols")


def dot_work(kind: str, m: int, n: int, nnz: int, K: int, Ka: int, H: int,
             masked: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of one walk of ``kind``."""
    tables = (m + n) * Ka * 4 + n * K * 4  # D1, D2, B
    mask = nnz * H if masked else 0
    small = m * H * 4  # one of mx, den, s_row
    if kind == "fwd":
        return ((m + 1) * 4 + nnz * 4 + tables + mask + m * K * 4 + 2 * small,
                nnz * (2 * Ka + 2 * K + 6 * H))
    if kind == "bwd_rows":
        return ((m + 1) * 4 + nnz * 4 + tables + mask + 2 * m * K * 4
                + 3 * small + small + m * Ka * 4,
                nnz * (4 * Ka + 2 * K + 10 * H) + 2 * m * K)
    if kind == "bwd_cols":
        perm = nnz * 4 if masked else 0
        return ((n + 1) * 4 + nnz * 4 + perm + tables + mask + m * K * 4
                + 3 * small + n * Ka * 4 + n * K * 4,
                nnz * (4 * Ka + 4 * K + 10 * H))
    raise ValueError(f"unknown walk {kind!r}; expected one of {KINDS}")


def dot_bound_s(calls: Iterable[Tuple[int, int, int, int, int, int]],
                masked: bool = False) -> float:
    """The least time of a step's fused calls, each (m, n, nnz, K, Ka, H)
    walked forward and twice backward, each walk bounded alone."""
    return sum(bound(*dot_work(kind, *call, masked=masked))[0]
               for call in calls for kind in KINDS)
