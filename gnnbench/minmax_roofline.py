"""The work of the max/min SpMM's walks (kernel rows 2 and 3,
``gespmm_tpu_torch/csrc/spmm_minmax.cu``), from shapes alone.

A call over a square binary adjacency of n rows and nnz nonzeros and an
(n, K) f32 table B.  Bytes count each input read once and each output
written once, whatever the kernel reads again (an edge's B row forward, or
its out, g and ties rows backward, are gathered about nnz / n times each),
int32 indices and f32 tables:

* ``fwd`` (row 2, over the CSR): indptr (n + 1), indices (nnz) and B in;
  out and the ties (n, K) out;
* ``bwd`` (row 3, over the CSC): colptr (n + 1), rows (nnz), B, out, g and
  ties in; grad_B (n, K) out.

Operations, a nonzero and column: forward a compare and a count update,
2; backward a compare, the share g/ties and an add, 3.  Each walk is
bounded alone by ``roofline.bound``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from gnnbench.roofline import bound

DIRECTIONS = ("fwd", "bwd")


def minmax_work(n: int, nnz: int, K: int, direction: str) -> Tuple[int, int]:
    """(bytes, operations) of one walk of ``direction``."""
    index = (n + 1) * 4 + nnz * 4
    table = n * K * 4
    if direction == "fwd":
        return index + 3 * table, 2 * nnz * K
    if direction == "bwd":
        return index + 5 * table, 3 * nnz * K
    raise ValueError(f"unknown walk {direction!r}; expected one of "
                     f"{DIRECTIONS}")


def minmax_bound_s(calls: Iterable[Tuple[int, int, int, str]]) -> float:
    """The least time of a step's max/min walks, each (n, nnz, K,
    direction), each bounded alone."""
    return sum(bound(*minmax_work(*call))[0] for call in calls)
