"""The yardstick: published peaks of one H100 and the work of a step.

Copied from ``gespmm_tpu_torch/utils/profiling.py`` (``bound``,
``spmm_bytes`` and the peaks) so that a change to the program cannot move
it.  The peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W:
3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor cores.  Work
is counted from shapes alone, whatever implements it: each input byte read
once and each output byte written once.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

H100_HBM_GBPS = 3350.0
H100_F32_GFLOPS = 67_000.0


def bound(bytes_moved: float, flops: float,
          peak_gflops: float = H100_F32_GFLOPS,
          hbm_gbps: float = H100_HBM_GBPS) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time for the work and
    the term that sets it."""
    t_bytes = bytes_moved / (hbm_gbps * 1e9)
    t_ops = flops / (peak_gflops * 1e9)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spmm_bytes(nnz: int, m: int, k: int, n: Optional[int] = None,
               valued: bool = False, itemsize: int = 4) -> int:
    """Bytes of a CSR SpMM, each input read once and the output written
    once: indptr and int32 indices, f32 values when ``valued``, B (n, k)
    and out (m, k) of ``itemsize``."""
    n = m if n is None else n
    return ((m + 1) * 4 + nnz * 4 + (nnz * 4 if valued else 0)
            + n * k * itemsize + m * k * itemsize)


def spmm_flops(nnz: int, k: int) -> int:
    """A multiply and an add for every nonzero and column."""
    return 2 * nnz * k


def spmm_bound_s(calls: Iterable[Tuple[int, int, int]]) -> float:
    """The least time of a step's SpMM calls, each (n, nnz, K) over a square
    binary adjacency, each bounded alone."""
    return sum(bound(spmm_bytes(nnz, n, k), spmm_flops(nnz, k))[0]
               for n, nnz, k in calls)


def matmul_flops(m: int, k: int, n: int) -> int:
    """An (m, k) @ (k, n) product."""
    return 2 * m * k * n
