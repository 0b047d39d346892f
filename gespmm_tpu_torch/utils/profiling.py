"""Roofline arithmetic and the card's stream bandwidth — port of part of
``gespmm_tpu/utils/profiling.py`` (``spmm_roofline``,
``measure_hbm_bandwidth``).

The least time a card could take for a piece of work is the larger of its
bytes over the memory rate and its operations over the peak rate for their
type.  Bytes count each input byte read once and each output byte written
once, whatever a kernel reads again.  The peaks are the published ones of
an H100 SXM (NVIDIA's data sheet, dense): 3.35 TB/s HBM3, 67 TFLOP/s in f32
outside the tensor cores, 989 TFLOP/s bf16 on the tensor cores, at the full
700 W power limit.  The JAX package's ``spmm_stream_roofline`` is not
ported: it bounds the TPU's two-phase gather/stream algorithm, which the
CUDA kernels do not have.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

H100_HBM_GBPS = 3350.0
H100_F32_GFLOPS = 67_000.0
H100_BF16_TC_GFLOPS = 989_000.0


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


def dot_attention_work(kind: str, m: int, n: int, nnz: int, K: int,
                       Ka: int) -> Tuple[int, int]:
    """(bytes, operations) of one f32 dot-attention kernel call (kernel row
    6), ``kind`` "dot_fwd" | "dot_bwd_rows" | "dot_bwd_cols": each input
    read once and each output written once (the CSR's, or for the CSC
    backward the CSC's, indptr and indices; D1, D2, B; g and the row-side
    mx, den, s backward), and the per-edge work (2 operations a column of
    each dot and of each accumulated row, the logit's exp and weights)."""
    idx = ((n if kind == "dot_bwd_cols" else m) + 1) * 4 + nnz * 4
    tables = (m + n) * Ka * 4 + n * K * 4
    if kind == "dot_fwd":  # out, mx, den
        return idx + tables + m * K * 4 + 2 * m * 4, nnz * (2 * Ka + 2 * K + 6)
    if kind == "dot_bwd_rows":  # g, mx, den, s in; grad_D1 out
        return (idx + tables + m * K * 4 + 3 * m * 4 + m * Ka * 4,
                nnz * (4 * Ka + 2 * K + 10))
    # g, mx, den, s in; grad_D2, grad_B out
    return (idx + tables + m * K * 4 + 3 * m * 4 + n * Ka * 4 + n * K * 4,
            nnz * (4 * Ka + 4 * K + 10))


def edge_reduce_work(m: int, nnz: int, K: int) -> Tuple[int, int]:
    """(bytes, operations) of one f32 edge segment reduce (kernel row 4):
    indptr, the (nnz, K) values and the (m, K) out (the kernel reads no
    column index); one add or compare a value."""
    return (m + 1) * 4 + (nnz + m) * K * 4, nnz * K


def spmm_roofline(nnz: int, m: int, k: int, measured_s: float,
                  n: Optional[int] = None, valued: bool = False,
                  itemsize: int = 4, hbm_gbps: float = H100_HBM_GBPS,
                  peak_gflops: float = H100_F32_GFLOPS) -> Dict[str, float]:
    """Roofline of a CSR SpMM that took ``measured_s`` on the card.

    ``speed_of_light_s`` is the larger of ``spmm_bytes`` over the memory
    rate and 2·nnz·k over the f32 peak; ``bound_by`` names the larger.
    """
    bytes_moved = spmm_bytes(nnz, m, k, n, valued, itemsize)
    flops = 2.0 * nnz * k
    sol_s, bound_by = bound(bytes_moved, flops, peak_gflops, hbm_gbps)
    return {
        "bytes_moved": float(bytes_moved),
        "flops": flops,
        "speed_of_light_s": sol_s,
        "bound_by": bound_by,
        "achieved_gflops": flops / measured_s / 1e9,
        "sol_gflops": flops / sol_s / 1e9,
        "fraction_of_roofline": sol_s / measured_s,
    }


def measure_hbm_bandwidth(size_mb: int = 256, device="cuda") -> float:
    """Measured device stream bandwidth (GB/s): device time of a copy of
    ``size_mb`` MiB of f32, one read and one write per element (to be read
    beside the published H100_HBM_GBPS)."""
    from gespmm_tpu_torch.utils import timing

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"measure_hbm_bandwidth needs a CUDA device, got "
                         f"{device}")
    x = torch.ones(size_mb * (1 << 20) // 4, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    t = timing.device_time(lambda: y.copy_(x), iters=20)
    return 2 * x.numel() * 4 / t / 1e9
