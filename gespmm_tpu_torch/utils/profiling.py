"""Profiling and roofline arithmetic — port of ``gespmm_tpu/utils/profiling.py``
(``trace``, ``op_cost_table``, ``spmm_roofline``, ``measure_hbm_bandwidth``).

``trace(log_dir)`` is a ``torch.profiler`` context that writes a Chrome
trace into ``log_dir``; ``op_cost_table(fn, *args)`` counts the flops of
``fn(*args)`` with ``torch.utils.flop_counter.FlopCounterMode``.  The count
sees only the ops that reach PyTorch's dispatcher: the port's kernels are
launched through ctypes and never do, so an ``spmm`` on the card counts 0
flops there (on the CPU its plain version's ops are counted).  The bounds
below stay the yardstick of the kernels.

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

import contextlib
import os
from typing import Callable, Dict, Optional, Tuple

import torch

H100_HBM_GBPS = 3350.0
H100_F32_GFLOPS = 67_000.0
H100_BF16_TC_GFLOPS = 989_000.0


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(log_dir) as prof: step()``: a ``torch.profiler.profile``
    of the CPU, and of CUDA when a card is present, whose Chrome trace
    (``*.pt.trace.json``) is written into ``log_dir`` on exit; ``prof``
    gives the events."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def op_cost_table(fn: Callable, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` under ``FlopCounterMode``: {"flops": the total,
    and one entry an op that counted}.  Ops outside the dispatcher (the
    ctypes kernels) count nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    table = {"flops": float(counter.get_total_flops())}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        table[str(op)] = float(n)
    return table


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
