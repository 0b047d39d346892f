"""Profiling, the program's spans, and roofline arithmetic — port of
``gespmm_tpu/utils/profiling.py`` (``trace``, ``spmm_roofline``,
``measure_hbm_bandwidth``).

``trace(log_dir)`` is a ``torch.profiler`` context that writes a Chrome
trace into ``log_dir``.

``span(name)`` marks a piece of the program's own work, one of ``SPANS``,
named ``<layer>/<what>``: the train step and its phases, the model's dense
and elementwise work, the sum/mean and the max/min SpMM ops and the fused
GAT and dot-attention ops forward and backward, the phases of
``Adjacency.from_csr`` and the kernel libraries' build and load.  Under
the torch profiler a span is a ``record_function``
range in the same trace as the kernels, on the same clock; inside
``recording()`` it also appends ``(name, start_ns, end_ns, thread id)``
from ``time.perf_counter_ns`` to the recording; with both off it is one
shared ``nullcontext``.  No name holds "spmm" unless SpMM work runs under
it, and none holds "backward": a reader that takes a range named
``*spmm*backward*`` for SpMM work stays right.

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
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

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


# Every span the program opens, by layer: the train step, the model, the
# sum/mean and the max/min SpMM ops, the fused GAT and dot-attention ops,
# graph prep, the kernel libraries.
SPANS = (
    "step", "step/zero_grad", "step/forward", "step/loss", "step/bwd",
    "step/optimizer",
    "model/dense", "model/norm", "model/relu", "model/dropout",
    "model/log_softmax", "model/attn_scores", "model/elu",
    "model/layer_norm", "model/gate",
    "op/spmm", "op/spmm.grad", "op/spmm_minmax", "op/spmm_minmax.grad",
    "op/gat", "op/gat.grad", "op/dot", "op/dot.grad",
    "graph_prep", "graph_prep/d2h", "graph_prep/rows", "graph_prep/csc",
    "graph_prep/inv_perm", "graph_prep/plans", "graph_prep/split",
    "graph_prep/h2d", "graph_prep/degree_norm",
    "kernel/build", "kernel/load",
)
_SPAN_NAMES = frozenset(SPANS)
_OFF = contextlib.nullcontext()
# The open recordings; spans append to each.
_RECORDINGS: List["Recording"] = []


class Recording:
    """The spans closed inside one ``recording()``: ``spans`` holds
    ``(name, start_ns, end_ns, thread id)`` in the order they closed."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int, int]] = []

    def seconds(self) -> Dict[str, float]:
        """Host seconds by span name, summed over its spans."""
        out: Dict[str, float] = {}
        for name, start, end, _ in self.spans:
            out[name] = out.get(name, 0.0) + (end - start) / 1e9
        return out


class _Span:
    __slots__ = ("name", "range", "sinks", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.sinks = tuple(_RECORDINGS)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        for rec in self.sinks:
            rec.spans.append((self.name, self.start, end,
                              threading.get_ident()))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """``with span(name):`` around a piece of the program's work; ``name``
    is one of ``SPANS`` (any other raises ``ValueError``).  With neither
    the torch profiler nor a ``recording()`` on it returns one shared
    ``nullcontext``."""
    if name not in _SPAN_NAMES:
        raise ValueError(f"unknown span {name!r}; the program's spans are "
                         f"profiling.SPANS")
    if not _RECORDINGS and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def recording():
    """``with recording() as rec:``: every span closed inside, on any
    thread, is appended to ``rec.spans`` (host clock, no profiler)."""
    rec = Recording()
    _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        _RECORDINGS.remove(rec)


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
