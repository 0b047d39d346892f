"""Benchmark timing — port of ``gespmm_tpu/utils/timing.py``.

On the card, groups of launches are timed between two CUDA events after a
warm-up (the cudaEvent loop of the GE-SpMM harness); the per-call time is
the group time over the group size.  ``device_time`` queues the group
behind a spin kernel, so that the events time the device and not the
host.  A CPU tensor is timed with the host clock, and every result names
the device it ran on.  Throughput follows
the same definition as the JAX package: GFLOP/s = 2·nnz·K / time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass
class BenchResult:
    mean_s: float
    median_s: float
    best_s: float
    iters: int
    device: str

    def gflops(self, flops: float) -> float:
        return flops / self.mean_s / 1e9


def _device_of(out) -> torch.device:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out.device


def _time_groups(run_group: Callable[[], None], device: torch.device,
                 groups: int):
    """Seconds per group for ``groups`` calls of ``run_group``."""
    times = []
    for _ in range(groups):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run_group()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            run_group()
            times.append(time.perf_counter() - t0)
    return times


def _result(per_call, iters: int, device: torch.device) -> BenchResult:
    per_call = sorted(per_call)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return BenchResult(mean_s=sum(per_call) / len(per_call),
                       median_s=per_call[len(per_call) // 2],
                       best_s=per_call[0], iters=iters, device=name)


def benchmark(fn: Callable[[], torch.Tensor], iters: int = 200,
              warmup: int = 3) -> BenchResult:
    """Time ``fn()`` (which returns a tensor) on the device of its output."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn()
    device = _device_of(out)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    per_group = max(10, iters // 10)
    groups = max(4, iters // per_group)

    def run_group():
        for _ in range(per_group):
            fn()

    times = _time_groups(run_group, device, groups)
    return _result([t / per_group for t in times], groups * per_group, device)


def benchmark_chained(step: Callable[[torch.Tensor], torch.Tensor],
                      x0: torch.Tensor, iters: int = 50,
                      groups: int = 4) -> BenchResult:
    """Steady state of ``iters`` data-chained calls ``x = step(x)``.

    Each call depends on the previous one, so no two can overlap.
    """
    x = step(x0)  # warm-up
    device = x.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def run_group():
        x = x0
        for _ in range(iters):
            x = step(x)

    times = _time_groups(run_group, device, groups)
    return _result([t / iters for t in times], groups * iters, device)


class HostBehind(RuntimeError):
    """``device_time`` could not queue the calls ahead of the device."""


def device_time(fn: Callable[[], torch.Tensor], iters: int = 50,
                warmup: int = 3, sleep_cycles: int = 1 << 20,
                attempts: int = 6) -> float:
    """Device seconds per call of ``fn``, on the card.

    ``benchmark`` times calls between events and so, for a call whose host
    work outlasts its kernels, measures the host's enqueue rate.  Here a
    spin kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues the start event, ``iters`` calls and the stop event, so the
    device runs the calls back to back and the two events time the
    device alone.  If the device has reached the start event by the time
    the stop event is enqueued, the host fell behind; the spin is then
    made 4x longer and the group timed again.  Raises if ``fn``'s output
    is not on a CUDA device, and ``HostBehind`` if the host never gets
    ahead (as for a call that synchronises the host).  The host
    cannot get ahead when ``iters`` calls hold more launches than the
    stream's launch queue (about a thousand): the enqueue then waits for
    the spin.  Time a call of many small launches with fewer ``iters``.
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn()
    device = _device_of(out)
    if device.type != "cuda":
        raise ValueError(f"device_time measures CUDA work; the output is on "
                         f"{device}")
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        for _ in range(attempts):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep_cycles)
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            behind = start.query()
            stop.synchronize()
            if not behind:
                return start.elapsed_time(stop) / 1e3 / iters
            sleep_cycles *= 4
    raise HostBehind(f"the host could not enqueue {iters} calls ahead of "
                     f"the device in {attempts} attempts (fewer iters, or a "
                     "call that synchronises?)")


def spmm_flops(nnz: int, k: int) -> float:
    """2·nnz·K."""
    return 2.0 * nnz * k


def sddmm_flops(nnz: int, k: int) -> float:
    """2·nnz·K: one K-wide dot per nonzero."""
    return 2.0 * nnz * k
