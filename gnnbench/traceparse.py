"""Reduce a ``torch.profiler`` Chrome trace of some training steps to what
the per-layer metrics read.

A device operation (a kernel, copy or fill) is linked to the host call that
launched it by the profiler's correlation id, and through that call's
thread and time to the host ranges that were open around it: CPU ops,
autograd nodes and ``record_function`` spans.  Its layer follows from those
ranges, never from the kernel's own name, so a kernel under a new name is
still counted:

* ``spmm``: inside the benchmark's span ``SPMM_SPAN`` around the program's
  ``spmm`` (the forward), or inside an autograd node whose name holds
  "spmm" (its backward);
* ``dense``: inside a matrix product op (``DENSE_OPS``), forward or backward;
* ``other``: the rest (elementwise ops, the loss, the optimizer, copies).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

SPMM_SPAN = "gnnbench.spmm"
DENSE_OPS = frozenset({"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
                       "aten::matmul", "aten::linear"})
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
TOP = 10


def layer_of(open_ranges: List[str]) -> str:
    for name in open_ranges:
        if name == SPMM_SPAN or ("spmm" in name.lower()
                                 and "backward" in name.lower()):
            return "spmm"
    if any(name in DENSE_OPS for name in open_ranges):
        return "dense"
    return "other"


def _open_at(ranges: List[Tuple[float, float, str]],
             times: List[float]) -> List[List[str]]:
    """For each time, the names of the host ranges of one thread open at
    it, innermost first (one sweep over both in time order)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: List[List[str]] = [[] for _ in times]
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        stack = [r for r in stack if r[1] >= t]
        out[q] = [r[2] for r in reversed(stack)]
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def analyze(trace: dict, steps: int) -> Optional[Dict]:
    """Per-step device seconds by layer, busy seconds, device operations,
    the top device operations and the idle gaps by the host op that was
    running; None where the trace holds no device operation."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        return None
    launch = {}
    host: Dict[Tuple, List] = collections.defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["pid"], e["tid"], e["ts"])
        elif cat in HOST_CATS:
            host[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    # The open ranges at each launch, one sweep a thread.
    asked: Dict[Tuple, List[int]] = collections.defaultdict(list)
    for j, e in enumerate(device):
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is not None:
            asked[(src[0], src[1])].append(j)
    names: List[List[str]] = [[] for _ in device]
    for thread, js in asked.items():
        times = [launch[device[j]["args"]["correlation"]][2] for j in js]
        for j, open_ in zip(js, _open_at(host.get(thread, []), times)):
            names[j] = open_
    layer_us: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    busy = []
    for e, open_ in zip(device, names):
        dur = float(e.get("dur", 0))
        layer_us[layer_of(open_)] += dur
        by_name[e["name"]] += dur
        busy.append((float(e["ts"]), float(e["ts"]) + dur))
    merged = _union(busy)
    # Idle gaps by the innermost op of the busiest host thread.
    gaps: Dict[str, float] = collections.defaultdict(float)
    main = max(host.values(), key=len, default=[])
    mids = [(e0 + s1) / 2 for (_, e0), (s1, _) in zip(merged, merged[1:])]
    for ((_, e0), (s1, _)), open_ in zip(zip(merged, merged[1:]),
                                        _open_at(main, mids)):
        gaps[open_[0] if open_ else "(no host op)"] += s1 - e0

    def top(table):
        return [[k, v / 1e6] for k, v in
                sorted(table.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "steps": steps,
        "device_ops": len(device),
        "busy_s": sum(e - s for s, e in merged) / 1e6,
        "layer_s": {k: v / 1e6 for k, v in layer_us.items()},
        "top_device_ops": top(by_name),
        "idle_gaps": top(gaps),
    }
