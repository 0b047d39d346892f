"""The program's own spans in a ``torch.profiler`` Chrome trace of some
training steps, and in its set-up.

The program opens a span (``gespmm_tpu_torch/utils/profiling.py::span``,
named in its ``SPANS``) around each piece of its work: the step and its
phases, the model's dense and elementwise work, the SpMM op forward and
backward.  Under the profiler each is a ``user_annotation`` range.  A device
operation (kernel, copy, fill) is linked to the host call that launched it
by the correlation id, and given to one span:

1. the innermost program span open at the launch on the launching thread,
   where no autograd node lies between it and the launch;
2. else, where the launch sits inside an autograd node (the backward, which
   on the card runs on autograd's own thread), the span that was open
   around that node's forward op: both events carry the profiler's
   ``Sequence number`` (``MmBackward0`` to its ``aten::mm``, a custom
   ``Function``'s ``...Backward`` to the op named after the ``Function``;
   of the ops that carry one number, the last, which made the node);
3. else the next program span outward at the launch;
4. else ``unattributed``.

``table`` gives, a step: the device ms under each span (forward and linked
backward together, and the linked part alone), ``unattributed``, the busy
time (the union of device operations), the host ms of each ``step`` span,
and the idle gaps by the innermost program span open on the thread that
runs ``step`` (``between_steps`` where none is), and again by the span of
the device operation that ends each gap (where the host runs ahead of the
device, the span open on the host is a later one than the gap's).
``traceparse.py`` reads the same trace for the layers.

    python3 -m gnnbench.spans trace gnnbench/_traces/<cell>.json
    python3 -m gnnbench.spans setup --workload <cell> --seed <n>

The first prints the table of a traced run's trace (``--trace 1`` leaves it
at ``gnnbench/_traces/<cell>.json``); the second runs a cell's set-up (the
inputs, ``Adjacency.from_csr``, the model, and its first steps) inside the
program's ``recording()`` and prints the host seconds of each set-up span:
the phases of ``from_csr`` and ``kernel/build`` (nvcc ran) or
``kernel/load``.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from gnnbench import traceparse

UNATTRIBUTED = "unattributed"
BETWEEN_STEPS = "between_steps"
STEP = "step"
SEQ = "Sequence number"
FWD_THREAD = "Fwd thread id"


def program_spans() -> Tuple[str, ...]:
    """The program's span names; none where the program has no spans (a
    program older than them)."""
    from gespmm_tpu_torch.utils import profiling

    return tuple(getattr(profiling, "SPANS", ()))


def _thread(e: dict) -> Tuple:
    return (e["pid"], e["tid"])


def table(trace: dict, names: Optional[Iterable[str]] = None
          ) -> Optional[Dict]:
    """The spans' table of ``trace`` (module docstring); None where it holds
    no ``step`` span of the program or no device operation."""
    names = frozenset(program_spans() if names is None else names)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in traceparse.DEVICE_CATS]
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e["name"] in names]
    steps_by_thread = collections.Counter(
        _thread(e) for e in spans if e["name"] == STEP)
    if not device or not steps_by_thread:
        return None
    step_thread, steps = steps_by_thread.most_common(1)[0]

    # Host ranges a thread: program spans and autograd nodes (the events
    # that carry a sequence number and the id of their forward's thread).
    ranges: Dict[Tuple, List] = collections.defaultdict(list)
    for e in spans:
        ranges[_thread(e)].append(
            (e["ts"], e["ts"] + e.get("dur", 0), ("span", e["name"])))
    forward = []
    launch = {}
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if cat in traceparse.LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = (_thread(e), e["ts"])
        elif cat == "cpu_op" and SEQ in args and args[SEQ] >= 0:
            if args.get(FWD_THREAD, 0):
                ranges[_thread(e)].append(
                    (e["ts"], e["ts"] + e.get("dur", 0), ("node", args[SEQ])))
            else:
                forward.append(e)

    def innermost_span(open_) -> Optional[str]:
        return next((v for k, v in open_ if k == "span"), None)

    # The span around each forward op, by its sequence number.  An op that
    # makes no autograd node (a detach, a view of a constant) carries the
    # number of the next node made, so the number's last op (the one that
    # made the node, innermost) is the one linked.
    linked: List[Tuple[float, int, Optional[str]]] = []
    by_thread: Dict[Tuple, List[dict]] = collections.defaultdict(list)
    for e in forward:
        by_thread[_thread(e)].append(e)
    for thread, ops in by_thread.items():
        for e, open_ in zip(ops, traceparse._open_at(
                ranges.get(thread, []), [e["ts"] for e in ops])):
            linked.append((e["ts"], e["args"][SEQ], innermost_span(open_)))
    fwd_span: Dict[int, Optional[str]] = {}
    for _, seq, name in sorted(linked, key=lambda x: x[0]):
        fwd_span[seq] = name

    # Each device operation's span.
    asked: Dict[Tuple, List[int]] = collections.defaultdict(list)
    for j, e in enumerate(device):
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is not None:
            asked[src[0]].append(j)
    owner: List[Tuple[str, bool]] = [(UNATTRIBUTED, False)] * len(device)
    for thread, js in asked.items():
        times = [launch[device[j]["args"]["correlation"]][1] for j in js]
        for j, open_ in zip(js, traceparse._open_at(ranges.get(thread, []),
                                                     times)):
            for kind, value in open_:
                if kind == "span":
                    owner[j] = (value, False)
                    break
                if fwd_span.get(value) is not None:
                    owner[j] = (fwd_span[value], True)
                    break
    device_us: Dict[str, float] = collections.defaultdict(float)
    bwd_us: Dict[str, float] = collections.defaultdict(float)
    busy = []
    for e, (name, linked) in zip(device, owner):
        dur = float(e.get("dur", 0))
        device_us[name] += dur
        if linked:
            bwd_us[name] += dur
        busy.append((float(e["ts"]), float(e["ts"]) + dur))
    merged = traceparse._union(busy)

    # Idle gaps by the program span open on the step's thread.
    step_ranges = [r for r in ranges.get(step_thread, [])
                   if r[2][0] == "span"]
    mids = [(e0 + s1) / 2 for (_, e0), (s1, _) in zip(merged, merged[1:])]
    idle_us: Dict[str, float] = collections.defaultdict(float)
    # And by the span of the operation that ends the gap.
    first_at: Dict[float, str] = {}
    for (start, _), (name, _) in sorted(zip(busy, owner),
                                        key=lambda x: x[0][0], reverse=True):
        first_at[start] = name
    before_us: Dict[str, float] = collections.defaultdict(float)
    for ((_, e0), (s1, _)), open_ in zip(zip(merged, merged[1:]),
                                        traceparse._open_at(step_ranges,
                                                            mids)):
        idle_us[innermost_span(open_) or BETWEEN_STEPS] += s1 - e0
        before_us[first_at[s1]] += s1 - e0

    def per_step(us: Dict[str, float]) -> Dict[str, float]:
        return {k: v / 1e3 / steps
                for k, v in sorted(us.items(), key=lambda kv: -kv[1])}

    return {
        "steps": steps,
        "device_ops": len(device),
        "busy_s": sum(e - s for s, e in merged) / 1e6,
        "busy_ms": sum(e - s for s, e in merged) / 1e3 / steps,
        "device_ms": per_step(device_us),
        "bwd_ms": per_step(bwd_us),
        "idle_ms": per_step(idle_us),
        "idle_before_ms": per_step(before_us),
        "step_host_ms": [e.get("dur", 0) / 1e3 for e in spans
                         if e["name"] == STEP and _thread(e) == step_thread],
    }


@functools.lru_cache(maxsize=4)
def _table_of_file(path: str, mtime_ns: int, size: int) -> Optional[Dict]:
    with open(path) as f:
        return table(json.load(f))


def _trace_files(run: dict) -> List[Path]:
    """The traced run's own trace file among the cells of its configuration
    (the harness writes ``gnnbench/_traces/<cell>.json``), newest first."""
    from gnnbench import harness

    bench = harness.load_bench()
    configs = {c["name"] for c in bench["configs"]
               if (harness.REPO / c["file"]).is_file()
               and json.loads((harness.REPO / c["file"]).read_text())
               == run["config"]}
    files = [harness.PACKAGE / "_traces" / f"{w['name']}.json"
             for w in bench["workloads"] if w["config"] in configs]
    return sorted((f for f in files if f.is_file()),
                  key=lambda f: -f.stat().st_mtime_ns)


def from_run(run: dict) -> Optional[Dict]:
    """The spans' table of a traced run (a metric reader's ``run``); None
    where the run has no device trace, or its trace file holds no program
    span (a program without spans).  The file is taken as the run's own
    only where it gives the run's count of device operations and busy
    time."""
    summary = run.get("trace")
    if summary is None:
        return None
    for path in _trace_files(run):
        st = path.stat()
        t = _table_of_file(str(path), st.st_mtime_ns, st.st_size)
        if (t is not None and t["device_ops"] == summary["device_ops"]
                and abs(t["busy_s"] - summary["busy_s"])
                <= 1e-9 * summary["busy_s"]):
            return t
    return None


def setup_spans(workload: str, seed: int, steps: int = 2, device="cuda",
                root: Optional[Path] = None) -> Dict:
    """A cell's set-up inside the program's ``recording()``: the inputs,
    ``Adjacency.from_csr`` and the model (as the harness builds them), then
    ``steps`` steps, which load (and, where none is built yet, build) the
    kernels.  Host seconds and count of each span."""
    import time

    import torch

    from gespmm_tpu_torch.utils import profiling
    from gnnbench import harness

    root = harness.REPO if root is None else root
    cell = harness.find_cell(harness.load_bench(root), workload, root)
    device = torch.device(device)
    clock = harness.Clock(device)
    torch.zeros(1, device=device)
    t0 = time.perf_counter()
    with profiling.recording() as rec:
        graph, inputs, init = harness.make_inputs(cell, seed, device)
        prog = harness.build_program(cell, graph, inputs, init, seed, device,
                                     clock)
        for _ in range(steps):
            prog.step()
        clock.sync()
    wall = time.perf_counter() - t0
    count = collections.Counter(name for name, *_ in rec.spans)
    return {
        "workload": workload, "seed": seed, "wall_s": wall,
        "graph_build_s": prog.graph_build_s,
        "setup_spans": {name: {"count": count[name], "s": s}
                        for name, s in rec.seconds().items()},
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    tr = sub.add_parser("trace", help="the spans' table of a trace file")
    tr.add_argument("path")
    su = sub.add_parser("setup", help="a cell's set-up spans, on the card")
    su.add_argument("--workload", required=True)
    su.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if args.what == "trace":
        with open(args.path) as f:
            t = table(json.load(f))
        if t is None:
            print("no program span in the trace", file=sys.stderr)
            return 1
        t["step_host_ms_median"] = statistics.median(t["step_host_ms"])
        print(json.dumps(t))
        return 0
    print(json.dumps(setup_spans(args.workload, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
