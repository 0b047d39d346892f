"""One run of one cell: set-up, the measured window, the trace, and the
comparison with the reference that decides ``correct``.

Set-up builds the inputs from the seed on the device, the program's
``Adjacency``, model, Adam and train step, and drives that one step through
its first ``CHECKED_STEPS`` steps, whose readings the reference checks
after the window, then ``EXTRA_WARMUP`` more.  The window calls the same
step until ``seconds`` have passed and ends with a synchronize; events
recorded on the stream between steps give each step's time, and the host
waits on the event of two steps back, so it runs at most two steps ahead.
After the window the program's state is freed and the reference trains
from the same inputs, weights and dropout seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from gnnbench import compare, graphgen, traceparse
from gnnbench.reference import common as ref_common

PACKAGE = Path(__file__).resolve().parent
REPO = PACKAGE.parent

CHECKED_STEPS = 3
EXTRA_WARMUP = 2
ADAM_BETAS = (0.9, 0.999)
# The profiled part of a traced run: about this long, and this many steps
# at the least and the most.
PROFILE_SECONDS = 1.5
PROFILE_STEPS = (3, 20)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    metrics: Dict[str, List[dict]]  # "end_to_end" / "per_layer" -> entries


def load_bench(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _read(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str, root: Path = REPO) -> Cell:
    """The cell ``name`` of ``bench``, with its configuration file, traffic
    file (``gnnbench/traffic/<traffic>.json``), limits
    (``gnnbench/limits/<cell>.json``) and metrics, all under ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(root / configs[cell["config"]]["file"])
    data = root / "gnnbench"
    traffic = _read(data / "traffic" / f"{cell['traffic']}.json")
    limits = _read(data / "limits" / f"{name}.json")["limits"]
    unknown = set(limits) - set(compare.NUMBERS)
    if unknown:
        raise ValueError(f"{name}: limits of unknown numbers {sorted(unknown)}")
    metrics = {kind: [m for m in bench[kind]
                      if "workloads" not in m or name in m["workloads"]]
               for kind in ("end_to_end", "per_layer")}
    return Cell(name=name, chips=int(cell["chips"]), config=config,
                traffic=traffic, limits=limits, metrics=metrics)


def adapter(config: dict):
    return importlib.import_module(f"gnnbench.models.{config['kind']}")


def reference(config: dict):
    return importlib.import_module(f"gnnbench.reference.{config['kind']}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``gnnbench/metrics/<name>.py``."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gnnbench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Clock:
    """Marks between steps: CUDA events on the card, the host clock on the
    CPU (where the harness runs only in tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def seconds(self, marks) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        return [b - a for a, b in zip(marks, marks[1:])]


@dataclasses.dataclass
class Program:
    step: Callable
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    graph_build_s: float


def build_program(cell: Cell, graph, inputs, init, seed: int, device,
                  clock: Clock) -> Program:
    from gespmm_tpu_torch.train.loop import make_train_step

    # The configurations state float32 with TF32 off, for the program and
    # the reference alike.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = adapter(cell.config)
    clock.sync()
    t = time.perf_counter()
    adj = kind.adjacency(graph, device)
    clock.sync()
    graph_build_s = time.perf_counter() - t
    model = kind.model(cell.config, adj, device)
    named = dict(model.named_parameters())
    if set(named) != set(init):
        raise ValueError(f"the program's leaves {sorted(named)} are not the "
                         f"reference's {sorted(init)}")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(init[k])
    optimizer = torch.optim.Adam(model.parameters(), lr=cell.config["lr"],
                                 betas=ADAM_BETAS)
    gen = graphgen.generator(seed, "dropout", device)
    step = make_train_step(model, optimizer, adj, inputs.x, inputs.labels,
                           inputs.train_mask, generator=gen)
    return Program(step=step, model=model, optimizer=optimizer,
                   graph_build_s=graph_build_s)


def checked_steps(prog: Program, init) -> ref_common.Readings:
    """The first steps of the program, read as the reference reads its
    own: each loss, the first gradient from Adam's state after one step,
    and every leaf's change after the last."""
    named = dict(prog.model.named_parameters())
    losses = [prog.step()]
    beta1 = prog.optimizer.param_groups[0]["betas"][0]
    grad1 = {}
    for k, p in named.items():
        m = prog.optimizer.state.get(p, {}).get("exp_avg")
        grad1[k] = (torch.zeros_like(p) if m is None
                    else m.detach() / (1.0 - beta1))
    for _ in range(CHECKED_STEPS - 1):
        losses.append(prog.step())
    delta = {k: p.detach() - init[k] for k, p in named.items()}
    return ref_common.Readings(losses=[float(v) for v in losses],
                               grad1=grad1, delta=delta)


@dataclasses.dataclass
class Window:
    steps: int
    wall_s: float
    step_s: List[float]
    failed: int


def window(step: Callable, seconds: float, clock: Clock) -> Window:
    """Steps until ``seconds`` have passed, then a synchronize."""
    clock.sync()
    marks = [clock.mark()]
    losses = []
    t0 = time.perf_counter()
    while True:
        losses.append(step())
        marks.append(clock.mark())
        if len(marks) > 3:
            clock.wait(marks[-3])
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    wall = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return Window(steps=len(losses), wall_s=wall, step_s=clock.seconds(marks),
                  failed=failed)


@contextlib.contextmanager
def wrapped_sites(sites, wrap: Callable[[Callable], Callable]):
    """Replace each ``(module, attr)`` of ``sites`` (an adapter's
    ``SPMM_SITES``: where the model calls ``spmm``) by ``wrap`` of it, and
    put the original back on leaving."""
    saved = []
    for module_name, attr in sites:
        module = importlib.import_module(module_name)
        inner = getattr(module, attr)
        saved.append((module, attr, inner))
        setattr(module, attr, functools.wraps(inner)(wrap(inner)))
    try:
        yield
    finally:
        for module, attr, inner in saved:
            setattr(module, attr, inner)


def spmm_spans(sites):
    """Wrap the program's ``spmm`` where the model calls it in a
    ``record_function`` span, for the trace alone."""
    def wrap(inner):
        def spanned(*args, **kwargs):
            with torch.profiler.record_function(traceparse.SPMM_SPAN):
                return inner(*args, **kwargs)
        return spanned

    return wrapped_sites(sites, wrap)


def profile_steps(step: Callable, step_s: float, clock: Clock, sites,
                  trace_path: Path):
    """Profile a few steps; (summary or None, their wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    lo, hi = PROFILE_STEPS
    n = int(min(hi, max(lo, math.ceil(PROFILE_SECONDS / max(step_s, 1e-6)))))
    activities = [ProfilerActivity.CPU]
    if clock.cuda:
        activities.append(ProfilerActivity.CUDA)
    with spmm_spans(sites), profile(activities=activities) as prof:
        clock.sync()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        clock.sync()
        wall = time.perf_counter() - t0
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    with open(trace_path) as f:
        return traceparse.analyze(json.load(f), n), wall


def device_info(device: torch.device, peak: int, chips: int) -> dict:
    """The device line; ``count`` is the cards the run uses, the cell's
    ``chips`` (the run has checked that the machine holds as many)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    import subprocess

    try:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        power = f"unread ({e.__class__.__name__})"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak, "power_limit": power}


def reference_readings(cell: Cell, graph, inputs, init, seed: int, *,
                       tf32: bool = False, half_batch: bool = False):
    ref = reference(cell.config)
    edges = ref_common.EdgeGraph.from_csr(graph.n, graph.indptr, graph.indices)
    return ref_common.train(
        functools.partial(ref.forward, cell.config), edges, inputs.x,
        inputs.labels, inputs.train_mask, init,
        graphgen.sub_seed(seed, "dropout"), lr=cell.config["lr"],
        steps=CHECKED_STEPS, betas=ADAM_BETAS, tf32=tf32,
        half_batch=half_batch)


def make_inputs(cell: Cell, seed: int, device):
    graph = graphgen.make_graph(cell.traffic, seed, device,
                                bool(cell.config["self_loops"]))
    inputs = graphgen.make_inputs(cell.traffic, cell.config, graph.n, seed,
                                  device)
    shapes = reference(cell.config).param_shapes(cell.config)
    init = ref_common.init_params(
        shapes, graphgen.generator(seed, "weights", device), device)
    return graph, inputs, init


def free() -> None:
    """Return what the dropped program held to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, trace_dir: Path = PACKAGE / "_traces") -> dict:
    """One run; the result line's object (without the import check)."""
    device = torch.device(device)
    clock = Clock(device)
    phases = {"imports_s": time.perf_counter() - t0}
    lap = time.perf_counter()

    def phase(name):
        nonlocal lap
        clock.sync()
        now = time.perf_counter()
        phases[name], lap = now - lap, now

    torch.zeros(1, device=device)
    phase("device_init_s")
    graph, inputs, init = make_inputs(cell, seed, device)
    phase("inputs_s")
    prog = build_program(cell, graph, inputs, init, seed, device, clock)
    phase("program_s")
    readings = checked_steps(prog, init)
    phase("checked_steps_s")
    for _ in range(EXTRA_WARMUP):
        prog.step()
    phase("warmup_s")
    setup_s = time.perf_counter() - t0
    record = {"setup_s": setup_s, "graph_build_s": prog.graph_build_s,
              "config": cell.config, "n": graph.n, "nnz": graph.nnz,
              "adapter": adapter(cell.config), "trace": None}
    # A traced run times half the window unprofiled (its step time feeds
    # step_mfu), then profiles a few steps.
    win = record["window"] = window(prog.step, seconds / 2 if trace else seconds,
                                    clock)
    if trace:
        record["traced_step_s"] = win.wall_s / win.steps
        record["trace"], record["trace_wall_s"] = profile_steps(
            prog.step, record["traced_step_s"], clock,
            adapter(cell.config).SPMM_SITES, trace_dir / f"{cell.name}.json")
    peak = (torch.cuda.max_memory_allocated(device) if clock.cuda else 0)
    record["peak_bytes"] = peak
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    del prog
    free()
    got = reference_readings(cell, graph, inputs, init, seed)
    values = compare.numbers(readings, got)
    result = {
        "correct": compare.judge(values, cell.limits),
        "attempted": win.steps,
        "failed": win.failed,
        "metrics": metrics,
        "device": device_info(device, peak, cell.chips),
    }
    summary = record["trace"]
    if trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = record["trace_wall_s"]
        result["breakdown"] = {"device_ops": summary["top_device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["setup_phases"] = phases
    result["checks"] = {k: {"value": values[k], "limit": cell.limits[k]}
                        for k in cell.limits}
    return result
