"""Run one cell of the benchmark once and print its result line.

    python3 -m gnnbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this package and
the program (``gespmm_tpu_torch``).  It needs as many CUDA cards as the cell
asks for and never falls back to the CPU.  The last line of standard output
is one JSON object; the numbers compared with the reference, each beside its
limit, end standard error and the result's ``checks``.  Exit codes: 0 a
result, 2 no card or no program, 3 a forbidden module was loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the moment this process started (Linux
    ``/proc``; elsewhere, now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gnnbench import harness, importcheck

    cell = harness.find_cell(harness.load_bench(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gnnbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"found {have}; no result", file=sys.stderr)
        return 2
    if importlib.util.find_spec("gespmm_tpu_torch") is None:
        print("gnnbench: the program gespmm_tpu_torch is not in this "
              "checkout; no result", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T0)
    found = importcheck.forbidden()
    if found:
        print(f"gnnbench: forbidden modules loaded: {', '.join(found)}; "
              "no result", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
