"""Readings that the limits of ``correct`` are set from, many seeds in one
process, at the cell's own size (no measured window).

    python3 -m gnnbench.calibrate --workload <name> --seeds 11 12 13 ... \
        [--controls 3] [--out FILE]

For every seed: the program's first steps, as a run takes them, against
the reference (``program``).  For the first ``--controls`` seeds also the
control, the reference in TF32 in the program's place (``control``), and
the fault "half of the batch left out, the mean taken over the rest",
planted in the reference in the program's place (``half_batch``), and the
fault "a wrong grad_B in one layer's SpMM", planted in the program
(``grad_b_halved``, ``faults.halved_grad_b``).  A step
that leaves the state unchanged reads 1 on ``update3_gap`` by definition
and needs no run.  Prints one JSON line a seed, and the numbers' largest
and smallest readings at the end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gnnbench import compare, faults, harness


def seed_readings(cell, seed: int, device, controls: bool) -> dict:
    clock = harness.Clock(torch.device(device))
    graph, inputs, init = harness.make_inputs(cell, seed, device)
    prog = harness.build_program(cell, graph, inputs, init, seed, device, clock)
    readings = harness.checked_steps(prog, init)
    del prog
    harness.free()
    out = {"seed": seed}
    t = time.perf_counter()
    ref = harness.reference_readings(cell, graph, inputs, init, seed)
    clock.sync()
    out["reference_s"] = time.perf_counter() - t
    out["program"] = compare.numbers(readings, ref)
    out["program_extremes"] = compare.extremes(readings, ref)
    out["losses"] = {"program": readings.losses, "reference": ref.losses}
    out["leaves"] = compare.leaf_gaps(readings, ref)
    if controls:
        for name, kw in (("control", {"tf32": True}),
                         ("half_batch", {"half_batch": True})):
            other = harness.reference_readings(cell, graph, inputs, init, seed,
                                               **kw)
            out[name] = compare.numbers(other, ref)
            out[f"{name}_extremes"] = compare.extremes(other, ref)
        layers = len(cell.config["dims"]) - 1
        with faults.halved_grad_b(harness.adapter(cell.config).SPMM_SITES,
                                  layers):
            prog = harness.build_program(cell, graph, inputs, init, seed,
                                         device, clock)
            other = harness.checked_steps(prog, init)
        del prog
        harness.free()
        out["grad_b_halved"] = compare.numbers(other, ref)
        out["grad_b_halved_extremes"] = compare.extremes(other, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_bench(), args.workload)
    rows = []
    for i, seed in enumerate(args.seeds):
        row = seed_readings(cell, seed, "cuda", i < args.controls)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for kind in ("program", "control", "half_batch", "grad_b_halved"):
        for part in (kind, f"{kind}_extremes"):
            got = [r[part] for r in rows if part in r]
            if got:
                summary[part] = {k: {"max": max(g[k] for g in got),
                                     "min": min(g[k] for g in got)}
                                 for k in got[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
