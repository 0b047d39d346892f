"""The numbers that decide ``correct``: the program's first training steps
against the reference's, from the same inputs, weights and dropout seed.

Per leaf, a gap is the distance between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf.  Leaves whose reference gradient is below a thousandth of
the median leaf's are nought to rounding and are left out.

* ``loss1_gap``: the first step's loss, relative to the reference's.
* ``grad1_gap``: the median leaf's gap of the first gradient as the
  optimizer got it (the program's: Adam's first moment after one step,
  over 1 - beta1).
* ``grad1_worst_gap``: the worst leaf's gap of that gradient, so that a
  fault in one leaf's gradient (a wrong grad_B in one layer's SpMM) shows
  where the median does not move.
* ``update3_gap``: the median leaf's gap of every leaf's change over the
  checked steps.

The first step's loss and the median leaf's change, and not every step's
loss and the worst leaf's change: on the card a ReLU input within rounding
of zero falls on the other side in the program and in the reference on
some seeds, and Adam's normalised steps carry that into the later losses
and into single small leaves (PERF.md, "How correct is decided").  The
first gradient comes before any Adam step: its worst leaf separates sound
runs from the control on every seed read.  ``extremes`` gives the every-step loss and the
worst-leaf change beside them.  A number that is not finite reads as
infinity, so it fails any limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping

import torch

NUMBERS = ("loss1_gap", "grad1_gap", "grad1_worst_gap", "update3_gap")
# A leaf counts where its reference gradient norm is at least this share
# of the median leaf's.
LEAF_FLOOR = 1e-3


def _norms(tree: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tree.items()}


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _loss_gap(a: float, b: float) -> float:
    return _finite(abs(a - b) / max(abs(b), 1e-30))


def leaf_gaps(prog, ref) -> Dict[str, Dict[str, list]]:
    """For "grad1" and "delta": every counted leaf's [program norm,
    reference norm, gap]."""
    if set(prog.grad1) != set(ref.grad1):
        raise ValueError(f"leaves differ: {sorted(prog.grad1)} against "
                         f"{sorted(ref.grad1)}")
    g_ref = _norms(ref.grad1)
    floor = LEAF_FLOOR * statistics.median(g_ref.values())
    keep = [k for k, v in g_ref.items() if v >= floor]
    out = {}
    for part in ("grad1", "delta"):
        p, r = _norms(getattr(prog, part)), _norms(getattr(ref, part))
        median = statistics.median(r.values())
        out[part] = {}
        for k in keep:
            scale = max(r[k], median)
            gap = abs(p[k] - r[k]) / scale if scale > 0 else math.inf
            out[part][k] = [p[k], r[k], _finite(gap)]
    return out


def numbers(prog, ref) -> Dict[str, float]:
    """The compared numbers of ``prog`` against ``ref`` (``Readings``)."""
    leaves = leaf_gaps(prog, ref)
    grad1 = [v[2] for v in leaves["grad1"].values()]
    return {
        "loss1_gap": _loss_gap(prog.losses[0], ref.losses[0]),
        "grad1_gap": statistics.median(grad1),
        "grad1_worst_gap": max(grad1),
        "update3_gap": statistics.median(v[2] for v in leaves["delta"].values()),
    }


def extremes(prog, ref) -> Dict[str, float]:
    """The every-step loss and the worst leaf's change, beside the
    compared numbers."""
    leaves = leaf_gaps(prog, ref)
    return {
        "loss_any_step_gap": max(_loss_gap(a, b)
                                 for a, b in zip(prog.losses, ref.losses)),
        "update3_worst_leaf": max(v[2] for v in leaves["delta"].values()),
    }


def judge(values: Dict[str, float], limits: Mapping[str, float]) -> bool:
    """Every number that has a limit at or under it.  A cell's limits file
    leaves out a number that has no upper reading (PERF.md, section 2)."""
    return all(values[k] <= float(limits[k]) for k in limits)
