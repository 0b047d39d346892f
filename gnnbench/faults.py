"""Faults planted in the program's timed path, for the readings that a
limit's upper end is set from (``calibrate.py``) and for the tests that see
``correct`` come out false.  Nothing here runs in a benchmark run.
"""

from __future__ import annotations

import torch

from gnnbench import harness


class _HalveGrad(torch.autograd.Function):
    """The identity forward; half the gradient backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g * 0.5


def halved_grad_b(sites, layers: int):
    """A wrong grad_B in one layer's SpMM: in every forward of ``layers``
    SpMM calls through ``sites`` (the adapter's ``SPMM_SITES``), the first
    call whose input takes a gradient passes half of it back.  In the GCN
    that is layer 0, whose grad_B reaches layer 0's weight alone; in
    GraphSAGE, layer 1, whose grad_B reaches layer 0's leaves alone."""
    state = {"calls": 0, "armed": False}

    def wrap(inner):
        def faulty(adj, B, *args, **kwargs):
            if state["calls"] % layers == 0:
                state["armed"] = True
            state["calls"] += 1
            if state["armed"] and B.requires_grad:
                state["armed"] = False
                B = _HalveGrad.apply(B)
            return inner(adj, B, *args, **kwargs)
        return faulty

    return harness.wrapped_sites(sites, wrap)
