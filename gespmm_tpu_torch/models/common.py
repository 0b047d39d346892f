"""Module helpers — port of ``gespmm_tpu/models/common.py``.

Initialisation and dropout draw from an explicit ``torch.Generator``.  It
draws other numbers than ``jax.random`` from the same seed, so parity with
the JAX package goes through ``params_from_jax``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from gespmm_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def glorot(shape, *, generator: Optional[torch.Generator] = None,
           device=None, dtype=torch.float32) -> Tensor:
    """Glorot/Xavier uniform in [-limit, limit), limit = sqrt(6/(fan_in+fan_out))."""
    fan_in, fan_out = shape[0], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return u * (2.0 * limit) - limit


class Dense(nn.Module):
    """y = x @ w + b, with ``w`` shaped (in, out) as in the JAX package."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.w = nn.Parameter(glorot((in_dim, out_dim), generator=generator,
                                     device=device, dtype=dtype))
        self.b = (nn.Parameter(torch.zeros(out_dim, device=device, dtype=dtype))
                  if bias else None)

    def forward(self, x: Tensor) -> Tensor:
        with span("model/dense"):
            y = x @ self.w
            return y if self.b is None else y + self.b


def dropout(x: Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> Tensor:
    """Inverted dropout; ``generator`` must live on ``x``'s device."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    with span("model/dropout"):
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def params_from_jax(params, prefix: str = "") -> Dict[str, Tensor]:
    """A JAX parameter pytree of nested dicts -> a flat ``state_dict``.

    ``{"layer_0": {"self": {"w": ...}}}`` becomes ``{"layer_0.self.w": ...}``
    (f32 tensors), the names the port's modules give their parameters.  The
    ``(params, opt_state)`` init state of the JAX sharded builders
    (``gespmm_tpu/parallel/train_step.py``) gives its params' state dict.
    """
    if isinstance(params, tuple):
        params = params[0]
    flat = {}
    for key, value in params.items():
        if isinstance(value, Mapping):
            flat.update(params_from_jax(value, f"{prefix}{key}."))
        else:
            flat[f"{prefix}{key}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return flat
