"""Checkpoint and resume of training state — port of ``gespmm_tpu/train/checkpoint.py``.

A state is a dict: ``model`` (the module's ``state_dict``), ``optimizer``
(the optimizer's ``state_dict``) and ``generator`` (the dropout generator's
``get_state()``).  The generator takes the place of the JAX loop's step
counter: JAX draws each step's dropout key as ``fold_in(key0, step)``, so a
resumed run draws what the uninterrupted one would; a ``torch.Generator``
is a stream, so its state is saved for the same to hold.

Files are ``ckpt_{epoch:08d}.pt`` (``torch.save``), each written to a
``.tmp`` file and then renamed over its name, beside a ``manifest.json`` of
the last one.  ``restore`` checks the stored structure against a template
before it loads anything, as the JAX package does: a reshaped model must
not load weights that merely line up.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor


def _tensors(state) -> Dict[str, Tensor]:
    """{dotted path: tensor} of every tensor in the nested dicts of
    ``state``."""
    out = {}

    def walk(path, v):
        if isinstance(v, Tensor):
            out[path] = v
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(f"{path}.{k}" if path else str(k), x)

    walk("", state)
    return out


def _groups(state) -> List[List[int]]:
    """The optimizer's param-group layout: each group's parameter ids."""
    return [list(g["params"]) for g in state["optimizer"]["param_groups"]]


def _treedef(state) -> str:
    return json.dumps({"tensors": sorted(_tensors(state)),
                       "param_groups": _groups(state)})


def save(directory: str, state: Dict[str, Any], epoch: int) -> str:
    """Write a checkpoint; returns its path.  Keeps every checkpoint."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{epoch:08d}.pt")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    manifest = {"epoch": epoch, "num_leaves": len(_tensors(state)),
                "treedef": _treedef(state)}
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint of the highest epoch in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(
        f for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".pt") and ".tmp" not in f)
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def restore(path: str, template: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """Load a checkpoint shaped like ``template``; returns (state, epoch).

    The stored state must hold the template's tensors under the same keys,
    with the same shapes and dtypes, and the same param-group layout; else
    ``ValueError`` names the stored and the template entry.  Tensors load
    on the template's device (``map_location``), and each then goes where
    its template entry lives (the optimizer's step count and the generator
    state stay on the host).
    """
    want = _tensors(template)
    device = template["model"][next(iter(template["model"]))].device
    state = torch.load(path, weights_only=True, map_location=device)
    got = _tensors(state)
    if set(got) != set(want) or _groups(state) != _groups(template):
        raise ValueError(
            "checkpoint structure does not match the template:\n"
            f"  stored:   {_treedef(state)}\n  template: {_treedef(template)}")
    for key, w in want.items():
        g = got[key]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(
                f"checkpoint leaf {key} is {tuple(g.shape)}/{g.dtype}, "
                f"template expects {tuple(w.shape)}/{w.dtype}")

    def place(v, t):
        if isinstance(v, Tensor):
            return v.to(t.device)
        if isinstance(v, dict):
            return {k: place(x, t[k]) for k, x in v.items()}
        return v

    epoch = int(os.path.basename(path).split("_")[1].split(".")[0])
    return place(state, template), epoch
