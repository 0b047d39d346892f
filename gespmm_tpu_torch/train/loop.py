"""Node-classification training — port of ``gespmm_tpu/train/loop.py``.

AdamW (``torch.optim.AdamW`` matches ``optax.adamw``: decoupled decay on
every parameter, the same bias correction, eps outside the square root),
masked NLL loss, per-epoch timing and train/val/test accuracy.  Epoch time
is the mean over the epochs after the warm-up ones, as in the JAX loop; on
the card it is taken with CUDA events around each epoch.  Checkpointing is
not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

Tensor = torch.Tensor

WARMUP_EPOCHS = 3


def masked_nll_loss(log_probs: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    """Mean negative log-likelihood over the masked nodes."""
    ll = log_probs.gather(-1, labels[:, None].long())[:, 0]
    mask = mask.to(log_probs.dtype)
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def accuracy(logits: Tensor, labels: Tensor, mask: Tensor) -> Tensor:
    hit = (logits.argmax(-1) == labels).float() * mask.float()
    return hit.sum() / torch.clamp(mask.float().sum(), min=1.0)


def make_train_step(model, optimizer: torch.optim.Optimizer, adj, x: Tensor,
                    labels: Tensor, mask: Tensor, *,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable[[], Tensor]:
    """One optimizer step per call; returns the loss (a device scalar)."""

    def step() -> Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = masked_nll_loss(model.log_probs(adj, x, generator=generator),
                               labels, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


class _EpochClock:
    """Per-epoch times: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, start, stop) -> None:
        self.marks.append((start, stop))

    def seconds(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in self.marks]
        return [b - a for a, b in self.marks]


def train_node_classifier(model, adj, x: Tensor, labels: Tensor,
                          masks: Dict[str, Tensor], *, seed: int = 0,
                          lr: float = 1e-2, weight_decay: float = 5e-4,
                          epochs: int = 200, log_every: int = 0
                          ) -> Dict[str, Any]:
    """Full training run on ``x.device``; returns metrics and history.

    ``seed`` seeds the dropout generator; the model arrives initialised.
    """
    generator = torch.Generator(device=x.device).manual_seed(seed)
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  weight_decay=weight_decay)
    step = make_train_step(model, optimizer, adj, x, labels, masks["train"],
                           generator=generator)

    def evaluate():
        model.eval()
        with torch.no_grad():
            return model(adj, x)

    clock = _EpochClock(x.device)
    warmup_end = min(WARMUP_EPOCHS, max(epochs - 1, 0))
    history = {"loss": [], "val_acc": [], "epoch_time": []}
    losses = []
    for epoch in range(epochs):
        start = clock.mark()
        losses.append(step())
        stop = clock.mark()
        if epoch > warmup_end:
            clock.add(start, stop)
        if log_every and (epoch % log_every == 0 or epoch == epochs - 1):
            val = float(accuracy(evaluate(), labels, masks["val"]))
            history["val_acc"].append(val)
            print(f"epoch {epoch:04d} | loss {float(losses[-1]):.4f} | "
                  f"val acc {val:.4f}")
    history["epoch_time"] = clock.seconds()
    if losses:
        history["loss"] = torch.stack(losses).tolist()
    logits = evaluate()
    times = history["epoch_time"]
    return {
        "params": {k: v.detach() for k, v in model.state_dict().items()},
        "history": history,
        "train_acc": float(accuracy(logits, labels, masks["train"])),
        "val_acc": float(accuracy(logits, labels, masks["val"])),
        "test_acc": float(accuracy(logits, labels, masks["test"])),
        "mean_epoch_time": sum(times) / len(times) if times else float("nan"),
    }
