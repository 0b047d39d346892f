"""Node-classification training — port of ``gespmm_tpu/train/loop.py``.

AdamW (``torch.optim.AdamW`` matches ``optax.adamw``: decoupled decay on
every parameter, the same bias correction, eps outside the square root),
masked NLL loss, per-epoch timing, train/val/test accuracy, and
checkpoint/resume (``train/checkpoint.py``).  Epoch time is the mean over
the epochs after the warm-up ones, as in the JAX loop; on the card it is
taken with CUDA events around each epoch.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from gespmm_tpu_torch.train import checkpoint
from gespmm_tpu_torch.utils.profiling import span

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
    """One optimizer step per call; returns the loss (a device scalar).
    The step and its five phases each run under a span
    (``utils/profiling.py``)."""

    def step() -> Tensor:
        with span("step"):
            model.train()
            with span("step/zero_grad"):
                optimizer.zero_grad(set_to_none=True)
            with span("step/forward"):
                log_probs = model.log_probs(adj, x, generator=generator)
            with span("step/loss"):
                loss = masked_nll_loss(log_probs, labels, mask)
            # The backward frees the log-probabilities once their node has
            # run; a name held here would keep them to the step's end.
            del log_probs
            with span("step/bwd"):
                loss.backward()
            with span("step/optimizer"):
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


def train_state(model, optimizer: torch.optim.Optimizer,
                generator: torch.Generator) -> Dict[str, Any]:
    """The checkpointed state of a run: the model's and the optimizer's
    state dicts and the dropout generator's state.  Before AdamW's first
    step its state is empty; the template then holds the zeros that step
    would create, so that ``checkpoint.restore`` can check a stored state
    against it."""
    opt = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if not opt["state"] and isinstance(optimizer, torch.optim.AdamW):
        opt["state"] = {i: {"step": torch.tensor(0.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
                        for i, p in enumerate(params)}
    return {"model": model.state_dict(), "optimizer": opt,
            "generator": generator.get_state()}


def train_node_classifier(model, adj, x: Tensor, labels: Tensor,
                          masks: Dict[str, Tensor], *, seed: int = 0,
                          lr: float = 1e-2, weight_decay: float = 5e-4,
                          epochs: int = 200, log_every: int = 0,
                          checkpoint_dir: Optional[str] = None,
                          checkpoint_every: int = 0) -> Dict[str, Any]:
    """Full training run on ``x.device``; returns metrics and history.

    ``seed`` seeds the dropout generator; the model arrives initialised.
    With ``checkpoint_dir`` the run resumes from the directory's latest
    checkpoint, at its epoch, and with ``checkpoint_every`` > 0 it saves
    after epoch e + 1 whenever ``(e + 1) % checkpoint_every == 0``, as the
    JAX loop does.  A resumed run equals the uninterrupted one.
    """
    generator = torch.Generator(device=x.device).manual_seed(seed)
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  weight_decay=weight_decay)
    start_epoch = 0
    if checkpoint_dir:
        ckpt = checkpoint.latest_checkpoint(checkpoint_dir)
        if ckpt is not None:
            state, start_epoch = checkpoint.restore(
                ckpt, train_state(model, optimizer, generator))
            model.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])
            generator.set_state(state["generator"])
    step = make_train_step(model, optimizer, adj, x, labels, masks["train"],
                           generator=generator)

    def evaluate():
        model.eval()
        with torch.no_grad():
            return model(adj, x)

    clock = _EpochClock(x.device)
    warmup_end = start_epoch + min(WARMUP_EPOCHS,
                                   max(epochs - start_epoch - 1, 0))
    history = {"loss": [], "val_acc": [], "epoch_time": []}
    losses = []
    for epoch in range(start_epoch, epochs):
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
        if (checkpoint_dir and checkpoint_every
                and (epoch + 1) % checkpoint_every == 0):
            checkpoint.save(checkpoint_dir,
                            train_state(model, optimizer, generator),
                            epoch + 1)
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
