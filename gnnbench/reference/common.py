"""Plain PyTorch pieces of the references: the graph's edge lists, a sum
SpMM in blocks of edges, dropout, the masked loss, Adam, and three
training steps with the readings the benchmark compares.

Float32 with TF32 off.  ``tf32=True`` computes every matrix product of the
model, forward and backward, on operands rounded to TF32 (10 explicit
mantissa bits, round to nearest even) with a float32 accumulation, which
is what the tensor cores do in TF32: the control, one precision below the
configuration's.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Tensor = torch.Tensor

# Gathered bytes of one block of edges in the blocked SpMM.
BLOCK_BYTES = 1 << 30


@dataclasses.dataclass
class EdgeGraph:
    """A square binary adjacency as edge lists: nonzero e joins row
    ``rows[e]`` to column ``cols[e]`` (int32)."""

    n: int
    rows: Tensor
    cols: Tensor

    @classmethod
    def from_csr(cls, n: int, indptr: Tensor, indices: Tensor) -> "EdgeGraph":
        deg = (indptr[1:] - indptr[:-1]).long()
        rows = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=indices.device), deg)
        return cls(n=n, rows=rows, cols=indices)

    def row_degree(self) -> Tensor:
        return torch.bincount(self.rows, minlength=self.n)

    def col_degree(self) -> Tensor:
        return torch.bincount(self.cols, minlength=self.n)


def _blocked_sum(out: Tensor, dst: Tensor, src: Tensor, B: Tensor) -> Tensor:
    """out[dst[e]] += B[src[e]] over every edge, in blocks of edges."""
    block = max(1, BLOCK_BYTES // max(1, B.shape[1] * B.element_size()))
    for s in range(0, dst.shape[0], block):
        out.index_add_(0, dst[s:s + block], B.index_select(0, src[s:s + block]))
    return out


class _Spmm(torch.autograd.Function):
    """A @ B for the binary adjacency of ``graph``; grad_B = Aᵀ @ g."""

    @staticmethod
    def forward(ctx, B: Tensor, graph: EdgeGraph) -> Tensor:
        ctx.graph = graph
        out = torch.zeros((graph.n, B.shape[1]), dtype=B.dtype, device=B.device)
        return _blocked_sum(out, graph.rows, graph.cols, B)

    @staticmethod
    def backward(ctx, g: Tensor):
        graph = ctx.graph
        grad = torch.zeros((graph.n, g.shape[1]), dtype=g.dtype, device=g.device)
        return _blocked_sum(grad, graph.cols, graph.rows, g.contiguous()), None


def spmm(graph: EdgeGraph, B: Tensor) -> Tensor:
    return _Spmm.apply(B, graph)


def round_tf32(x: Tensor) -> Tensor:
    """``x`` rounded to TF32's 10 explicit mantissa bits (nearest even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _Tf32Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor) -> Tensor:
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g: Tensor):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.t(), a.t() @ g


def matmul_fn(tf32: bool) -> Callable[[Tensor, Tensor], Tensor]:
    """The model's matrix product: float32, or TF32 for the control."""
    return _Tf32Mm.apply if tf32 else torch.matmul


def dropout(h: Tensor, rate: float, gen: torch.Generator) -> Tensor:
    """Inverted dropout, one uniform draw a value from ``gen``: a value is
    kept where its draw is below 1 - rate."""
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype,
                                                    device=h.device))


def init_params(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator,
                device) -> Dict[str, Tensor]:
    """Every leaf of ``shapes``: weights (2-D) Glorot uniform in
    [-sqrt(6 / (fan_in + fan_out)), +...) from one draw of ``gen``, biases
    (1-D) zero."""
    limits = {k: math.sqrt(6.0 / (s[0] + s[-1])) for k, s in shapes.items()
              if len(s) == 2}
    total = sum(math.prod(shapes[k]) for k in limits)
    u = torch.rand(total, generator=gen, device=device)
    params, at = {}, 0
    for k, shape in shapes.items():
        if k in limits:
            size = math.prod(shape)
            params[k] = (u[at:at + size].view(shape) * (2.0 * limits[k])
                         - limits[k])
            at += size
        else:
            params[k] = torch.zeros(shape, device=device)
    return params


def masked_nll(logits: Tensor, labels: Tensor, train: Tensor) -> Tensor:
    """Mean negative log-likelihood over the nodes ``train`` (indices)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[train, labels[train]].mean()


@dataclasses.dataclass
class Readings:
    """What is compared: the loss of each step, the first step's gradient
    of every leaf, and every leaf's change over the steps."""

    losses: List[float]
    grad1: Dict[str, Tensor]
    delta: Dict[str, Tensor]


def train(forward: Callable, graph: EdgeGraph, x: Tensor, labels: Tensor,
          train_mask: Tensor, init: Dict[str, Tensor], dropout_seed: int, *,
          lr: float, steps: int = 3, betas: Sequence[float] = (0.9, 0.999),
          eps: float = 1e-8, tf32: bool = False,
          half_batch: bool = False) -> Readings:
    """``steps`` full-batch Adam steps of ``forward(params, graph, x, gen,
    mm)`` from ``init``, its dropout drawn from a generator on ``x``'s
    device seeded with ``dropout_seed``.  ``half_batch`` takes the loss's
    mean over the first half of the training nodes alone (a fault)."""
    gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
    train = torch.nonzero(train_mask).flatten()
    if half_batch:
        train = train[:train.shape[0] // 2]
    mm = matmul_fn(tf32)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in init.items()}
    v2 = {k: torch.zeros_like(v) for k, v in init.items()}
    b1, b2 = betas
    losses, grad1 = [], {}
    for t in range(1, steps + 1):
        loss = masked_nll(forward(params, graph, x, gen, mm), labels, train)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                if t == 1:
                    grad1[k] = g.clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v2[k] / (1 - b2 ** t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
        del loss, grads
    delta = {k: (p.detach() - init[k]) for k, p in params.items()}
    return Readings(losses=losses, grad1=grad1, delta=delta)
