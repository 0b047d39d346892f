"""SpMM with transpose-paired autograd Functions — port of ``gespmm_tpu/ops/spmm.py``.

The backward of SpMM is SpMM on Aᵀ, so ``Adjacency`` carries both the CSR
and the CSC ordering (plus the CSC -> CSR edge permutation), built once per
graph, and the backward never transposes at step time.  Sum:

  * grad_B = Aᵀ @ g, the same tier over the CSC with ``data[perm]``;
  * grad_values[e] = g[row_e] · B[col_e] (SDDMM, in CSR order), computed
    only when the edge values require a gradient.

Max/min route the gradient through the edges that achieve each output,
split evenly among ties (``jnp.max``'s VJP, as in the JAX package): the
forward kernel returns the tie counts with ``out``, and the backward kernel
walks the CSC, giving grad_B and grad_values (back to CSR order through
``perm``).  A sum or mean runs under the span ``op/spmm``, its backward
under ``op/spmm.grad``; a max or min under ``op/spmm_minmax`` and
``op/spmm_minmax.grad``, so that a trace tells the two paths apart.

``reduce="mean"`` composes on sum.  Method tiers, with the reductions each
takes (``_METHOD_REDUCES``, as in the JAX package):

  * ``"auto"``/``"tiled"``: the CUDA kernels on a CUDA tensor (the CSR sum
    kernel, the max/min kernels), their plain versions on a CPU tensor.
    For a sum, ``"auto"`` takes the CSR kernel whatever plan the adjacency
    holds: with its long rows split over warps it was the fastest of the
    CSR, chunk and grouped kernels at every shape the card timed but one,
    where the chunk kernel led by less than the run-to-run spread (PERF.md,
    PR 7: sbm-pubmed, both rmat15, K = 32 and 128), where the JAX package's
    ``auto`` took the grouped kernel on the TPU;
  * ``"xla"``: the plain PyTorch version on any device (the explicit
    reference tier, named after the JAX package's tier);
  * ``"pallas"`` (sum/mean): the nnz-chunked kernel over a per-row chunk
    plan (``Adjacency.from_csr(csr, plan="perrow")``), or the grouped-gather
    kernel over a grouped plan (``plan="grouped"``), forward and, over the
    transposed plan, grad_B (the CSR kernel where there is no such plan);
  * ``"scatter"`` (sum/mean): the push formulation, one ``index_add_``;
  * ``"dense"`` (sum/mean): densify and ``torch.matmul``, size-guarded.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional, Union

import numpy as np
import torch

from gespmm_tpu_torch.kernels.spmm_csr import spmm_csr
from gespmm_tpu_torch.kernels.spmm_grouped import spmm_grouped
from gespmm_tpu_torch.kernels.spmm_minmax import spmm_minmax, spmm_minmax_vjp
from gespmm_tpu_torch.kernels.spmm_pallas import spmm_pallas
from gespmm_tpu_torch.ops import reference as ref
from gespmm_tpu_torch.sparse.formats import CSC, CSR
from gespmm_tpu_torch.sparse.partition import (GroupedSpmmPlan, RowSplit,
                                                SpmmPlan,
                                                build_grouped_plan,
                                                build_row_split,
                                                build_spmm_plan)
from gespmm_tpu_torch.utils import native as _native
from gespmm_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

MODES = ("trilo", "hilo", "fast", "highest")
REDUCES = ("sum", "mean", "max", "min")
# Reductions each EXPLICIT method supports (mean composes on sum); an
# explicitly requested tier never silently runs another.
_METHOD_REDUCES = {
    "tiled": REDUCES,
    "pallas": ("sum", "mean"),
    "scatter": ("sum", "mean"),
    "dense": ("sum", "mean"),
    "xla": REDUCES,
    "auto": REDUCES,
}
METHODS = tuple(_METHOD_REDUCES)
PLANS = (False, True, "auto", "tiled", "perrow", "grouped")
_BUILDERS = {"perrow": build_spmm_plan, "grouped": build_grouped_plan}


def _build_plan(indptr, indices, shape, kind,
                plan_kwargs) -> Optional[SpmmPlan]:
    """The plan object of ``kind``: None for the tiled kinds (the CSR kernel
    walks the CSR and needs none), the per-row chunk plan for "perrow", the
    grouped plan for "grouped".  Unknown ``plan_kwargs`` are ignored, as the
    JAX package filters them by the builder's signature."""
    if kind in (True, "auto", "tiled"):
        return None
    if kind not in _BUILDERS:
        raise ValueError(f"unknown plan kind {kind!r}; expected one of {PLANS}")
    build = _BUILDERS[kind]
    sig = inspect.signature(build).parameters
    kw = {k: v for k, v in plan_kwargs.items() if k in sig}
    return build(CSR(indptr, indices, None, shape), **kw)


@dataclasses.dataclass(frozen=True)
class Adjacency:
    """A sparse matrix with both row- and column-compressed orderings.

    ``perm`` maps CSC edge order -> CSR edge order (``csc.data = data[perm]``);
    ``inv_perm`` is its inverse.  ``rows``/``rows_t`` are the per-nonzero row
    ids of the CSR and of the CSC (the CSR of Aᵀ).  ``plan``/``plan_t`` are
    the chunk plans of A and Aᵀ (``plan="perrow"`` or ``"grouped"``), or
    None.  ``split``/``split_t`` are the row splits of the CSR and of the CSC
    (``sparse/partition.py::build_row_split``), the CSR kernel's work lists
    for rows longer than L, built on the host with the orderings.
    """

    csr: CSR
    csc: CSC
    perm: Tensor
    rows: Tensor
    rows_t: Tensor
    inv_perm: Tensor
    plan: Optional[SpmmPlan] = None  # or its subclass GroupedSpmmPlan
    plan_t: Optional[SpmmPlan] = None
    split: Optional[RowSplit] = None
    split_t: Optional[RowSplit] = None

    @classmethod
    def from_csr(cls, csr: CSR, device=None, plan=False, plan_transpose=True,
                 use_native: Optional[bool] = None,
                 **plan_kwargs) -> "Adjacency":
        """Build the paired orderings on the host, then move them to
        ``device`` (default: the device ``csr`` lives on).

        ``plan``: False (none) | True / "auto" / "tiled" (the CSR kernel's
        tier, which needs no plan object) | "perrow" (the chunk plans of
        ``method="pallas"``, with ``rows_per_block``/``chunk_nnz`` from
        ``plan_kwargs``) | "grouped" (the grouped plans of
        ``method="pallas"``, with ``rows_per_block``,
        ``edges_per_chunk``, ``groups_per_chunk``/``group_rows`` from
        ``plan_kwargs``).  ``plan_transpose=False`` skips the plan of Aᵀ;
        grad_B then takes the CSR kernel (the JAX package takes its plain
        tier there).  ``use_native`` picks the CSC transform: the native
        counting sort (``utils/native.py``) under None when available or
        under True, else a stable argsort; both give the same arrays.
        Each phase runs under its span (``utils/profiling.py::SPANS``,
        ``graph_prep/*``): the copy down, the host passes, the copies up.
        """
        with span("graph_prep"):
            device = csr.device if device is None else torch.device(device)
            m, n = csr.shape
            with span("graph_prep/d2h"):
                indptr_h = csr.indptr.cpu().numpy()
                indices_h = csr.indices.cpu().numpy()
            nnz = int(indices_h.shape[0])
            with span("graph_prep/rows"):
                rows_h = np.repeat(np.arange(m, dtype=np.int32),
                                   np.diff(indptr_h))
            with span("graph_prep/csc"):
                if _native.wanted(use_native):
                    colptr_h, csc_rows_h, perm_h = (
                        _native.csr_to_csc_native(indptr_h, indices_h, m, n))
                    colptr_h = colptr_h.astype(np.int64)
                else:
                    order = np.argsort(indices_h, kind="stable")
                    colptr_h = np.zeros(n + 1, np.int64)
                    colptr_h[1:] = np.cumsum(
                        np.bincount(indices_h, minlength=n))
                    perm_h = order.astype(np.int32)
                    csc_rows_h = rows_h[order]
            with span("graph_prep/rows"):
                rows_t_h = np.repeat(np.arange(n, dtype=np.int32),
                                     np.diff(colptr_h))
            with span("graph_prep/inv_perm"):
                inv_perm_h = np.empty_like(perm_h)
                inv_perm_h[perm_h] = np.arange(nnz, dtype=np.int32)
            p = pt = None
            with span("graph_prep/plans"):
                if plan:
                    p = _build_plan(indptr_h, indices_h, (m, n), plan,
                                    plan_kwargs)
                    if plan_transpose:
                        pt = _build_plan(colptr_h.astype(np.int32),
                                         csc_rows_h, (n, m), plan,
                                         plan_kwargs)
            with span("graph_prep/split"):
                split_h = build_row_split(indptr_h)
                split_t_h = build_row_split(colptr_h)

            def dev(a: np.ndarray) -> Tensor:
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

            with span("graph_prep/h2d"):
                csr_d = csr.to(device)
                perm = dev(perm_h)
                csc = CSC(
                    indptr=dev(colptr_h.astype(np.int32)),
                    indices=dev(csc_rows_h),
                    data=(None if csr_d.data is None
                          else csr_d.data[perm.long()]),
                    shape=(m, n),
                )
                # The plans walk the adjacency's own device arrays.
                if p is not None:
                    p = dataclasses.replace(p.to(device),
                                            indptr=csr_d.indptr,
                                            indices=csr_d.indices)
                if pt is not None:
                    pt = dataclasses.replace(pt.to(device),
                                             indptr=csc.indptr,
                                             indices=csc.indices)
                return cls(csr=csr_d, csc=csc, perm=perm, rows=dev(rows_h),
                           rows_t=dev(rows_t_h), inv_perm=dev(inv_perm_h),
                           plan=p, plan_t=pt, split=split_h.to(device),
                           split_t=split_t_h.to(device))

    @property
    def shape(self):
        return self.csr.shape

    @property
    def nnz(self) -> int:
        return self.csr.nnz

    @property
    def data(self) -> Optional[Tensor]:
        return self.csr.data

    def with_data(self, data: Optional[Tensor]) -> "Adjacency":
        csc_data = None if data is None else data[self.perm.long()]
        return dataclasses.replace(self, csr=self.csr.with_data(data),
                                   csc=self.csc.with_data(csc_data))

    def transpose(self) -> "Adjacency":
        """Adjacency of Aᵀ (cheap — swaps the paired orderings)."""
        m, n = self.shape
        return Adjacency(
            csr=CSR(self.csc.indptr, self.csc.indices, self.csc.data, (n, m)),
            csc=CSC(self.csr.indptr, self.csr.indices, self.csr.data, (n, m)),
            perm=self.inv_perm, rows=self.rows_t, rows_t=self.rows,
            inv_perm=self.perm, plan=self.plan_t, plan_t=self.plan,
            split=self.split_t, split_t=self.split,
        )


def _forward(method: str, mode: str, indptr: Tensor, indices: Tensor,
             data: Optional[Tensor], B: Tensor, rows: Tensor,
             plan: Optional[SpmmPlan], split: Optional[RowSplit]) -> Tensor:
    m = indptr.shape[0] - 1
    # The kernels take a contiguous B; a column slice or a transposed view
    # is a valid operand of the op.
    if method == "pallas" and isinstance(plan, GroupedSpmmPlan):
        return spmm_grouped(plan, data, B.contiguous(), m)
    if method == "pallas" and plan is not None:
        return spmm_pallas(plan, data, B.contiguous(), m)
    if method == "scatter":
        return ref.spmm_scatter(rows, indices, data, B, m)
    if method == "dense":
        return ref.spmm_dense(rows, indices, data, B, m)
    if method == "xla":
        return ref.spmm_rows(rows, indices, data, B, m)
    # "auto"/"tiled", and "pallas" without a plan for this direction (the
    # grad_B of an Adjacency built with plan_transpose=False): the CSR
    # kernel, which needs none.  "fast" rounds B to bf16 once: the kernel
    # gathers half the bytes and accumulates and writes in f32.
    if mode == "fast" and B.dtype == torch.float32:
        return spmm_csr(indptr, indices, data, B.to(torch.bfloat16), rows=rows,
                        split=split, out_dtype=torch.float32)
    return spmm_csr(indptr, indices, data, B.contiguous(), rows=rows,
                    split=split)


class _SpmmSum(torch.autograd.Function):
    """Sum-SpMM over ``adj``; differentiable in ``data`` and ``B``."""

    @staticmethod
    def forward(ctx, adj: Adjacency, method: str, mode: str,
                data: Optional[Tensor], B: Tensor) -> Tensor:
        ctx.adj, ctx.method, ctx.mode = adj, method, mode
        ctx.save_for_backward(data, B if ctx.needs_input_grad[3] else None)
        return _forward(method, mode, adj.csr.indptr, adj.csr.indices, data,
                        B, adj.rows, adj.plan, adj.split)

    @staticmethod
    def backward(ctx, g: Tensor):
        with span("op/spmm.grad"):
            adj, method = ctx.adj, ctx.method
            data, B = ctx.saved_tensors
            g = g.contiguous()  # autograd often hands in an expanded view
            grad_data = grad_B = None
            if ctx.needs_input_grad[4]:
                t_data = None if data is None else data[adj.perm.long()]
                grad_B = _forward(method, ctx.mode, adj.csc.indptr,
                                  adj.csc.indices, t_data, g, adj.rows_t,
                                  adj.plan_t, adj.split_t)
            if data is not None and ctx.needs_input_grad[3]:
                grad_data = ref.sddmm_rows(adj.rows, adj.csr.indices, g, B)
                grad_data = grad_data.to(data.dtype)
            return None, None, None, grad_data, grad_B


class _SpmmMinMax(torch.autograd.Function):
    """Max/min-SpMM over ``adj``; differentiable in ``data`` and ``B``."""

    @staticmethod
    def forward(ctx, adj: Adjacency, method: str, reduce: str,
                data: Optional[Tensor], B: Tensor) -> Tensor:
        B = B.contiguous()
        if method == "xla":
            ties = None  # the plain VJP recounts them
            out = ref.spmm_rows(adj.rows, adj.csr.indices, data, B,
                                adj.shape[0], reduce=reduce)
        else:
            out, ties = spmm_minmax(adj.csr.indptr, adj.csr.indices, data, B,
                                    reduce, rows=adj.rows, split=adj.split)
        ctx.adj, ctx.method = adj, method
        ctx.save_for_backward(data, B, out, ties)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        with span("op/spmm_minmax.grad"):
            adj, method = ctx.adj, ctx.method
            data, B, out, ties = ctx.saved_tensors
            g = g.contiguous()
            want_values = data is not None and ctx.needs_input_grad[3]
            if method == "xla":
                # The JAX package's plain VJP: ties recounted against ``out``.
                grad_c = ref.spmm_max_vjp_edges(adj.rows, adj.csr.indices,
                                                data, B, out, g, adj.shape[0])
                scaled = (grad_c if data is None
                          else grad_c * data.to(grad_c.dtype)[:, None])
                grad_B = torch.zeros((B.shape[0], B.shape[1]),
                                     dtype=grad_c.dtype, device=B.device)
                grad_B.index_add_(0, adj.csr.indices.long(), scaled)
                grad_data = None
                if want_values:
                    gathered = B.index_select(0, adj.csr.indices.long())
                    grad_data = (grad_c * gathered.to(grad_c.dtype)).sum(-1)
            else:
                t_data = None if data is None else data[adj.perm.long()]
                grad_B, grad_data = spmm_minmax_vjp(
                    adj.csc.indptr, adj.csc.indices, t_data, B, out, g, ties,
                    want_values=want_values, cols=adj.rows_t,
                    split=adj.split_t)
                if grad_data is not None:  # CSC order -> CSR order
                    grad_data = grad_data[adj.inv_perm.long()]
            if grad_data is not None:
                grad_data = grad_data.to(data.dtype)
            grad_B = grad_B.to(B.dtype) if ctx.needs_input_grad[4] else None
            return None, None, None, grad_data, grad_B


def _check_method(adj: Adjacency, reduce: str, method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    if reduce not in _METHOD_REDUCES[method]:
        raise ValueError(
            f"method={method!r} does not support reduce={reduce!r} "
            f"(supported: {_METHOD_REDUCES[method]}); use method='auto' or "
            "'xla'")
    if method == "pallas" and not isinstance(adj.plan, SpmmPlan):
        raise ValueError("method='pallas' needs an Adjacency built with "
                         "plan='perrow' or 'grouped' "
                         "(Adjacency.from_csr(csr, plan='perrow'))")


def spmm(adj: Union[Adjacency, CSR], B: Tensor, *, reduce: str = "sum",
         method: str = "auto", mode: str = "trilo") -> Tensor:
    """C = reduce_e A[r, c_e] * B[c_e, :] — sparse × dense.

    Args:
      adj: ``Adjacency`` (preferred — carries the transpose pairing) or a
        bare ``CSR`` (the pairing is built on the fly).
      B: dense (n, K) tensor, float32 or bfloat16 on the card.
      reduce: "sum" | "mean" | "max" | "min" (empty rows give 0 under each).
      method: "auto" | "tiled" (the CUDA kernels on the card; a sum takes
        the CSR kernel on any adjacency) | "xla" (plain) | "pallas" (the
        chunked or the grouped kernel; needs ``plan="perrow"`` or
        ``"grouped"``) | "scatter" | "dense" (the last three sum/mean only).
      mode: the precision tier of the CSR kernel's sum, as the JAX
        package's is of its tiled stream.  "fast" rounds an f32 B to bf16
        once (one torch op); the kernel gathers the bf16 rows (half the
        bytes), accumulates in f32 and writes f32, forward and grad_B: the
        JAX contract of about 4e-3 relative, and with a binary A the JAX
        fast result (both round the same values).  "trilo", "hilo" and
        "highest" run the f32 kernel, which meets hilo's ~1e-5: on CUDA
        cores a hi/lo pair of bf16 values moves the bytes of f32.  Other
        routes and reductions accumulate in f32 in every mode.

    Differentiable in ``B`` and in ``adj``'s edge values (if present).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be trilo|hilo|fast|highest, got {mode!r}")
    if isinstance(adj, CSR):
        adj = Adjacency.from_csr(adj)
    if B.dim() != 2:
        raise ValueError(f"B must be rank 2, got shape {tuple(B.shape)}")
    m, n = adj.shape
    if B.shape[0] != n:
        raise ValueError(
            f"A is {adj.shape}, B is {tuple(B.shape)}: inner dims differ"
        )
    _check_method(adj, reduce, method)
    if reduce in ("max", "min"):
        with span("op/spmm_minmax"):
            return _SpmmMinMax.apply(adj, method, reduce, adj.csr.data, B)
    with span("op/spmm"):
        out = _SpmmSum.apply(adj, method, mode, adj.csr.data, B)
        if reduce == "mean":
            deg = (adj.csr.indptr[1:] - adj.csr.indptr[:-1]).to(out.dtype)
            out = out / torch.clamp(deg, min=1.0)[:, None]
        return out
