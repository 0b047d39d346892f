"""gespmm_tpu_torch — the PyTorch and CUDA port of gespmm_tpu, for NVIDIA Hopper.

Ported so far (the GCN, GraphSAGE and GAT training paths, dot-product
attention, the SpMM sweep and the grouped SpMM on reordered graphs):
CSR/CSC/COO containers, .mtx ingest, the synthetic graph generators and
RCM/degree/BFS reordering, ``Adjacency`` (with per-row chunk plans and
grouped plans) + ``spmm`` (sum/mean/max/min; tiers
auto/tiled/xla/pallas/scatter/dense) with transpose-paired autograd
Functions over hand-written CUDA kernels (CSR sum SpMM; nnz-chunked sum
SpMM; grouped-gather sum SpMM; max/min SpMM with tie counts and its CSC
backward), ``sddmm``, ``edge_softmax`` and ``additive_attention_logits``
over an edge segment-reduce kernel, the fused attention ops
``gat_attention_aggregate`` and ``dot_attention_aggregate`` (forward, CSR
and CSC backward kernels each) and ``attention_aggregate``,
``torch.sparse`` interop and the drop-in ``AdjacencyMatrix``, the GCN,
GraphSAGE (with the LSTM aggregator) and GAT models, their stock-PyTorch
baselines, the training loop with checkpoint/resume, timing, profiling, the
GCN, SAGE, GAT and SpMM/SDDMM benchmarks and the headline line.

Layering mirrors the JAX package's, except that the fused attention ops
sit in ops/ over their launches in kernels/:
    sparse/    formats (CSR/CSC/COO of torch tensors), .mtx ingest, the
               per-row chunk plan and the grouped plan, reordering
    csrc/      CUDA C++ kernels for sm_90a
    kernels/   nvcc build + ctypes launches (plain version on CPU tensors);
               they call no op-layer code but the plain reference
    ops/       spmm, sddmm, the graph ops and the fused attention ops with
               their autograd Functions, torch.sparse interop, plain
               reference
    models/    GCN, GraphSAGE (LSTM aggregator), GAT, stock baselines; they
               reach the kernels only through ops/
    train/     training loop, checkpoint/resume
    utils/     datasets, timing, profiling (roofline)
    bench/     GCN, SAGE, GAT and SpMM/SDDMM benchmark CLIs, the headline

Importing the package needs no compiler and no GPU: kernels build at
their first launch.
"""

from gespmm_tpu_torch.sparse.formats import COO, CSC, CSR, csr_from_coo, csr_to_csc
from gespmm_tpu_torch.sparse.partition import GroupedSpmmPlan, build_grouped_plan
from gespmm_tpu_torch.sparse.reorder import reorder
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.ops.sddmm import sddmm, sddmm_coo
from gespmm_tpu_torch.ops.graph import (additive_attention_logits,
                                        attention_aggregate,
                                        dot_attention_aggregate, edge_softmax,
                                        gat_attention, gat_attention_aggregate,
                                        gcn_aggregate, sage_aggregate)

__version__ = "0.1.0"

__all__ = [
    "Adjacency",
    "CSR",
    "CSC",
    "COO",
    "csr_from_coo",
    "csr_to_csc",
    "reorder",
    "GroupedSpmmPlan",
    "build_grouped_plan",
    "spmm",
    "sddmm",
    "sddmm_coo",
    "edge_softmax",
    "additive_attention_logits",
    "gat_attention",
    "gat_attention_aggregate",
    "attention_aggregate",
    "dot_attention_aggregate",
    "gcn_aggregate",
    "sage_aggregate",
    "__version__",
]
