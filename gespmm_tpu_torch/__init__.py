"""gespmm_tpu_torch — the PyTorch and CUDA port of gespmm_tpu, for NVIDIA Hopper.

Ported so far (the GCN training path): CSR/CSC/COO containers, .mtx ingest
and the synthetic graph generators, ``Adjacency`` + ``spmm`` (sum/mean) with
a transpose-paired autograd Function over a hand-written CUDA CSR SpMM
kernel, the GCN model, its training loop, timing and the GCN benchmark.

Layering mirrors the JAX package:
    sparse/    formats (CSR/CSC/COO of torch tensors), .mtx ingest
    csrc/      CUDA C++ kernels for sm_90a
    kernels/   nvcc build + ctypes wrappers (plain version on CPU tensors)
    ops/       spmm with its autograd Function, graph ops, plain reference
    models/    GCN
    train/     training loop
    utils/     datasets, timing
    bench/     GCN benchmark CLI

Importing the package needs no compiler and no GPU: kernels build at
their first launch.
"""

from gespmm_tpu_torch.sparse.formats import COO, CSC, CSR, csr_from_coo, csr_to_csc
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.ops.graph import gcn_aggregate

__version__ = "0.1.0"

__all__ = [
    "Adjacency",
    "CSR",
    "CSC",
    "COO",
    "csr_from_coo",
    "csr_to_csc",
    "spmm",
    "gcn_aggregate",
    "__version__",
]
