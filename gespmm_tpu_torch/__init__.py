"""gespmm_tpu_torch — the PyTorch and CUDA port of gespmm_tpu, for NVIDIA Hopper.

Ported so far (the GCN and GraphSAGE training paths): CSR/CSC/COO
containers, .mtx ingest and the synthetic graph generators, ``Adjacency`` +
``spmm`` (sum/mean/max/min) with transpose-paired autograd Functions over
hand-written CUDA kernels (CSR sum SpMM; max/min SpMM with tie counts and
its CSC backward), the GCN and GraphSAGE models, the training loop, timing
and the GCN and SAGE benchmarks.

Layering mirrors the JAX package:
    sparse/    formats (CSR/CSC/COO of torch tensors), .mtx ingest
    csrc/      CUDA C++ kernels for sm_90a
    kernels/   nvcc build + ctypes wrappers (plain version on CPU tensors)
    ops/       spmm with its autograd Function, graph ops, plain reference
    models/    GCN, GraphSAGE
    train/     training loop
    utils/     datasets, timing
    bench/     GCN and SAGE benchmark CLIs

Importing the package needs no compiler and no GPU: kernels build at
their first launch.
"""

from gespmm_tpu_torch.sparse.formats import COO, CSC, CSR, csr_from_coo, csr_to_csc
from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
from gespmm_tpu_torch.ops.graph import gcn_aggregate, sage_aggregate

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
    "sage_aggregate",
    "__version__",
]
