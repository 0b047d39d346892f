"""Helpers of the port's model tests, on the CPU and on the card.

Imports neither JAX nor the JAX package.
"""

import numpy as np
import torch

from gespmm_tpu_torch.sparse.formats import CSR
from gespmm_tpu_torch.utils import profiling

# (in, out): a layer that widens, one that narrows, one that keeps its width.
WIDTHS = {"widens": (6, 11), "narrows": (11, 6), "keeps": (8, 8)}


def empty_rows_graph():
    """A random binary 40 x 40 CSR with empty rows and empty columns, and
    its dense float64 matrix."""
    rng = np.random.default_rng(0)
    dense = (rng.random((40, 40)) < 0.15).astype(np.float64)
    dense[::7] = 0.0
    dense[:, 3::9] = 0.0
    indptr = np.concatenate([[0], np.cumsum(dense.sum(1))]).astype(np.int32)
    indices = np.nonzero(dense)[1].astype(np.int32)
    csr = CSR(torch.from_numpy(indptr), torch.from_numpy(indices), None,
              (40, 40))
    return csr, torch.from_numpy(dense)


def spmm_widths(monkeypatch, module):
    """Route ``module.spmm`` through a wrapper; the list it returns gets B's
    width at each call."""
    widths = []
    inner = module.spmm

    def counted(adj, B, *args, **kwargs):
        widths.append(B.shape[1])
        return inner(adj, B, *args, **kwargs)

    monkeypatch.setattr(module, "spmm", counted)
    return widths


def step_spmm_counts(monkeypatch, module, step):
    """Run ``step()`` once under ``profiling.recording()``: B's width at
    each ``module.spmm`` call, and the numbers of ``op/spmm`` and
    ``op/spmm.grad`` spans."""
    widths = spmm_widths(monkeypatch, module)
    with profiling.recording() as rec:
        step()
    names = [s[0] for s in rec.spans]
    return widths, names.count("op/spmm"), names.count("op/spmm.grad")


def saved_activations(model, adj, x, width):
    """Distinct float32 (n, ``width``) tensors that a training-mode forward
    (dropout seed 1) saves for the backward."""
    seen = set()

    def pack(t):
        if t.dtype == torch.float32 and t.shape == (x.shape[0], width):
            seen.add(t.untyped_storage().data_ptr())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.train()(adj, x, generator=torch.Generator().manual_seed(1))
    return len(seen)
