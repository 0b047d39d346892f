"""The per-row chunk plan — port of ``gespmm_tpu/sparse/partition.py::build_spmm_plan``.

The JAX package cuts a CSR into row blocks of R rows and each block's
nonzeros into ceil(nnz_b / E) chunks of at most E edges (at least one chunk
per block), so that every step of the TPU kernel does the same work and a
hub row spreads over many chunks.  This module does the same cutting on the
host, in NumPy, and keeps it as the work list of the chunked SpMM kernel
(``csrc/spmm_chunk.cu``).  Its layout is Hopper's, not the TPU's padded
(C, E) slot arrays: a chunk is a range of CSR edges, which the kernel reads
straight from the CSR's ``indices`` and ``data``.

Per chunk c (C chunks in block order):

  * ``chunk_start[c]``, ``chunk_count[c]``: its CSR edges
    [start, start + count), count <= E (0 only for a block without edges);
  * ``block_ids[c]``, ``first[c]``: its row block, and 1 on a block's first
    chunk (the JAX plan's two scalar-prefetch arrays);
  * ``row_lo[c]``, ``row_hi[c]``: the rows the chunk walks.  A row with edges
    is walked by every chunk its edges fall in; an empty row by the chunk
    whose range holds its offset (the block's last chunk for an offset at
    the block's end), so that every row is written;
  * ``head_slot[c]``, ``tail_slot[c]``: where the chunk writes the partial
    sums of a row it shares with the chunks before it (its first row) or
    after it (its last row), or -1.

A row cut by a chunk boundary ("cut row") is written by the carry pass:
``cut_rows[j]`` is its row and its partials are the slots
[cut_ptr[j], cut_ptr[j + 1]), in chunk order.  Every other row is written
once, directly, by the one chunk that holds all its edges.  None of it
depends on the edge values, so one plan serves every value of them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_ARRAYS = ("indptr", "indices", "chunk_start", "chunk_count", "block_ids",
           "first", "row_lo", "row_hi", "head_slot", "tail_slot", "cut_rows",
           "cut_ptr")


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """The chunk work list of one sparsity structure (int32 tensors), with
    the CSR structure (``indptr``, ``indices``) it cuts."""

    indptr: Tensor
    indices: Tensor
    chunk_start: Tensor
    chunk_count: Tensor
    block_ids: Tensor
    first: Tensor
    row_lo: Tensor
    row_hi: Tensor
    head_slot: Tensor
    tail_slot: Tensor
    cut_rows: Tensor
    cut_ptr: Tensor
    rows_per_block: int
    chunk_nnz: int
    shape: Tuple[int, int]
    nnz: int
    num_blocks: int
    num_slots: int  # rows of the carry pass's partial-sum buffer

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_start.shape[0])

    def to(self, device) -> "SpmmPlan":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _ARRAYS})


def build_spmm_plan(csr, rows_per_block: int = 128,
                    chunk_nnz: int = 256) -> SpmmPlan:
    """Build the chunk plan of one CSR structure on the host (NumPy).

    rows_per_block (R): output rows of one row block, a multiple of 8, as in
    the JAX package.  chunk_nnz (E): at most this many nonzeros a chunk.
    The JAX defaults (128, 256).  The plan's tensors are on the CPU;
    ``SpmmPlan.to`` moves them.  Raises ValueError on an (R, E) it does
    not take.
    """
    if rows_per_block < 8 or rows_per_block % 8:
        raise ValueError(f"rows_per_block must be a positive multiple of 8, "
                         f"got {rows_per_block}")
    if chunk_nnz < 1:
        raise ValueError(f"chunk_nnz must be at least 1, got {chunk_nnz}")
    indptr_t = torch.as_tensor(csr.indptr).cpu().to(torch.int32)
    indices_t = torch.as_tensor(csr.indices).cpu().to(torch.int32)
    indptr = indptr_t.numpy().astype(np.int64)
    m, n = csr.shape
    nnz = int(indptr[-1])
    R, E = rows_per_block, chunk_nnz

    num_blocks = max((m + R - 1) // R, 1)
    block_row0 = np.minimum(np.arange(num_blocks) * R, m)
    block_starts = indptr[block_row0]
    block_ends = indptr[np.minimum(block_row0 + R, m)]
    chunks_per_block = np.maximum((block_ends - block_starts + E - 1) // E, 1)
    chunk0 = np.concatenate([[0], np.cumsum(chunks_per_block)])
    C = int(chunk0[-1])

    block_ids = np.repeat(np.arange(num_blocks), chunks_per_block)
    k = np.arange(C) - chunk0[block_ids]  # chunk index within its block
    chunk_start = block_starts[block_ids] + k * E
    chunk_count = np.minimum(block_ends[block_ids] - chunk_start, E)
    first = (k == 0).astype(np.int32)

    # The chunk holding offset p of row r's block (the last chunk for p at
    # the block's end): min((p - block_start) // E, chunks - 1).
    rb = np.arange(m) // R

    def chunk_at(p):
        return chunk0[rb] + np.minimum((p - block_starts[rb]) // E,
                                       chunks_per_block[rb] - 1)

    lo_off, hi_off = indptr[:-1], indptr[1:]
    first_c = chunk_at(lo_off)
    last_c = chunk_at(np.maximum(hi_off - 1, lo_off))
    cs = np.arange(C)
    row_lo = np.searchsorted(last_c, cs, side="left")
    row_hi = np.searchsorted(first_c, cs, side="right") - 1

    cut = last_c > first_c
    cut_rows = np.flatnonzero(cut)
    n_parts = (last_c - first_c + 1)[cut]
    cut_ptr = np.concatenate([[0], np.cumsum(n_parts)])
    head_slot = np.full(C, -1, np.int64)
    tail_slot = np.full(C, -1, np.int64)
    tail_slot[first_c[cut]] = cut_ptr[:-1]
    # Cut row j continues into chunks first_c + 1 .. last_c, whose heads are
    # its slots cut_ptr[j] + 1 .. cut_ptr[j + 1] - 1.
    n_heads = n_parts - 1
    j = np.repeat(np.arange(cut_rows.shape[0]), n_heads)
    step = np.arange(j.shape[0]) - np.repeat(np.cumsum(n_heads) - n_heads,
                                             n_heads) + 1
    head_slot[first_c[cut_rows][j] + step] = cut_ptr[j] + step

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    return SpmmPlan(
        indptr=indptr_t, indices=indices_t, chunk_start=t(chunk_start),
        chunk_count=t(chunk_count), block_ids=t(block_ids), first=t(first), row_lo=t(row_lo),
        row_hi=t(row_hi), head_slot=t(head_slot), tail_slot=t(tail_slot),
        cut_rows=t(cut_rows), cut_ptr=t(cut_ptr), rows_per_block=R,
        chunk_nnz=E, shape=(m, n), nnz=nnz, num_blocks=num_blocks,
        num_slots=int(cut_ptr[-1]))
