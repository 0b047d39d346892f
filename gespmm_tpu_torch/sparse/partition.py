"""The per-row chunk plan and the grouped plan — port of
``gespmm_tpu/sparse/partition.py::build_spmm_plan`` and ``build_grouped_plan``.

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

The chunk kernel walks the plan's pieces: a piece is the part of one row
that lies in one chunk, i.e. chunk c's row r for every r in [row_lo[c],
row_hi[c]] (an empty row too, as a piece without edges).  In chunk order,
then row order, piece p holds the edges [piece_ptr[p], piece_ptr[p + 1])
(the pieces tile the edges, so ``piece_ptr`` is an indptr over them) of row
``piece_row[p]`` and writes its sum to that out row (``piece_slot[p]`` =
-1), or, for a cut row, to its carry slot: ``head_slot`` of its chunk when
the row began in an earlier chunk, else ``tail_slot``.

The grouped plan (``build_grouped_plan``, the work list of
``csrc/spmm_grouped.cu``) cuts each block greedily instead, into chunks of
at most E edges and at most NG distinct aligned groups of G B rows, and
adds each chunk's group ids and each edge's staged slot; its row lists and
carry slots come from the same helper, ``_row_lists``.  It also derives the
B rows each chunk's edges reference (``ref_ptr``, ``ref_rows``,
``ref_slot``): the grouped kernel stages only those, not whole groups.

The row split (``build_row_split``, the work list of ``csrc/spmm_csr.cu``)
cuts each CSR row longer than L edges into segments of L consecutive edges,
each walked by one warp; the carry pass adds a long row's segments in order.
The stacked split (``build_shard_split``, the work list of
``csrc/halo_spmm.cu``) applies the same rule to the rows of P stacked shard
blocks, each row's edges being its diag edges followed by its halo edges.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# The work list of the grouped kernel, in the order its entry point takes
# it, and the chunk kernel's: its pieces and the carry's cut rows.
WORK_LIST = ("chunk_start", "chunk_count", "row_lo", "row_hi", "head_slot",
             "tail_slot", "cut_rows", "cut_ptr")
PIECE_LIST = ("piece_ptr", "piece_row", "piece_slot", "cut_rows", "cut_ptr")


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
    # The chunk kernel's pieces (``build_spmm_plan`` only; the grouped
    # kernel walks the row lists).
    piece_ptr: Optional[Tensor] = dataclasses.field(default=None,
                                                    kw_only=True)
    piece_row: Optional[Tensor] = dataclasses.field(default=None,
                                                    kw_only=True)
    piece_slot: Optional[Tensor] = dataclasses.field(default=None,
                                                     kw_only=True)

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_start.shape[0])

    @property
    def num_pieces(self) -> int:
        return int(self.piece_row.shape[0])

    def to(self, device) -> "SpmmPlan":
        """The same plan with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), Tensor)})


def _int32(a) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _row_lists(indptr: np.ndarray, R: int, chunk0: np.ndarray,
               chunk_start: np.ndarray) -> Dict[str, np.ndarray]:
    """The rows each chunk walks and the carry slots of the rows cut by a
    chunk boundary (``row_lo``, ``row_hi``, ``head_slot``, ``tail_slot``,
    ``cut_rows``, ``cut_ptr``), for any cutting of each row block's edges
    into consecutive chunks: block b owns chunks [chunk0[b], chunk0[b +
    1]), at least one, and chunk c starts at CSR edge ``chunk_start[c]``."""
    m = indptr.shape[0] - 1
    C = chunk_start.shape[0]
    rb = np.arange(m) // R
    lo_c, hi_c = chunk0[rb], chunk0[rb + 1] - 1

    # The chunk holding offset p of row r's block: its last chunk starting
    # at or before p (the block's last chunk for p at the block's end).
    def chunk_at(p):
        return np.clip(np.searchsorted(chunk_start, p, side="right") - 1,
                       lo_c, hi_c)

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
    return dict(row_lo=row_lo, row_hi=row_hi, head_slot=head_slot,
                tail_slot=tail_slot, cut_rows=cut_rows, cut_ptr=cut_ptr)


def _pieces(indptr: np.ndarray, chunk_start: np.ndarray,
            lists: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The pieces (``piece_ptr``, ``piece_row``, ``piece_slot``) of chunks
    that tile the edges, chunk by chunk: chunk c's rows row_lo[c] ..
    row_hi[c] of ``lists`` (``_row_lists``), each clipped to the chunk's
    edges.  Consecutive pieces meet (a chunk's rows are consecutive and hold
    all its edges; chunk c ends where c + 1 begins), so their starts and nnz
    form an indptr."""
    row_lo, row_hi = lists["row_lo"], lists["row_hi"]
    n_pieces = row_hi - row_lo + 1
    piece_chunk = np.repeat(np.arange(chunk_start.shape[0]), n_pieces)
    piece_row = row_lo[piece_chunk] + (
        np.arange(piece_chunk.shape[0])
        - np.repeat(np.cumsum(n_pieces) - n_pieces, n_pieces))
    nnz = indptr[-1]
    chunk_end = np.append(chunk_start[1:], nnz)
    start = np.clip(indptr[piece_row], chunk_start[piece_chunk],
                    chunk_end[piece_chunk])
    end = np.clip(indptr[piece_row + 1], chunk_start[piece_chunk],
                  chunk_end[piece_chunk])
    # A cut row's piece writes its chunk's head slot when the row began in
    # an earlier chunk, else its tail slot; any other piece writes out.
    piece_slot = np.where(start > indptr[piece_row],
                          lists["head_slot"][piece_chunk],
                          np.where(end < indptr[piece_row + 1],
                                   lists["tail_slot"][piece_chunk], -1))
    return dict(piece_ptr=np.append(start, nnz), piece_row=piece_row,
                piece_slot=piece_slot)


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

    row_lists = _row_lists(indptr, R, chunk0, chunk_start)
    row_lists.update(_pieces(indptr, chunk_start, row_lists))

    return SpmmPlan(
        indptr=indptr_t, indices=indices_t, chunk_start=_int32(chunk_start),
        chunk_count=_int32(chunk_count), block_ids=_int32(block_ids),
        first=_int32(first),
        **{k: _int32(v) for k, v in row_lists.items()}, rows_per_block=R,
        chunk_nnz=E, shape=(m, n), nnz=nnz, num_blocks=num_blocks,
        num_slots=int(row_lists["cut_ptr"][-1]))


@dataclasses.dataclass(frozen=True)
class GroupedSpmmPlan(SpmmPlan):
    """The grouped work list of one sparsity structure: the chunk plan's
    fields (``chunk_nnz`` is E, the JAX builder's ``edges_per_chunk``), and
    each chunk's groups and each edge's staged slot (int32 tensors).

    Chunk c holds the CSR edges [chunk_start[c], chunk_start[c] +
    chunk_count[c]) of block ``block_ids[c]`` and stages the
    ``group_count[c]`` aligned groups ``groups[c, :group_count[c]]`` (group
    g is the B rows [g·G, g·G + G)); edge e reads its B row from staged row
    ``slots[e]`` = pos(group)·G + col % G of its chunk.  ``groups_per_chunk``
    is the widest chunk's group count (NG shrunk, as in the JAX package),
    and ``staged_rows`` the B rows whole groups hold, G per group (what the
    JAX kernel stages).

    The rows the kernel stages are those the chunk's edges reference:
    chunk c's are ``ref_rows[ref_ptr[c]:ref_ptr[c + 1]]``, its distinct
    slots in slot order, and edge e reads entry ``ref_slot[e]`` of its
    chunk's list.  ``referenced_rows`` is their total, ``max_refs`` the
    most one chunk has.
    """

    groups: Tensor
    group_count: Tensor
    slots: Tensor
    ref_ptr: Tensor
    ref_rows: Tensor
    ref_slot: Tensor
    groups_per_chunk: int
    group_rows: int
    staged_rows: int
    referenced_rows: int
    max_refs: int

    @property
    def edges_per_chunk(self) -> int:
        return self.chunk_nnz

    @property
    def dedup_factor(self) -> float:
        """Edges served per group slot of the (C, NG) layout (padding
        included), as the JAX package defines it."""
        return self.nnz / max(self.num_chunks * self.groups_per_chunk, 1)


def build_grouped_plan(csr, rows_per_block: int = 64, edges_per_chunk: int = 64,
                       groups_per_chunk: int = 32,
                       group_rows: int = 8) -> GroupedSpmmPlan:
    """Build the grouped plan of one CSR structure on the host — the JAX
    package's greedy cutting: each row block of R rows is cut, in CSR
    order, into chunks of at most E edges and at most NG distinct groups
    ``col // G``; a block without edges is one chunk of none.  The JAX
    defaults (R, E, NG, G) = (64, 64, 32, 8).  The plan's tensors are on the
    CPU; ``GroupedSpmmPlan.to`` moves them.  Raises ValueError on sizes it
    does not take.
    """
    if rows_per_block < 8 or rows_per_block % 8:
        raise ValueError(f"rows_per_block must be a positive multiple of 8, "
                         f"got {rows_per_block}")
    if min(edges_per_chunk, groups_per_chunk, group_rows) < 1:
        raise ValueError(f"edges_per_chunk, groups_per_chunk and group_rows "
                         f"must be at least 1, got {edges_per_chunk}, "
                         f"{groups_per_chunk}, {group_rows}")
    indptr_t = torch.as_tensor(csr.indptr).cpu().to(torch.int32)
    indices_t = torch.as_tensor(csr.indices).cpu().to(torch.int32)
    indptr = indptr_t.numpy().astype(np.int64)
    m, n = csr.shape
    nnz = int(indptr[-1])
    R, E, NG, G = rows_per_block, edges_per_chunk, groups_per_chunk, group_rows

    num_blocks = max((m + R - 1) // R, 1)
    bounds = indptr[np.minimum(np.arange(num_blocks + 1) * R, m)].tolist()
    cols = indices_t.tolist()
    slots = [0] * nnz
    starts, groups, chunk0 = [], [], [0]
    for b in range(num_blocks):
        pos, end = bounds[b], bounds[b + 1]
        while True:  # one chunk a pass; at least one a block
            start, gmap = pos, {}
            stop = min(end, pos + E)
            while pos < stop:
                col = cols[pos]
                gid = col // G
                k = gmap.get(gid)
                if k is None:
                    if len(gmap) == NG:
                        break
                    k = gmap[gid] = len(gmap)
                slots[pos] = k * G + col - gid * G
                pos += 1
            starts.append(start)
            groups.append(list(gmap))
            if pos >= end:
                break
        chunk0.append(len(starts))

    C = len(starts)
    chunk0 = np.asarray(chunk0, np.int64)
    chunk_start = np.asarray(starts, np.int64)
    # Chunks tile [0, nnz) in order, so each ends where the next begins.
    chunk_count = np.diff(np.append(chunk_start, nnz))
    block_ids = np.repeat(np.arange(num_blocks), np.diff(chunk0))
    first = np.zeros(C, np.int64)
    first[chunk0[:-1]] = 1
    group_count = np.asarray([len(gl) for gl in groups], np.int64)
    # NG shrinks to the widest chunk, as in the JAX package.
    NG = max(int(group_count.max()), 1)
    group_arr = np.zeros((C, NG), np.int64)
    for c, gl in enumerate(groups):
        group_arr[c, :len(gl)] = gl
    row_lists = _row_lists(indptr, R, chunk0, chunk_start)
    refs = _referenced_rows(group_arr, chunk_count, np.asarray(slots, np.int64),
                            G)

    return GroupedSpmmPlan(
        indptr=indptr_t, indices=indices_t, chunk_start=_int32(chunk_start),
        chunk_count=_int32(chunk_count), block_ids=_int32(block_ids),
        first=_int32(first),
        **{k: _int32(v) for k, v in row_lists.items()},
        groups=_int32(group_arr), group_count=_int32(group_count),
        slots=_int32(slots), **{k: _int32(v) for k, v in refs.items()},
        rows_per_block=R, chunk_nnz=E, groups_per_chunk=NG, group_rows=G,
        shape=(m, n), nnz=nnz, num_blocks=num_blocks,
        num_slots=int(row_lists["cut_ptr"][-1]),
        staged_rows=int(group_count.sum()) * G,
        referenced_rows=int(refs["ref_ptr"][-1]),
        max_refs=int(np.diff(refs["ref_ptr"]).max(initial=0)))


def _referenced_rows(groups: np.ndarray, chunk_count: np.ndarray,
                     slots: np.ndarray, G: int) -> Dict[str, np.ndarray]:
    """The B rows each chunk's edges reference (``ref_ptr``, ``ref_rows``,
    ``ref_slot``): chunk c's distinct slots in slot order, each as the B
    row it stages (group·G + slot % G), and each edge's index in its
    chunk's list."""
    C, NG = groups.shape
    chunk = np.repeat(np.arange(C), chunk_count)
    key = chunk * (NG * G) + slots
    uniq, inverse = np.unique(key, return_inverse=True)
    u_chunk, u_slot = uniq // (NG * G), uniq % (NG * G)
    ref_rows = groups[u_chunk, u_slot // G] * G + u_slot % G
    ref_ptr = np.searchsorted(u_chunk, np.arange(C + 1), side="left")
    ref_slot = inverse.reshape(-1) - ref_ptr[chunk]
    return dict(ref_ptr=ref_ptr, ref_rows=ref_rows, ref_slot=ref_slot)


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The long rows of one CSR structure cut into segments (int32 tensors).

    A row of more than ``seg_len`` (L) edges is cut into ceil(deg / L)
    segments of L consecutive edges (the last one shorter): segment s
    covers edges [seg_start[s], min(seg_start[s] + L, indptr[seg_row[s] +
    1])).  Long row j is ``long_rows[j]`` and its segments are
    [seg_ptr[j], seg_ptr[j + 1]), in edge order; ``long_rows`` and
    ``seg_ptr`` are the carry pass's ``cut_rows`` and ``cut_ptr``, with one
    slot a segment.  A structure with no row longer than L has no segment.
    """

    seg_row: Tensor
    seg_start: Tensor
    long_rows: Tensor
    seg_ptr: Tensor
    seg_len: int

    @property
    def num_segments(self) -> int:
        return int(self.seg_row.shape[0])

    @property
    def num_long_rows(self) -> int:
        return int(self.long_rows.shape[0])

    def to(self, device) -> "RowSplit":
        """The same split with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), Tensor)})


# The segment length of the CSR kernel's split: the card's sweep of L in
# {32, 64, 128, 256} at rmat15 K=128 (PERF.md, PR 7).
SPLIT_LEN = 64


def build_row_split(indptr, seg_len: int = SPLIT_LEN) -> RowSplit:
    """Cut every row of ``indptr`` longer than ``seg_len`` edges into
    segments of ``seg_len`` (host NumPy; the tensors are on the CPU,
    ``RowSplit.to`` moves them).  Raises ValueError for seg_len < 1."""
    if seg_len < 1:
        raise ValueError(f"seg_len must be at least 1, got {seg_len}")
    indptr = np.asarray(torch.as_tensor(indptr).cpu(), dtype=np.int64)
    deg = np.diff(indptr)
    long_rows = np.flatnonzero(deg > seg_len)
    n_seg = (deg[long_rows] + seg_len - 1) // seg_len
    seg_ptr = np.concatenate([[0], np.cumsum(n_seg)]).astype(np.int64)
    seg_row = np.repeat(long_rows, n_seg)
    k = np.arange(seg_row.shape[0]) - np.repeat(seg_ptr[:-1], n_seg)
    seg_start = indptr[seg_row] + k * seg_len
    return RowSplit(seg_row=_int32(seg_row), seg_start=_int32(seg_start),
                    long_rows=_int32(long_rows), seg_ptr=_int32(seg_ptr),
                    seg_len=seg_len)


@dataclasses.dataclass(frozen=True)
class ShardSplit:
    """The row split of P stacked shard blocks (one kernel row-7 launch).

    Shard p's row r is stacked row q = p * ``rows`` + r.  Its joint edge
    list is its diag edges, then its halo edges (one block only for a
    transposed block): joint position j < deg_diag is diag edge
    ``d_indptr[p, r] + j``, any other halo edge ``h_indptr[p, r] + j -
    deg_diag``.  ``split`` is ``build_row_split``'s rule over the joint
    degrees of all stacked rows, with ``seg_row``/``long_rows`` stacked rows
    and ``seg_start`` the segment's first joint position IN ITS ROW.
    Shard p's segments are [seg_off[p], seg_off[p + 1]) and its long rows
    [long_off[p], long_off[p + 1]) (host ints), so a launch over shards
    [lo, hi) takes one slice of each (``local``).
    """

    split: RowSplit
    rows: int
    seg_off: Tuple[int, ...]
    long_off: Tuple[int, ...]

    @property
    def num_parts(self) -> int:
        return len(self.seg_off) - 1

    def local(self, lo: int, hi: int) -> Tuple[RowSplit, int, int]:
        """(split of shards [lo, hi), row0, slot0): views of the lists; the
        stacked rows and carry slots they hold start at row0 and slot0."""
        s0, s1 = self.seg_off[lo], self.seg_off[hi]
        j0, j1 = self.long_off[lo], self.long_off[hi]
        rs = self.split
        return (dataclasses.replace(
            rs, seg_row=rs.seg_row[s0:s1], seg_start=rs.seg_start[s0:s1],
            long_rows=rs.long_rows[j0:j1], seg_ptr=rs.seg_ptr[j0:j1 + 1]),
            lo * self.rows, s0)

    def to(self, device) -> "ShardSplit":
        return dataclasses.replace(self, split=self.split.to(device))


def local_split(split: Optional[ShardSplit], first: int, n: int,
                rows: int) -> Tuple[Optional[RowSplit], int, int]:
    """(the split lists of shards [first, first + n), row0, slot0) of a
    launch over n stacked blocks of ``rows`` rows each, or (None, 0, 0)
    without a split.  Raises ValueError if the split covers other blocks."""
    if split is None:
        return None, 0, 0
    if split.rows != rows or not 0 <= first <= first + n <= split.num_parts:
        raise ValueError(f"the split covers {split.num_parts} shards of "
                         f"{split.rows} rows, not shards [{first}, "
                         f"{first + n}) of {rows}")
    return split.local(first, first + n)


def build_shard_split(d_indptr, h_indptr=None,
                      seg_len: int = SPLIT_LEN) -> ShardSplit:
    """The stacked split of (P, rows + 1) indptrs (host NumPy; the tensors
    are on the CPU).  ``h_indptr=None``: one block (a transposed block)."""
    d_indptr = np.asarray(d_indptr, dtype=np.int64)
    deg = np.diff(d_indptr, axis=1)
    if h_indptr is not None:
        deg = deg + np.diff(np.asarray(h_indptr, dtype=np.int64), axis=1)
    P, rows = deg.shape
    joint = np.concatenate([[0], np.cumsum(deg.reshape(-1))])
    split = build_row_split(joint, seg_len)
    seg_row = split.seg_row.numpy()
    starts = split.seg_start.numpy().astype(np.int64) - joint[seg_row]
    bounds = np.arange(P + 1) * rows
    return ShardSplit(
        split=dataclasses.replace(split, seg_start=_int32(starts)), rows=rows,
        seg_off=tuple(int(x) for x in np.searchsorted(seg_row, bounds)),
        long_off=tuple(int(x) for x in np.searchsorted(
            split.long_rows.numpy(), bounds)))
