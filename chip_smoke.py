#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gespmm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--record PATH]

Phases, each printed as it goes; any failure exits non-zero:
  1. device: torch.cuda, and the card's name and power limit from nvidia-smi;
  2. build: nvcc builds the eight libraries of csrc/ (spmm_csr.cu,
     spmm_minmax.cu, edge_reduce.cu, gat_fused.cu, dot_attention.cu,
     spmm_chunk.cu, spmm_grouped.cu, halo_spmm.cu) from this checkout, all
     at once (timed);
  3. sum kernel vs plain: the CSR SpMM kernel, with its long rows split
     over warps (the adjacency's split, L = 64), against its plain PyTorch
     version in float64, |out - ref| <= 1e-5 (|A| @ |B|) + 1e-6 (bf16:
     8e-3 (|A| @ |B|)), two calls bitwise equal, at the GCN slice's shapes
     (pubmed-scale SBM graph with self-loops, K=32 and K=3, over the CSR and
     the CSC; no row longer than L, so no carry launch) and on rmat15 (hub
     rows, empty rows) at K in {1, 3, 32, 33, 128, 130, 512}, valued and
     binary, f32 and bf16, over the CSC at K=128, bf16 B with an f32 out
     (mode="fast"'s entry) at K in {32, 128}; and on a graph with rows of
     L - 1, L, L + 1, 2L, 2L + 1 and 10,000 edges at K in {32, 128, 130}, f32,
     bf16 and bf16 in / f32 out;
  4. max/min kernels vs plain: on the SBM graph without self-loops (the
     SAGE slice's graph) at K in {128, 16} and on rmat15 at K in {1, 3, 32,
     33, 128, 130}, binary and valued in f32, binary in bf16, and on the
     split-boundary graph (columns of L - 1, L, L + 1, 2L + 1 and 10,000
     edges) at K in {1, 3, 16, 32, 33, 64, 128, 130}, binary and valued, f32
     and bf16, with B in multiples of 0.5 so that ties are common.  The
     forward (row 2, given the CSR's split: rows above L walked in segments
     whose (extremum, count) pairs the pair carry folds) runs twice,
     bitwise equal; its out and ties equal the unsplit plain version's
     exactly, and an f32 out equals the float64 reference rounded to f32;
     its carry runs once a call on rmat15 and the boundary graph and never
     on the SBM graph.  The backward (row 3,
     given g in out's dtype and the CSC's split) runs twice, bitwise equal;
     its grad_B and grad_values are within 1e-5 (bf16: 8e-3) x max |ref| of
     the float64 plain version; its carry runs once a call on rmat15 and the
     boundary graph and never on the SBM graph;
  5. autograd on the card: sum-SpMM grad_B and grad_values against float64;
  6. GCN train: dims [128, 32, 3] on the SBM graph with self-loops, 50 epochs
     through the sum kernel (>= 4 launches per epoch), loss falling, train
     accuracy above chance, logits agreeing with a float64 CPU forward; then
     the same run with method="xla" (the plain version, no launches);
  7. SAGE-pool train: dims [128, 16, 3] on the SBM graph without
     self-loops, 50 epochs through the max/min forward and backward kernels
     (>= 2 forward launches per epoch, exactly 2 of row 3, no carry of
     either),
     with the same checks; then method="xla" with no launches;
  8. attention kernels vs plain: the edge segment reduce (sum, max, with
     the adjacency's split: rows above L walked in segments and their carry
     launched once a call on rmat15 and the boundary graph, never on sbm;
     two calls bitwise equal) and the
     three fused GAT kernels (forward; backward over the CSR and over the
     CSC, each with the adjacency's split and its carries) against their
     plain versions in float64, on the SBM graph with self-loops (K=H in
     {1, 8} for the reduce, {1, 3, 8} on rmat15 and the boundary graph;
     heads 1 and 8 at K=64 and K=3/24), on rmat15
     (hub and empty rows) and on a graph whose rows and columns have L - 1,
     L, L + 1, 2L + 1 and 10,000 edges (utils/datasets.py::
     split_boundary_graph), exact and bound, f32 and bf16.  Forward within
     1e-5 x max |ref| + 1e-6 (bf16 out: 8e-3 x), a max exactly; gradients
     within 1e-4 x max(|ref|, 1) (bf16 grad_B: 8e-3 x); the fused kernels'
     two runs bitwise equal, their carries launched on rmat15 and the
     boundary graph (1 forward, 1 CSR-backward, 2 CSC-backward a run) and
     never on the SBM graph;
  9. composed attention chain on the card at layer 0's shapes (K=64):
     additive logits, leaky ReLU, edge_softmax, spmm(with_data(alpha)),
     forward and backward: 5 segment-reduce launches and no carry, and the
     result and its gradients held to the fused op and to float64;
 10. GAT train: dims [128, 64, 3], one head, on the SBM graph with
     self-loops, 50 epochs through the fused kernels (2 forward, 2
     CSR-backward and 2 CSC-backward launches an epoch, 2 more forward for
     the final evaluation, no carry) with the same checks as phase 6;
     method="xla" with no launches; then DGL's multi-head shape, dims
     [128, 8, 3] with 8 heads, 20 epochs, with the same launch counts;
 11. dot-product attention kernels vs float64: forward, backward over the
     CSR and over the CSC, each with the adjacency's split, on the SBM graph
     with self-loops at (Ka, K) in {(64, 64), (16, 3)}, on rmat15 at (64,
     64) and on the split-boundary graph at (64, 64), (16, 3) and (64, 130)
     (a K past one slab), act identity and leaky,
     B in f32 and bf16, D1 and D2 drawn with std Ka^-1/4 (unit-variance
     logits).  Forward within 1e-5 x max |ref| + 1e-6 (bf16 out: 8e-3 x);
     gradients within 1e-4 x max(|ref|, 1) (bf16 grad_B: 8e-3 x); two runs
     of each kernel bitwise equal; carries 1, 1 and 2 a run on rmat15 and
     the boundary graph, none on sbm;
 12. attention_aggregate on the card at (64, 64): the fused op (auto),
     forward and backward, held to the composed chain on the card (sddmm,
     edge_softmax on the segment-reduce kernel, spmm with_data on the sum
     kernel) and to float64; exactly 1 launch of each dot kernel and no
     carry, and method="xla" none;
 13. nnz-chunked SpMM vs float64: on the SBM graph and rmat15 at K in {1, 3,
     16, 32, 33, 64, 128, 130, 512} (every walker width of the chunk
     kernel's walk over the plan's pieces), valued and binary, f32 and bf16,
     (R, E) in
     {(64, 64), (128, 256)}, within the sum kernel's bound and bitwise
     repeatable; spmm(method="pallas") out, grad_B and grad_values against
     float64 (one chunk launch forward, one for grad_B), and, on an
     adjacency without the transposed plan, one chunk launch forward and
     one CSR-kernel launch for grad_B;
 14. the sweep, called as functions: bench_graph("rmat15", [32, 128]) over
     the tiers xla, tiled, tiled-hilo, tiled-fast, pallas, scatter, dense,
     bcoo, and bench_sddmm_graph("rmat15", [64]), every cell validated
     against float64 (tiled-fast against the float64 product of the
     bf16-rounded B) and timed with device time (synth_graph's rmat15 has
     edge factor 16, unlike the edge factor 8 of the kernel phases); no cell
     may fail but a printed dense guard; the JSON rows are printed;
 16. grouped-gather SpMM vs float64: on the SBM graph with self-loops and
     rmat15, each as generated and RCM-reordered, at K in {1, 3, 32, 33,
     128, 130, 512}, valued and binary, f32 and bf16, with the grouped
     plans (R, E, NG, G) = (64, 64, 32, 8) (the JAX defaults) and (8, 16,
     8, 8), within the sum kernel's bound and bitwise repeatable; each
     plan's chunks, groups, B rows whole groups hold and B rows the kernel
     stages (the rows the edges reference) per edge are printed; then
     spmm(method="pallas") and method="auto" on a grouped adjacency: out,
     grad_B and grad_values against float64; "pallas" one grouped launch
     forward and one for grad_B, none of the CSR kernel; "auto" (the rule
     measured in phase 15) two CSR-kernel launches and no grouped one;
     "pallas" without the transposed plan, one grouped and one CSR-kernel
     launch; the auto rule: 2 CSR-kernel launches (forward, grad_B) and no
     other kernel on rmat15 (with 2 carry launches) at K=128 and K=32 and on
     the SBM graph at K=128;
 17. GCN train through the grouped kernel: dims [128, 32, 3] on the
     RCM-reordered SBM graph with self-loops (features, labels and masks
     permuted alongside), plan="grouped", method="pallas", 50 epochs (>= 4
     grouped launches per epoch, no CSR-kernel launch), with the checks of
     phase 6; the
     trained parameters on the original order (phase 6's route) give the
     same logits after un-permuting, within 1e-4 x max |ref|;
 18. the joint diag+halo SpMM (kernel row 7) vs float64: one launch over
     all P shards of the halo partitions (parallel/halo.py) of the SBM
     graph with and without self-loops and of rmat15 at P in {2, 4, 8}, K
     in {1, 3, 16, 32, 33, 128, 130}, with the partition's split at L = 64
     (rmat15's hub rows cut into segments, many across the diag/halo
     boundary; each partition's segment counts printed), and of the SBM
     graph split at L = 4 (most rows cut, most segments across the
     boundary) at K in {3, 32, 130}; sum/max/min, binary and valued,
     per-head sums at H in {2, 8} (where H divides K), f32 and bf16 tables,
     B in multiples of 0.5: each shard's sum within the sum kernel's bound,
     max/min out and joint ties equal to the unsplit plain version's, two
     launches bitwise equal; the sum backward (row 7 over the stacked
     transposed blocks with their splits) and row 3's backward (one launch
     over the same stacked transposes with their splits and the joint out
     and ties, twice, bitwise equal) within 1e-5 (bf16 8e-3) x max |ref| of
     float64;
 19. halo_spmm on the card, P=4 shards in one process, on the SBM graph with
     self-loops at K=32, each reduce with runtime edge values (multiples of
     1/4): out, grad_B and grad_vals against the float64 whole-graph spmm;
     launches: forward 1 row-7 launch over the 4 shards, sum/mean backward
     2 (the stacked diag^T and halo^T blocks), max/min backward 2 row-3
     launches (the same stacked blocks), no carry (no row above L),
     method="xla" none;
     dist_spmm (the all-gather tier) through the CSR kernel; then one
     make_mesh over a world-size-1 NCCL group: one shard has no round, so
     the exchange sends nothing, and the result equals the one-process
     mesh's;
 20. sharded training over P=4 shards (parallel/train_step.py): GCN [128,
     32, 3] on the SBM graph with self-loops, 50 epochs through row 7 (6
     launches an epoch: one an aggregation, two for its backward; no carry,
     no other kernel), loss falling, train accuracy above
     chance, logits within 1e-4 x max |ref| of a float64 CPU forward;
     SAGE-pool [128, 16, 3] (no self-loops; its max backward exactly 4 row-3
     launches an epoch, no carry) and GAT [128, 8, 3] with 2 heads, 20 epochs
     each, with the same checks but the float64 one; then
     dryrun_multichip(8) (a (data, model) = (4, 2) mesh, as in the JAX
     package);
 21. interop on the card: ops/interop.py::AdjacencyMatrix over the SBM
     graph with self-loops at K=32: A @ x, x @ A (through __rmatmul__),
     A.T @ x and A @ v (1-D), each within the sum kernel's float64 bound,
     and the gradients of A.with_data(d) @ x to x and to the values within
     1e-5 x max(|ref|, 1) of float64; exactly 6 launches of the CSR kernel
     (row 1), no other kernel and no call of torch.sparse.mm; and
     csr_from_torch_sparse(csr_to_torch_sparse(csr)) equal to the CSR;
 22. the stock baselines (models/baselines.py) at full width: GCNBcoo
     [128, 32, 3] and GATStock [128, 64, 3] (one head) on the SBM graph with
     self-loops, SAGEStock mean and pool [128, 16, 3] without; each, at the
     ported model's parameters with dropout off, gives logits within
     1e-5 x max |ref| + 1e-6 of ours on the card; then 20-epoch runs in the
     order ours, stock, stock, ours: loss falling, train accuracy above
     chance, no kernel of the port launched by a stock run, ms/epoch and
     peak memory of both printed, the stock GAT's peak below a quarter of
     a dense n x n f32 matrix (its gradient to alpha stays sparse);
 23. SAGE-LSTM [128, 16, 3] (models/sage_lstm.py, max_neighbors 32) on the
     SBM graph without self-loops, 20 epochs: loss falling, accuracy above
     chance, logits within 1e-4 x max |ref| of the same module's float64
     forward on the CPU, ms/epoch printed;
 24. GAT [128, 64, 3] with method="pallas" over a plan="perrow" adjacency,
     20 epochs: the composed chain, 10 edge segment-reduce (row 4) and 4
     chunk (row 8) launches an epoch and 4 and 2 for the final evaluation,
     no row-4 carry, no fused-attention or CSR-kernel launch; loss falling,
     logits within 1e-4 x max |ref| of float64;
 25. checkpoint: the GCN (method="auto") 10 epochs straight against 5
     epochs, a checkpoint (train/checkpoint.py), a fresh model restored
     from it and 5 more: final parameters within 1e-6 x max |ref|, and
     whether they are bitwise equal printed;
 26. native graph IO (utils/native.py): the library g++ builds from
     native/graphio.cpp lies under gespmm_tpu_torch/_build/; an .mtx of
     rmat15 reads back equal through the native and the NumPy reader, and
     Adjacency.from_csr's CSC arrays are equal both ways; Fennel at rmat17
     (edge factor 16) P=4, native and NumPy loop, and partition_order's
     balancing pass, each with its host seconds;
 27. partition and weak scaling (bench/dist_bench.py): bench_weak_scaling
     at P in {1, 2, 4} on rmat(15 + log2 P) (edge factor 16, K=64) with
     halo-tiled and partition "auto" (row 7 launched, no row 1), then with
     allgather (row 1 launched, no row 7), every row printed; the P=4 graph
     is rmat17 (131,072 nodes, 3,728,080 nonzeros); on it, "auto"'s padded
     footprint no larger than the naive split's, and halo_spmm of the
     partitioned graph (one row-7 launch over the 4 shards) and the
     allgather path's dist_spmm of the naive split (one row-1 launch a
     (32,768, 131,072) slab) each within 1e-5 (|A| @ |B|) + 1e-6 of
     float64;
 28. the model axis in one process: halo_spmm on (data, model) = (2, 2)
     against (2, 1), forward and backward within 1e-5 x max |ref| (3 row-7
     launches against 6); the sharded GCN [128, 32, 3] on (2, 1), (2, 2),
     (2, 2), (2, 1) for 20 epochs each: loss falling, row-7 launches an
     epoch 6 and 9, ms/epoch printed (nothing claimed), and the (2, 2)
     logits within 1e-5 x max |ref| of the (2, 1) module's from the same
     parameters; then dryrun_multichip(4) ((2, 2));
 29. profiling (utils/profiling.py): trace of one (2, 2) GCN step writes
     its file, and the count of device events in it is printed (0 is
     printed, not hidden); op_cost_table of the GCN's first dense layer
     counts 2 m 128 32 flops;
 15. timings, run last: the card's copy bandwidth (utils/profiling.py::
     measure_hbm_bandwidth) beside the published 3.35 TB/s; device time of
     every kernel against its plain version at the
     slice's shapes and at rmat15, with its bound (the larger of its bytes
     over 3.35 TB/s and its operations over 67 TFLOP/s) and the one PyTorch
     call that computes the same function where there is one (library_ms);
     rows 2 and 3 at sbm K=128, sbm K=16 and rmat15 K=128, row 2 called
     with the CSR's split, row 3 with g and ties and the CSC's split, each
     with its bound, error and carries, and row 1 over the same edges at
     the same K beside them;
     the CSR kernel at rmat15 (edge factors 8 and 16) K=128 and sbm K=32,
     f32 and with bf16 B / f32 out (mode="fast"), against torch.sparse.mm,
     and its split at L in {32, 64, 128, 256} at both rmat15 K=128 (each L
     timed twice, in the order 32 ... 256 ... 32);
     the edge segment reduce (row 4, with the split) at sbm and rmat15 K=1
     sum and max and K=8 sum, with its carries and torch.segment_reduce
     (the same op) beside each;
     the three fused GAT kernels at sbm H=1 dh=64, H=1 dh=3, H=8 dh=8,
     H=8 dh=3 and rmat15 H=1 dh=64, H=8 dh=3 against their plain versions,
     with their bounds and row 1 over the same graph at the same K (a
     yardstick of one gather pass, not the same function);
     the three dot-attention kernels (row 6, with the splits) at sbm and
     rmat15 Ka=K=64, with their carries, and scaled_dot_product_attention
     with the adjacency as a dense mask beside the forward (held to the
     kernel on the rows with an edge);
     the chunk kernel against float64, the CSR kernel and torch.sparse.mm
     at each timed shape (the kernels line's error is its shape's); the
     grouped kernel likewise, and against the chunk kernel at (64, 64) on
     the same ordering, on rmat15 (edge factor 16) as generated and
     RCM-reordered at (64, 64, 32, 8) and (64, 64, 64, 1) and on the
     RCM-reordered SBM graph at K=32, then at 1, 2 and 4 producer warps and
     the widest K tile 32 ... 256 (the launch shape chosen); row 7, one
     launch over P=4 shards with the split at L = 64 and 128, at the SBM
     graph K=32 (sum) and rmat15 K=128 (sum, max with ties, and the sum
     backward over both transposes), and at rmat17 in the "auto" order
     K=64 (dist_bench's P=4 shape, sum, L = 64), against the first port's
     launch pattern (one launch a shard, no split), its plain version, the
     whole-graph kernel (row 1, row 2 for the max), torch.sparse.mm of each
     shard's [A_diag | A_halo] (its transpose for the backward) and its
     bound, and each shard's launch alone, unsplit and split, beside its
     longest row; call times of the sum
     kernel; GCN, SAGE-pool and GAT ms/epoch for both methods (two runs
     each, in the order auto, xla, xla, auto); the GCN on the grouped route
     against phase 6's CSR route (csr, grouped, grouped, csr); and the
     sharded GCN against phase 6's single-device run (single, sharded,
     sharded, single), and a train step's device time for both over their
     ms/epoch (the device's busy share); then the port's headline line
     (bench/headline.py: spmm GFLOP/s at K=128 and vs_baseline against
     torch.sparse.mm, on a line of its own).

Phases run in the order 1-14, 16-29, 15.  Each path's launches are counted
from 0 in its own run; the comparison launches of phases 3-5, 8, 11, 13, 16
and 18 are not counted.  The CSR kernel and the chunk and grouped kernels
count their carry pass apart (spmm_csr_carry, spmm_chunk_carry,
spmm_grouped_carry), and so do row 7 (halo_spmm_carry), row 5
(gat_fwd_carry, gat_bwd_rows_carry, gat_bwd_cols_carry), row 2
(spmm_minmax_carry), row 3 (spmm_minmax_vjp_carry), row 4
(edge_segment_reduce_carry) and row 6 (dot_fwd_carry, dot_bwd_rows_carry,
dot_bwd_cols_carry).  In the kernels line rows 4 and 8 also give the GAT
pallas route's launches (phase 24: gat_pallas_launches), row 1 the
allgather weak-scaling run's and row 7 the halo-tiled one's (phase 27:
dist_bench_launches), and row 7 the (2, 2) GCN's (phase 28:
model_axis_launches).  NCCL traffic
between ranks is not run: the card machine has one card.  Output: one line
per phase (the headline's JSON line among them), then
a {"kernels": [...]} JSON line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  With --record, the full record of the run is
also written to PATH as JSON.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
EPOCHS = 50
GCN_DIMS = [128, 32, 3]
SAGE_DIMS = [128, 16, 3]
GAT_DIMS = [128, 64, 3]
GAT_MH_DIMS, GAT_MH_HEADS, GAT_MH_EPOCHS = [128, 8, 3], 8, 20
GAT_LR = 5e-3  # the JAX GAT bench's; weight decay 5e-4 as for the others
SBM_PUBMED = dict(n_per_class=6573, num_classes=3, p_in=0.0006, p_out=0.00002,
                  feat_dim=128, seed=SEED)
LIBS = ("spmm_csr", "spmm_minmax", "edge_reduce", "gat_fused", "dot_attention",
        "spmm_chunk", "spmm_grouped", "halo_spmm")
RMAT_KS = (1, 3, 32, 33, 128, 130, 512)
MINMAX_RMAT_KS = (1, 3, 32, 33, 128, 130)
MINMAX_SBM_KS = (128, 16)
# Row 3's walker widths (4-lane walkers at K = 1, 3, 16; 8 at 32; 16 at 64)
# and its K slabs (33, 130) on the split-boundary graph.
MINMAX_BOUNDARY_KS = (1, 3, 16, 32, 33, 64, 128, 130)
# (heads, head width) of the fused kernel checks: layer 0 (K=64) and layer 1
# (K=3) of the slice, and DGL's 8-head shape at both layers.
GAT_SBM_SHAPES = ((1, 64), (1, 3), (8, 8), (8, 3))
GAT_RMAT_SHAPES = ((1, 64), (8, 3))
# ... on the split-boundary graph: both walker kinds, and a head of 65
# columns over 64-column slabs.
GAT_BOUNDARY_SHAPES = ((1, 64), (1, 3), (8, 3), (2, 65))
# (graph, heads, head width) of row 5's timings: layer 0 and 1 of the
# slice, DGL's 8-head layers, and both heads on the hub-heavy graph.
GAT_TIMED = (("sbm", 1, 64), ("sbm", 1, 3), ("sbm", 8, 8), ("sbm", 8, 3),
             ("rmat15", 1, 64), ("rmat15", 8, 3))
SLOPE = 0.2
# (Ka, K) of the dot-attention checks: the (64, 64) main shape, and a narrow
# K with Ka a multiple of 4 below a lane's vector.
DOT_SBM_SHAPES = ((64, 64), (16, 3))
# ... on the split-boundary graph: both, and a K past one 64-column slab.
DOT_BOUNDARY_SHAPES = ((64, 64), (16, 3), (64, 130))
# Every walker of the chunk kernel: 4 lanes at K = 1, 3, 16; 8 at 32; 16 at
# 64; a warp at 33 and 128 and over K slabs at 130 and 512.
CHUNK_KS = (1, 3, 16, 32, 33, 64, 128, 130, 512)
CHUNK_SIZES = ((64, 64), (128, 256))  # the sweep's (R, E) and the builder's
SWEEP_METHODS = ("xla", "tiled", "tiled-hilo", "tiled-fast", "pallas",
                 "scatter", "dense", "bcoo")
SPLIT_SWEEP = (32, 64, 128, 256)  # the CSR kernel's segment lengths timed
GROUPED_KS = (1, 3, 32, 33, 128, 130, 512)
# (R, E, NG, G) of the grouped plan: the JAX defaults and the JAX tests'.
GROUPED_SIZES = ((64, 64, 32, 8), (8, 16, 8, 8))
HALO_PARTS = (2, 4, 8)
HALO_KS = (1, 3, 16, 32, 33, 128, 130)
HALO_HEADS = (2, 8)
HALO_SPLIT_LENS = (64, 128)  # row 7's segment lengths timed
SHARDS = 4  # the sharded tier's main path: P=4 shards in one process
SHARDED_EPOCHS = 20  # SAGE-pool and GAT; the GCN runs EPOCHS
SHARDED_GAT_DIMS, SHARDED_GAT_HEADS = [128, 8, 3], 2
INTEROP_K = 32  # phase 21's operand width
BASELINE_EPOCHS = 20  # phases 22-24: each run's epochs
LSTM_NEIGHBORS = 32  # phase 23's neighbour sample cap
CKPT_EPOCHS = 10  # phase 25: straight, or half, a checkpoint, half
# Phase 27: dist_bench's weak scaling, rmat(15 + log2 P) at P = 1, 2, 4 (so
# rmat17 at P = 4: 131,072 nodes, 3,728,080 nonzeros), edge factor 16, K=64.
DIST_DEVICES, DIST_SCALE, DIST_K, DIST_EDGE_FACTOR = (1, 2, 4), 15, 64, 16


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def mean(xs):
    return sum(xs) / len(xs)


def finite_list(xs):
    return all(x == x and abs(x) != float("inf") for x in xs)


def bound_check(torch, ref, out, indptr, indices, rows, data, B):
    """Max abs error against float64, and whether it is within the bound."""
    m = indptr.shape[0] - 1
    d64 = None if data is None else data.double()
    exact = ref.spmm_rows(rows, indices, d64, B.double(), m)
    mag = ref.spmm_rows(rows, indices, None if d64 is None else d64.abs(),
                        B.double().abs(), m)
    bound = 8e-3 * mag if B.dtype == torch.bfloat16 else 1e-5 * mag + 1e-6
    err = (out.double() - exact).abs()
    ok = bool(torch.isfinite(out.double()).all()) and bool((err <= bound).all())
    return float(err.max()) if err.numel() else 0.0, ok


def gat_kernels_vs_float64(torch, ref, kgat, adj, H, dh, max_mode, dtype,
                           gen):
    """Run the three fused kernels twice, with the adjacency's splits;
    ({name: (max abs error, bound)} against the float64 plain versions (the
    backward's s = <g, out> from the kernel's stored out, as the op takes
    it), whether the two runs are bitwise equal)."""
    dev = adj.csr.indptr.device
    m, n = adj.shape
    src = torch.randn(m, H, device=dev, generator=gen)
    dst = torch.randn(n, H, device=dev, generator=gen)
    B = torch.randn(n, H * dh, device=dev, generator=gen).to(dtype)
    g = torch.randn(m, H * dh, device=dev, generator=gen)
    kw = dict(slope=SLOPE, heads=H)

    def run():
        out, mx, den = kgat.gat_forward(adj.csr.indptr, adj.csr.indices, src,
                                        dst, B, max_mode=max_mode,
                                        split=adj.split, **kw)
        tabs = (src, dst, B, g, mx, den, ref.gat_row_dot(g, out, H))
        grad_src = kgat.gat_backward_rows(adj.csr.indptr, adj.csr.indices,
                                          *tabs, split=adj.split, **kw)
        grad_dst, grad_B = kgat.gat_backward_cols(
            adj.csc.indptr, adj.csc.indices, *tabs, split=adj.split_t, **kw)
        return out, mx, den, grad_src, grad_dst, grad_B

    first, second = run(), run()
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(first, second))
    out, mx, den, grad_src, grad_dst, grad_B = first
    edges = (adj.rows, adj.csr.indices)
    s64, d64, B64, g64 = src.double(), dst.double(), B.double(), g.double()
    want_out, mx64, den64 = ref.gat_fused_rows(*edges, s64, d64, B64, m, SLOPE,
                                               max_mode, H)
    vjp = (*edges, s64, d64, B64, g64, mx64, den64,
           ref.gat_row_dot(g64, out.double(), H))
    want_src = ref.gat_fused_vjp_rows(*vjp, m, SLOPE, H)
    want_dst, want_B = ref.gat_fused_vjp_cols(*vjp, SLOPE, H)
    bf16 = dtype == torch.bfloat16
    errs = {}
    for name, got, want, fwd, tol in (
            ("out", out, want_out, True, 8e-3 if bf16 else 1e-5),
            ("mx", mx, mx64, True, 1e-5), ("den", den, den64, True, 1e-5),
            ("grad_src", grad_src, want_src, False, 1e-4),
            ("grad_dst", grad_dst, want_dst, False, 1e-4),
            ("grad_B", grad_B, want_B, False, 8e-3 if bf16 else 1e-4)):
        check(tuple(got.shape) == tuple(want.shape)
              and bool(torch.isfinite(got).all()), f"{name}: shape or finite")
        scale = float(want.abs().max())
        bound = tol * scale + 1e-6 if fwd else tol * max(scale, 1.0)
        errs[name] = (float((got.double() - want).abs().max()), bound)
    return errs, repeat


def gat_bytes(kind, m, n, nnz, H, K):
    """(bytes, operations) of one row-5 kernel call in f32: each input read
    once and each output written once (the CSR's or, for the CSC backward,
    the CSC's indptr and indices; src, dst, B; g and the row-side tables
    backward), and the per-edge work (2K flops a gathered row, the logit,
    exp and weights a head)."""
    idx = ((n if kind == "gat_bwd_cols" else m) + 1) * 4 + nnz * 4
    tabs = (m + n) * H * 4 + n * K * 4
    if kind == "gat_fwd":  # out, mx, den
        return idx + tabs + m * K * 4 + 2 * m * H * 4, nnz * (2 * K + 8 * H)
    if kind == "gat_bwd_rows":  # g, mx, den, s in; grad_src out
        return idx + tabs + m * K * 4 + 4 * m * H * 4, nnz * (2 * K + 10 * H)
    # g, mx, den, s in; grad_B, grad_dst out
    return (idx + tabs + m * K * 4 + 3 * m * H * 4 + n * K * 4 + n * H * 4,
            nnz * (4 * K + 10 * H))


def dot_kernels_vs_float64(torch, ref, kgat, adj, Ka, K, slope, dtype, gen):
    """Run the three dot-attention kernels twice, with the adjacency's
    splits; ({name: (max abs error,
    bound)} against the float64 plain versions, whether the two runs are
    bitwise equal).  D1 and D2 have std Ka^-1/4 (unit-variance logits)."""
    dev = adj.csr.indptr.device
    m, n = adj.shape
    D1 = torch.randn(m, Ka, device=dev, generator=gen) * Ka ** -0.25
    D2 = torch.randn(n, Ka, device=dev, generator=gen) * Ka ** -0.25
    B = torch.randn(n, K, device=dev, generator=gen).to(dtype)
    g = torch.randn(m, K, device=dev, generator=gen)

    def run():
        out, mx, den = kgat.dot_forward(adj.csr.indptr, adj.csr.indices, D1,
                                        D2, B, slope=slope, split=adj.split)
        tabs = (D1, D2, B, g, mx, den, ref.dot_row_dot(g, out))
        gD1 = kgat.dot_backward_rows(adj.csr.indptr, adj.csr.indices, *tabs,
                                     slope=slope, split=adj.split)
        gD2, gB = kgat.dot_backward_cols(adj.csc.indptr, adj.csc.indices,
                                         *tabs, slope=slope,
                                         split=adj.split_t)
        return out, mx, den, gD1, gD2, gB

    first, second = run(), run()
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(first, second))
    out, mx, den, gD1, gD2, gB = first
    edges = (adj.rows, adj.csr.indices)
    want_out, mx64, den64 = ref.dot_attention_rows(
        *edges, D1.double(), D2.double(), B.double(), m, slope)
    tabs64 = (D1.double(), D2.double(), B.double(), g.double(), mx64, den64,
              ref.dot_row_dot(g.double(), out.double()))  # the stored out
    want_d1 = ref.dot_attention_vjp_rows(*edges, *tabs64, m, slope)
    want_d2, want_B = ref.dot_attention_vjp_cols(*edges, *tabs64, slope)
    bf16 = dtype == torch.bfloat16
    errs = {}
    for name, got, want, fwd, tol in (
            ("out", out, want_out, True, 8e-3 if bf16 else 1e-5),
            ("mx", mx, mx64, True, 1e-5), ("den", den, den64, True, 1e-5),
            ("grad_D1", gD1, want_d1, False, 1e-4),
            ("grad_D2", gD2, want_d2, False, 1e-4),
            ("grad_B", gB, want_B, False, 8e-3 if bf16 else 1e-4)):
        check(tuple(got.shape) == tuple(want.shape)
              and bool(torch.isfinite(got).all()), f"{name}: shape or finite")
        scale = float(want.abs().max())
        bound = tol * scale + 1e-6 if fwd else tol * max(scale, 1.0)
        errs[name] = (float((got.double() - want).abs().max()), bound)
    return errs, repeat


def alternate(measure, kernel, plain):
    """(kernel, plain) measurements in ms, taken plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = measure(plain), measure(kernel), measure(kernel), \
        measure(plain)
    return [k1 * 1e3, k2 * 1e3], [p1 * 1e3, p2 * 1e3]


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--record", default="",
                      help="also write the full record of the run here (JSON)")
    args = args.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "gespmm_tpu_torch")):
        print(f"chip_smoke: no gespmm_tpu_torch package beside this script in "
              f"{HERE}; run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from gespmm_tpu_torch.kernels import _build
    from gespmm_tpu_torch.kernels import edge_reduce as kedge
    from gespmm_tpu_torch.kernels import gat_fused as kgat
    from gespmm_tpu_torch.kernels import halo_spmm as khalo
    from gespmm_tpu_torch.kernels import spmm_csr as kspmm
    from gespmm_tpu_torch.kernels import spmm_minmax as kmm
    from gespmm_tpu_torch.kernels import spmm_grouped as kgrp
    from gespmm_tpu_torch.kernels import spmm_pallas as kpal
    from gespmm_tpu_torch.bench.dist_bench import bench_weak_scaling
    from gespmm_tpu_torch.bench.headline import headline
    from gespmm_tpu_torch.bench.spmm_bench import (bench_graph,
                                                   bench_sddmm_graph)
    from gespmm_tpu_torch.models.baselines import GATStock, GCNBcoo, SAGEStock
    from gespmm_tpu_torch.models.gat import GAT
    from gespmm_tpu_torch.models.gcn import GCN
    from gespmm_tpu_torch.models.sage import GraphSAGE
    from gespmm_tpu_torch.models.sage_lstm import build_neighbor_table
    from gespmm_tpu_torch.ops import reference as ref
    from gespmm_tpu_torch.ops.graph import (add_self_loops,
                                            additive_attention_logits,
                                            attention_aggregate, edge_softmax)
    from gespmm_tpu_torch.ops.interop import (AdjacencyMatrix,
                                              csr_from_torch_sparse,
                                              csr_to_torch_sparse)
    from gespmm_tpu_torch.ops.sddmm import sddmm
    from gespmm_tpu_torch.ops.spmm import Adjacency, spmm
    from gespmm_tpu_torch.parallel import (build_halo_partition, dist_spmm,
                                           halo_spmm, make_mesh,
                                           partition_adjacency)
    from gespmm_tpu_torch.parallel.dryrun import dryrun_multichip
    from gespmm_tpu_torch.parallel.halo import (make_exchange,
                                                split_edge_values)
    from gespmm_tpu_torch.parallel.mesh import maybe_distributed_init
    from gespmm_tpu_torch.parallel.train_step import (ShardedGAT,
                                                      ShardedGCN,
                                                      ShardedSAGE,
                                                      build_sharded_gat,
                                                      build_sharded_gcn,
                                                      build_sharded_sage)
    from gespmm_tpu_torch.sparse.formats import CSR, expand_indptr
    from gespmm_tpu_torch.sparse.partition import (SPLIT_LEN,
                                                    build_grouped_plan,
                                                    build_row_split,
                                                    build_spmm_plan)
    from gespmm_tpu_torch.sparse.io import read_mtx, write_mtx
    from gespmm_tpu_torch.sparse.reorder import (apply_permutation,
                                                 fennel_partition,
                                                 halo_need_stats,
                                                 inverse_permutation,
                                                 partition_order, reorder)
    from gespmm_tpu_torch.train.loop import (make_train_step,
                                             train_node_classifier)
    from gespmm_tpu_torch.utils import native, profiling, timing
    from gespmm_tpu_torch.utils.datasets import (GraphDataset, rmat_graph,
                                                 sbm_graph,
                                                 split_boundary_graph,
                                                 synth_graph)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}

    def reset_counts():
        for mod in (kspmm, kmm, kedge, kgat, kpal, kgrp, khalo):
            mod.reset_launches()

    def counts():
        return {"spmm_csr": kspmm.launches,
                "spmm_csr_carry": kspmm.carry_launches,
                "spmm_minmax": kmm.launches,
                "spmm_minmax_carry": kmm.carry_launches,
                "spmm_minmax_vjp": kmm.vjp_launches,
                "spmm_minmax_vjp_carry": kmm.vjp_carry_launches,
                "edge_segment_reduce": kedge.launches,
                "edge_segment_reduce_carry": kedge.carry_launches,
                "gat_fwd": kgat.launches,
                "gat_bwd_rows": kgat.bwd_rows_launches,
                "gat_bwd_cols": kgat.bwd_cols_launches,
                "gat_fwd_carry": kgat.carry_launches,
                "gat_bwd_rows_carry": kgat.bwd_rows_carry_launches,
                "gat_bwd_cols_carry": kgat.bwd_cols_carry_launches,
                "dot_fwd": kgat.dot_launches,
                "dot_bwd_rows": kgat.dot_bwd_rows_launches,
                "dot_bwd_cols": kgat.dot_bwd_cols_launches,
                "dot_fwd_carry": kgat.dot_carry_launches,
                "dot_bwd_rows_carry": kgat.dot_bwd_rows_carry_launches,
                "dot_bwd_cols_carry": kgat.dot_bwd_cols_carry_launches,
                "spmm_chunk": kpal.launches,
                "spmm_chunk_carry": kpal.carry_launches,
                "spmm_grouped": kgrp.launches,
                "spmm_grouped_carry": kgrp.carry_launches,
                "halo_spmm": khalo.launches,
                "halo_spmm_carry": khalo.carry_launches}

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {count} x "
          f"{kind} | nvidia-smi: {card}", flush=True)
    record["card"] = card

    phase("2 build")

    def timed_build(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBS)) as pool:
        built = dict(zip(LIBS, pool.map(timed_build, LIBS)))
    record["build_s"] = {name: s for name, (_, s) in built.items()}
    record["build_s"]["all"] = time.perf_counter() - t0
    for name, (lib, s) in built.items():
        print(f"nvcc {' '.join(_build.NVCC_FLAGS)} -> "
              f"{os.path.relpath(lib, HERE)} in {s:.2f} s", flush=True)
    print(f"all {len(LIBS)} built in {record['build_s']['all']:.2f} s",
          flush=True)

    phase("3 sum kernel vs plain (float64 bound)")
    ds = sbm_graph(**SBM_PUBMED).to(dev)
    adj = Adjacency.from_csr(add_self_loops(ds.csr))
    sage_adj = Adjacency.from_csr(ds.csr)
    rmat = Adjacency.from_csr(rmat_graph(scale=15, edge_factor=8, seed=SEED),
                              device=dev)
    for name, a in (("sbm-pubmed+loops", adj), ("sbm-pubmed", sage_adj),
                    ("rmat15", rmat)):
        deg = a.csr.indptr[1:] - a.csr.indptr[:-1]
        print(f"{name}: n={a.shape[0]} nnz={a.nnz} max_deg={int(deg.max())} "
              f"empty_rows={int((deg == 0).sum())}", flush=True)
    record["graphs"] = {"sbm_pubmed_loops": [adj.shape[0], adj.nnz],
                        "sbm_pubmed": [sage_adj.shape[0], sage_adj.nnz],
                        "rmat15": [rmat.shape[0], rmat.nnz]}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rmat_vals = torch.randn(rmat.nnz, device=dev, generator=gen)
    # Rows of L - 1, L, L + 1, 2L, 2L + 1 and 10,000 edges among short rows.
    hub_rng = np.random.default_rng(SEED)
    L = SPLIT_LEN
    hub_deg = np.r_[0, L - 1, L, L + 1, hub_rng.integers(0, 5, 40), 10_000,
                    2 * L, 2 * L + 1, hub_rng.integers(0, 5, 40)]
    hub_n = 12_000
    hub_cols = np.concatenate([np.sort(hub_rng.choice(hub_n, d, replace=False))
                               for d in hub_deg]).astype(np.int32)
    hub = Adjacency.from_csr(CSR(
        torch.from_numpy(np.r_[0, np.cumsum(hub_deg)].astype(np.int32)),
        torch.from_numpy(hub_cols),
        torch.from_numpy(hub_rng.standard_normal(hub_cols.shape[0]).astype(
            np.float32)), (hub_deg.shape[0], hub_n)), device=dev)
    print(f"split at L={L}: sbm+loops {adj.split.num_segments} segments "
          f"(CSC {adj.split_t.num_segments}); rmat15 {rmat.split.num_long_rows}"
          f" rows longer than L in {rmat.split.num_segments} segments; the "
          f"hub graph rows {hub.split.long_rows.tolist()} in "
          f"{hub.split.num_segments} segments", flush=True)
    check(adj.split.num_segments == adj.split_t.num_segments == 0,
          "sbm-pubmed has a row longer than L")
    # (label, indptr, indices, rows, data, split, rows of B, K, B dtype, out
    # dtype, on the slice's path)
    n_sbm, n_rmat = adj.shape[0], rmat.shape[0]  # both square
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    csr_of = {"csr": lambda a: (a.csr.indptr, a.csr.indices, a.rows, a.data,
                                a.split),
              "csc": lambda a: (a.csc.indptr, a.csc.indices, a.rows_t,
                                a.csc.data, a.split_t)}
    for K in (32, 3):
        cases.append((f"sbm csr K={K}", *csr_of["csr"](adj), n_sbm, K, f32,
                      f32, True))
        cases.append((f"sbm csc K={K}", *csr_of["csc"](adj), n_sbm, K, f32,
                      f32, True))
        cases.append((f"sbm csr K={K} bf16", *csr_of["csr"](adj), n_sbm, K,
                      bf16, bf16, False))
    rmat_csr = csr_of["csr"](rmat)[:3]
    for K in RMAT_KS:
        for dtype in (f32, bf16):
            for data in (None, rmat_vals):
                label = (f"rmat15 K={K} {'binary' if data is None else 'valued'}"
                         f" {str(dtype).split('.')[-1]}")
                cases.append((label, *rmat_csr, data, rmat.split, n_rmat, K,
                              dtype, dtype, False))
    for K in (32, 128):
        cases.append((f"rmat15 K={K} valued bf16 in f32 out", *rmat_csr,
                      rmat_vals, rmat.split, n_rmat, K, bf16, f32, False))
    cases.append(("rmat15 csc K=128 binary f32", *csr_of["csc"](rmat)[:3],
                  None, rmat.split_t, n_rmat, 128, f32, f32, False))
    for K in (32, 128, 130):
        for dtype, out_dtype in ((f32, f32), (bf16, bf16), (bf16, f32)):
            cases.append((f"hub K={K} {str(dtype).split('.')[-1]} out "
                          f"{str(out_dtype).split('.')[-1]}",
                          *csr_of["csr"](hub), hub_n, K, dtype, out_dtype,
                          False))
    slice_err = 0.0
    compared = []
    for (label, indptr, indices, rows, data, split, n_in, K, dtype, out_dtype,
         on_path) in cases:
        B = torch.randn(n_in, K, device=dev, generator=gen).to(dtype)
        out = kspmm.spmm_csr(indptr, indices, data, B, split=split,
                             out_dtype=out_dtype)
        again = kspmm.spmm_csr(indptr, indices, data, B, split=split,
                               out_dtype=out_dtype)
        torch.cuda.synchronize()
        # bf16 in, f32 out: the f32 bound of the f32 sum of the bf16 values.
        err, ok = bound_check(torch, ref, out, indptr, indices, rows, data,
                              B if out_dtype == dtype else B.float())
        same = torch.equal(out, again) and out.dtype == out_dtype
        print(f"{label}: max_abs_err={err:.3e} {'ok' if ok else 'OUT OF BOUND'}"
              f" | repeat {'bitwise' if same else 'DIFFERS'}", flush=True)
        check(ok, f"kernel disagrees with the plain version: {label}")
        check(same, f"kernel not repeatable: {label}")
        if on_path:
            slice_err = max(slice_err, err)
        compared.append({"case": label, "max_abs_err": err})
    record["kernel_vs_plain"] = compared

    phase("4 max/min kernels vs plain (exact forward, float64 backward)")

    def quantized(shape, dtype):
        x = torch.randn(shape, device=dev, generator=gen)
        return (torch.round(x * 2) / 2).to(dtype)

    sbm_vals = torch.randn(sage_adj.nnz, device=dev, generator=gen)
    # Row 3's split at its boundaries: columns of L - 1, L, L + 1, 2L + 1 and
    # 10,000 edges (rows too: the graph is symmetric in its degrees).
    mm_boundary = Adjacency.from_csr(split_boundary_graph(SPLIT_LEN),
                                     device=dev)
    check(mm_boundary.split_t.long_rows.tolist() == [2, 3, 4],
          "the boundary graph's long columns")
    boundary_vals = torch.randn(mm_boundary.nnz, device=dev, generator=gen)
    f32_bf16 = (torch.float32, torch.bfloat16)
    mm_cases = []  # (label, adjacency, CSR values or None, K, dtype, on path)
    for graph, a, vals, ks, kinds in (
            ("sbm", sage_adj, sbm_vals, MINMAX_SBM_KS,
             ((None, f32), (sbm_vals, f32), (None, bf16))),
            ("rmat15", rmat, rmat_vals, MINMAX_RMAT_KS,
             ((None, f32), (rmat_vals, f32), (None, bf16))),
            ("boundary", mm_boundary, boundary_vals, MINMAX_BOUNDARY_KS,
             [(d, t) for d in (None, boundary_vals) for t in f32_bf16])):
        for K in ks:
            for data, dtype in kinds:
                kind_s = "binary" if data is None else "valued"
                mm_cases.append((f"{graph} K={K} {kind_s} "
                                 f"{str(dtype).split('.')[-1]}", a, data, K,
                                 dtype, graph == "sbm" and data is None
                                 and dtype == torch.float32))
    fwd_err = bwd_err = 0.0
    mm_compared = []
    mm_carries = {"sbm": 0, "rmat15": 0, "boundary": 0}
    fwd_carries = dict(mm_carries)

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    for label, a, data, K, dtype, on_path in mm_cases:
        m, n = a.shape
        B = quantized((n, K), dtype)
        csc_data = None if data is None else data[a.perm.long()]
        for reduce in ("max", "min"):
            # Row 2 with the CSR's split, twice: rows above L in segments
            # whose (extremum, count) pairs the pair carry folds.
            carries = kmm.carry_launches
            out, ties = kmm.spmm_minmax(a.csr.indptr, a.csr.indices, data, B,
                                        reduce, split=a.split)
            out2, ties2 = kmm.spmm_minmax(a.csr.indptr, a.csr.indices, data,
                                          B, reduce, split=a.split)
            torch.cuda.synchronize()
            fwd_carries[label.split()[0]] += kmm.carry_launches - carries
            fwd_repeat = (torch.equal(bits(out), bits(out2))
                          and torch.equal(bits(ties), bits(ties2)))
            want, want_ties = ref.spmm_minmax_rows(a.rows, a.csr.indices, data,
                                                   B, m, reduce)
            exact = torch.equal(out, want) and torch.equal(ties, want_ties)
            if dtype == torch.float32:  # rounding to f32 is monotone
                want64 = ref.spmm_rows(a.rows, a.csr.indices,
                                       None if data is None else data.double(),
                                       B.double(), m, reduce=reduce)
                exact = exact and torch.equal(out, want64.float())
            err = float((out.double() - want.double()).abs().max())
            # g in out's dtype, as autograd hands it in; two runs.
            g = torch.randn(m, K, device=dev, generator=gen).to(dtype)
            carries = kmm.vjp_carry_launches
            grad_B, grad_vals = kmm.spmm_minmax_vjp(
                a.csc.indptr, a.csc.indices, csc_data, B, out, g, ties,
                split=a.split_t)
            again = kmm.spmm_minmax_vjp(
                a.csc.indptr, a.csc.indices, csc_data, B, out, g, ties,
                split=a.split_t)
            torch.cuda.synchronize()
            mm_carries[label.split()[0]] += kmm.vjp_carry_launches - carries
            repeat = torch.equal(grad_B, again[0]) and (
                grad_vals is None or torch.equal(grad_vals, again[1]))
            gt64 = g.double() / torch.clamp(ties, min=1.0).double()
            want_B, want_vals = ref.spmm_minmax_vjp_cols(
                a.rows_t, a.csc.indices, csc_data, B, out, gt64)
            tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
            grads_ok, g_err = True, 0.0
            for got, w in ((grad_B, want_B), (grad_vals, want_vals)):
                if w is None:
                    grads_ok = grads_ok and got is None
                    continue
                e = float((got.double() - w).abs().max())
                g_err = max(g_err, e)
                grads_ok = grads_ok and bool(torch.isfinite(got).all()) and \
                    e <= tol * max(float(w.abs().max()), 1.0)
            print(f"{label} {reduce}: out/ties {'exact' if exact else 'DIFFER'}"
                  f" (max ties {int(ties.max())}), forward repeat "
                  f"{'bitwise' if fwd_repeat else 'DIFFERS'} | grad max_abs_err="
                  f"{g_err:.3e} {'ok' if grads_ok else 'OUT OF BOUND'} | "
                  f"repeat {'bitwise' if repeat else 'DIFFERS'}", flush=True)
            check(exact, f"forward kernel disagrees with plain: {label} {reduce}")
            check(fwd_repeat, f"forward kernel not repeatable: {label} {reduce}")
            check(grads_ok, f"backward kernel disagrees with float64: {label} "
                  f"{reduce}")
            check(repeat, f"backward kernel not repeatable: {label} {reduce}")
            if on_path and reduce == "max":
                fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, g_err)
            mm_compared.append({"case": f"{label} {reduce}", "exact": exact,
                                "grad_max_abs_err": g_err,
                                "max_ties": int(ties.max())})
    # Two runs of rows 2 and 3 a case, each with one carry where the CSR has
    # a row (the CSC a column) above L: rmat15's hubs, the boundary graph's
    # three; none on sbm.
    print(f"row 2 carries over the two runs of each case: {fwd_carries}; "
          f"row 3's: {mm_carries}", flush=True)
    n_cases = {g: 2 * sum(c[0].startswith(g + " ") for c in mm_cases)
               for g in mm_carries}
    check(fwd_carries == {"sbm": 0, "rmat15": 2 * n_cases["rmat15"],
                          "boundary": 2 * n_cases["boundary"]},
          f"row 2 carries {fwd_carries}: expected 2 a case on rmat15 and the "
          "boundary graph, none on sbm")
    check(mm_carries == {"sbm": 0, "rmat15": 2 * n_cases["rmat15"],
                         "boundary": 2 * n_cases["boundary"]},
          f"row 3 carries {mm_carries}: expected 2 a case on rmat15 and the "
          "boundary graph, none on sbm")
    record["minmax_vs_plain"] = mm_compared
    record["minmax_carries"] = fwd_carries
    record["minmax_vjp_carries"] = mm_carries

    phase("5 autograd on the card")
    d = adj.data.clone().requires_grad_(True)
    B = torch.randn(adj.shape[1], 32, device=dev, generator=gen,
                    requires_grad=True)
    g = torch.randn(adj.shape[0], 32, device=dev, generator=gen)
    spmm(adj.with_data(d), B).backward(g)
    d64 = adj.data.double().requires_grad_(True)
    B64 = B.detach().double().requires_grad_(True)
    spmm(adj.with_data(d64), B64, method="xla").backward(g.double())
    for name, got, want in (("grad_B", B.grad, B64.grad),
                            ("grad_values", d.grad, d64.grad)):
        err = float((got.double() - want).abs().max())
        scale = float(want.abs().max())
        print(f"{name}: max_abs_err={err:.3e} (max |ref| {scale:.3e})", flush=True)
        check(torch.isfinite(got).all() and err <= 1e-5 * max(scale, 1.0),
              f"{name} disagrees with float64")

    def make_gcn(method):
        return GCN(GCN_DIMS, dropout_rate=0.5, method=method,
                   generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev).with_norms(adj)

    def make_sage(method, aggregator="pool", table=None):
        return GraphSAGE(SAGE_DIMS, aggregator=aggregator, dropout_rate=0.5,
                         method=method, neighbor_table=table,
                         generator=torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)

    def make_gat(method, dims=GAT_DIMS, heads=1):
        return GAT(dims, dropout_rate=0.5, method=method, heads=heads,
                   generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev)

    def make_gat_mh(method):
        return make_gat(method, GAT_MH_DIMS, GAT_MH_HEADS)

    def train(make, a, method, epochs=EPOCHS, lr=1e-2, data=None):
        data = ds if data is None else data
        model = make(method)
        reset_counts()
        res = train_node_classifier(model, a, data.features, data.labels,
                                    data.masks, seed=SEED, epochs=epochs,
                                    lr=lr)
        torch.cuda.synchronize()
        return model, res, counts()

    def drive(name, make, a, cpu_model, path_kernels, methods=("auto", "xla"),
              epochs=EPOCHS, lr=1e-2, data=None, absent=(), check_model=None):
        """Train with each method; check the run of each kernel method
        (all but "xla") and its launches: at least ``path_kernels[name]``
        an epoch of each, none of the kernels named in ``absent``.
        ``check_model`` gets the trained model of the kernel method."""
        data = ds if data is None else data
        runs = {}
        for method in methods:
            model, res, launched = train(make, a, method, epochs, lr, data)
            loss = res["history"]["loss"]
            print(f"{name} method={method}: loss {loss[0]:.4f} -> "
                  f"{loss[-1]:.4f} | train/val/test acc {res['train_acc']:.4f}/"
                  f"{res['val_acc']:.4f}/{res['test_acc']:.4f} | "
                  f"{res['mean_epoch_time'] * 1e3:.4f} ms/epoch | launches "
                  f"{launched}", flush=True)
            check(finite_list(loss) and loss[-1] < loss[0],
                  f"{name} {method}: loss did not fall")
            check(res["train_acc"] > 1 / 3, f"{name} {method}: train accuracy "
                  "at chance")
            check(all(torch.isfinite(p).all() for p in model.parameters()),
                  f"{name} {method}: non-finite parameters")
            if method != "xla":
                for kname, per_epoch in path_kernels.items():
                    check(launched[kname] >= per_epoch * epochs,
                          f"{name}: only {launched[kname]} {kname} launches in "
                          f"{epochs} epochs")
                for kname in absent:
                    check(launched[kname] == 0,
                          f"{name}: {launched[kname]} {kname} launches")
                model.eval()
                with torch.no_grad():
                    logits = model(a, data.features)
                    cpu_model.load_state_dict(
                        {k: v.cpu().double() for k, v in model.state_dict().items()})
                    cpu_model.eval()
                    cpu_adj = Adjacency.from_csr(a.csr.to("cpu").with_data(
                        None if a.data is None else a.data.cpu().double()))
                    want = cpu_model(cpu_adj, data.features.cpu().double())
                check(logits.shape == (a.shape[0], cpu_model.dims[-1]),
                      f"{name}: logits shape")
                err = float((logits.cpu().double() - want).abs().max())
                scale = float(want.abs().max())
                print(f"{name} logits vs float64 CPU forward: max_abs_err="
                      f"{err:.3e} (max |ref| {scale:.3e})", flush=True)
                check(err <= 1e-4 * max(scale, 1.0),
                      f"{name}: logits disagree with float64")
                if check_model is not None:
                    check_model(model)
            else:
                check(not any(launched.values()),
                      f"{name}: method='xla' launched a kernel: {launched}")
            runs[method] = {"loss_first": loss[0], "loss_last": loss[-1],
                            "train_acc": res["train_acc"],
                            "val_acc": res["val_acc"],
                            "test_acc": res["test_acc"],
                            "ms_per_epoch_runs": [res["mean_epoch_time"] * 1e3],
                            "launches": launched}
        return runs

    phase(f"6 GCN train, dims {GCN_DIMS}, {EPOCHS} epochs")
    gcn_runs = drive("GCN", make_gcn, adj,
                     GCN(GCN_DIMS, method="xla").double(), {"spmm_csr": 4})
    record["gcn"] = gcn_runs

    phase(f"7 SAGE-pool train, dims {SAGE_DIMS}, {EPOCHS} epochs")
    sage_runs = drive("SAGE-pool", make_sage, sage_adj,
                      GraphSAGE(SAGE_DIMS, aggregator="pool", method="xla").double(),
                      {"spmm_minmax": 2, "spmm_minmax_vjp": 2},
                      absent=("spmm_minmax_carry", "spmm_minmax_vjp_carry"))
    # Row 3: one launch a layer and epoch; no column of sbm above L.
    check(sage_runs["auto"]["launches"]["spmm_minmax_vjp"] == 2 * EPOCHS,
          f"SAGE-pool: {sage_runs['auto']['launches']['spmm_minmax_vjp']} "
          f"row-3 launches in {EPOCHS} epochs, expected {2 * EPOCHS}")
    record["sage_pool"] = sage_runs

    phase("8 attention kernels vs plain (float64 bound)")
    att_err = {"edge_segment_reduce": 0.0, "gat_fwd": 0.0, "gat_bwd_rows": 0.0,
               "gat_bwd_cols": 0.0}
    att_compared = []
    # Edge segment reduce with the adjacency's split: K is the head count;
    # the slice runs K=1.  Two calls each, bitwise equal; the carry runs once
    # a call on rmat15 and the split-boundary graph, never on sbm.
    bnd = Adjacency.from_csr(split_boundary_graph(SPLIT_LEN, seed=SEED),
                             device=dev)
    seg_carries = {}
    for graph, a, ks in (("sbm", adj, (1, 8)), ("rmat15", rmat, (1, 3, 8)),
                         ("boundary", bnd, (1, 3, 8))):
        m = a.shape[0]
        for K in ks:
            for dtype in (torch.float32, torch.bfloat16):
                vals = torch.randn(a.nnz, K, device=dev, generator=gen).to(dtype)
                for op in ("sum", "max"):
                    before = kedge.carry_launches
                    out, again = (kedge.edge_segment_reduce(
                        a.csr.indptr, vals, op, split=a.split)
                        for _ in range(2))
                    torch.cuda.synchronize()
                    carries = kedge.carry_launches - before
                    seg_carries.setdefault(graph, set()).add(carries)
                    repeat = torch.equal(out, again)
                    label = (f"edge_segment_reduce {graph} K={K} {op} "
                             f"{str(dtype).split('.')[-1]}")
                    if op == "max":  # selected, not summed: exact
                        want = ref.edge_segment_rows(a.rows, vals, m, "max")
                        ok = torch.equal(out, want)
                        err = float((out.double() - want.double()).abs().max())
                    else:
                        want = ref.edge_segment_rows(a.rows, vals.double(), m,
                                                     "sum")
                        tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
                        err = float((out.double() - want).abs().max())
                        ok = err <= tol * float(want.abs().max()) + 1e-6
                    print(f"{label}: max_abs_err={err:.3e} carries in two "
                          f"runs {carries} | repeat "
                          f"{'bitwise' if repeat else 'DIFFERS'} "
                          f"{'ok' if ok else 'OUT OF BOUND'}", flush=True)
                    check(ok, f"kernel disagrees with the plain version: {label}")
                    check(repeat, f"edge reduce not bitwise repeatable: {label}")
                    if graph == "sbm" and K == 1 and dtype == torch.float32:
                        att_err["edge_segment_reduce"] = max(
                            att_err["edge_segment_reduce"], err)
                    att_compared.append({"case": label, "max_abs_err": err,
                                         "carries_in_two_runs": carries,
                                         "repeat": repeat})
    check(seg_carries["sbm"] == {0},
          f"the edge reduce launched a carry on sbm: {seg_carries['sbm']}")
    for graph in ("rmat15", "boundary"):
        check(seg_carries[graph] == {2},
              f"edge reduce carries on {graph}: {seg_carries[graph]}")
    # The three fused kernels, with their splits: none on sbm, hub rows and
    # columns on rmat15 and the split-boundary graph.
    print(f"split-boundary graph: n={bnd.shape[0]} nnz={bnd.nnz}, long rows "
          f"{bnd.split.long_rows.tolist()} in {bnd.split.num_segments} "
          f"segments, long columns {bnd.split_t.long_rows.tolist()} in "
          f"{bnd.split_t.num_segments}; rmat15 {rmat.split.num_long_rows} "
          f"long rows in {rmat.split.num_segments} segments, "
          f"{rmat.split_t.num_long_rows} long columns in "
          f"{rmat.split_t.num_segments}", flush=True)
    modes = ("exact", "bound")
    dtypes = (torch.float32, torch.bfloat16)
    gat_cases = [(graph, a, H, dh, mm, dt)
                 for graph, a, shapes in (("sbm", adj, GAT_SBM_SHAPES),
                                          ("rmat15", rmat, GAT_RMAT_SHAPES),
                                          ("boundary", bnd,
                                           GAT_BOUNDARY_SHAPES))
                 for H, dh in shapes for mm in modes for dt in dtypes]
    carry_names = ("gat_fwd_carry", "gat_bwd_rows_carry", "gat_bwd_cols_carry")
    gat_carries = {}
    gat_err = {}  # (graph, H, dh): each kernel's error, f32 exact
    for graph, a, H, dh, max_mode, dtype in gat_cases:
        label = (f"gat {graph} H={H} dh={dh} {max_mode} "
                 f"{str(dtype).split('.')[-1]}")
        before = counts()
        errs, repeat = gat_kernels_vs_float64(torch, ref, kgat, a, H, dh,
                                              max_mode, dtype, gen)
        after = counts()
        carries = tuple(after[k] - before[k] for k in carry_names)
        gat_carries.setdefault(graph, set()).add(carries)
        bad = [k for k, (e, b) in errs.items() if e > b]
        print(f"{label}: " + " ".join(f"{k}={e:.3e}" for k, (e, _) in
                                      errs.items())
              + f" | carries in two runs {carries} | repeat "
              + ("bitwise" if repeat else "DIFFERS")
              + (f" OUT OF BOUND: {bad}" if bad else " ok"), flush=True)
        check(not bad, f"fused kernels disagree with float64: {label} {bad}")
        check(repeat, f"fused kernels not repeatable: {label}")
        if (max_mode, dtype) == ("exact", torch.float32):
            gat_err[(graph, H, dh)] = {
                "gat_fwd": errs["out"][0], "gat_bwd_rows": errs["grad_src"][0],
                "gat_bwd_cols": max(errs["grad_dst"][0], errs["grad_B"][0])}
        att_compared.append({"case": label, "errors": errs,
                             "carries_in_two_runs": carries, "repeat": repeat})
    att_err.update(gat_err[("sbm", 1, 64)])
    check(gat_carries["sbm"] == {(0, 0, 0)},
          f"a fused kernel launched a carry on sbm: {gat_carries['sbm']}")
    for graph in ("rmat15", "boundary"):  # 1, 1 and 2 carries a run
        check(gat_carries[graph] == {(2, 2, 4)},
              f"fused kernels' carries on {graph}: {gat_carries[graph]}")
    record["attention_vs_plain"] = att_compared

    phase("9 composed attention chain on the card (layer 0: K=64)")

    def chain(src, dst, h, method):
        logits = additive_attention_logits(adj, src, dst, method=method)
        alpha = edge_softmax(
            adj, torch.nn.functional.leaky_relu(logits, SLOPE), method=method)
        return spmm(adj.with_data(alpha), h, method=method)

    n_sbm = adj.shape[0]
    leaves = [torch.randn(shape, device=dev, generator=gen) for shape in
              ((n_sbm,), (n_sbm,), (n_sbm, GAT_DIMS[1]))]
    g_out = torch.randn(n_sbm, GAT_DIMS[1], device=dev, generator=gen)

    def grads_of(run, dtype=torch.float32):
        xs = [t.to(dtype, copy=True).requires_grad_(True) for t in leaves]
        out = run(*xs)
        out.backward(g_out.to(dtype))
        return [out.detach()] + [x.grad for x in xs]

    reset_counts()
    composed = grads_of(lambda s, d, h: chain(s, d, h, "auto"))
    torch.cuda.synchronize()
    chain_launches = counts()
    fused = grads_of(lambda s, d, h: kgat.gat_attention_aggregate(
        adj, s, d, h, negative_slope=SLOPE))
    exact = grads_of(lambda s, d, h: chain(s, d, h, "xla"), torch.float64)
    print(f"composed chain launches: {chain_launches}", flush=True)
    check(chain_launches["edge_segment_reduce"] == 5,
          "composed chain: expected 2 + 3 segment-reduce launches")
    check(chain_launches["edge_segment_reduce_carry"] == 0,
          "composed chain: a segment-reduce carry on sbm")
    check(chain_launches["spmm_csr"] == 2,
          "composed chain: expected 2 spmm_csr launches")
    chain_errs = {}
    for name, c, f, x in zip(("out", "grad_src", "grad_dst", "grad_B"),
                             composed, fused, exact):
        scale = float(x.abs().max())
        tol = 1e-5 * scale + 1e-6 if name == "out" else 1e-4 * max(scale, 1.0)
        e_x = float((c.double() - x).abs().max())
        e_f = float((c - f).abs().max())
        chain_errs[name] = {"vs_float64": e_x, "vs_fused": e_f}
        print(f"{name}: vs float64 {e_x:.3e}, vs fused {e_f:.3e} (max |ref| "
              f"{scale:.3e})", flush=True)
        check(bool(torch.isfinite(c).all()) and e_x <= tol and e_f <= tol,
              f"composed chain {name} disagrees")
    record["composed_chain"] = {"launches": chain_launches,
                                "errors": chain_errs}

    phase(f"10 GAT train, dims {GAT_DIMS}, {EPOCHS} epochs; then "
          f"{GAT_MH_HEADS} heads {GAT_MH_DIMS}, {GAT_MH_EPOCHS} epochs")
    gat_path = {"gat_fwd": 2, "gat_bwd_rows": 2, "gat_bwd_cols": 2}
    gat_runs = drive("GAT", make_gat, adj, GAT(GAT_DIMS, method="xla").double(),
                     gat_path, lr=GAT_LR)
    record["gat"] = gat_runs
    gat_mh_runs = drive(
        f"GAT heads={GAT_MH_HEADS}", make_gat_mh, adj,
        GAT(GAT_MH_DIMS, method="xla", heads=GAT_MH_HEADS).double(), gat_path,
        methods=("auto",), epochs=GAT_MH_EPOCHS, lr=GAT_LR)
    record["gat_multihead"] = gat_mh_runs
    # Each epoch: one launch of each fused kernel a layer; the final
    # evaluation's forward adds one a layer; sbm has no long row: no carry.
    for name, runs, epochs in (("GAT", gat_runs, EPOCHS),
                               (f"GAT heads={GAT_MH_HEADS}", gat_mh_runs,
                                GAT_MH_EPOCHS)):
        got = runs["auto"]["launches"]
        want = {"gat_fwd": 2 * epochs + 2, "gat_bwd_rows": 2 * epochs,
                "gat_bwd_cols": 2 * epochs, "gat_fwd_carry": 0,
                "gat_bwd_rows_carry": 0, "gat_bwd_cols_carry": 0}
        print(f"{name}: row-5 launches {[got[k] for k in want]} in {epochs} "
              f"epochs, expected {list(want.values())}", flush=True)
        check(all(got[k] == v for k, v in want.items()),
              f"{name}: row-5 launches {got}")

    phase("11 dot-product attention kernels vs float64")
    dot_err = {"dot_fwd": 0.0, "dot_bwd_rows": 0.0, "dot_bwd_cols": 0.0}
    dot_err_rmat = dict(dot_err)
    dot_compared = []
    dot_cases = [("sbm", adj, Ka, K) for Ka, K in DOT_SBM_SHAPES]
    dot_cases.append(("rmat15", rmat, 64, 64))
    dot_cases += [("boundary", bnd, Ka, K) for Ka, K in DOT_BOUNDARY_SHAPES]
    dot_carry_names = ("dot_fwd_carry", "dot_bwd_rows_carry",
                       "dot_bwd_cols_carry")
    dot_carries = {}
    for graph, a, Ka, K in dot_cases:
        for slope in (None, SLOPE):
            for dtype in (torch.float32, torch.bfloat16):
                label = (f"dot {graph} Ka={Ka} K={K} slope={slope} "
                         f"{str(dtype).split('.')[-1]}")
                before = counts()
                errs, repeat = dot_kernels_vs_float64(torch, ref, kgat, a, Ka,
                                                      K, slope, dtype, gen)
                after = counts()
                carries = tuple(after[k] - before[k] for k in dot_carry_names)
                dot_carries.setdefault(graph, set()).add(carries)
                bad = [k for k, (e, b) in errs.items() if e > b]
                print(f"{label}: " + " ".join(f"{k}={e:.3e}" for k, (e, _) in
                                              errs.items())
                      + f" | carries in two runs {carries} | repeat "
                      + ("bitwise" if repeat else "DIFFERS")
                      + (f" OUT OF BOUND: {bad}" if bad else " ok"), flush=True)
                check(not bad, f"dot kernels disagree with float64: {label} "
                      f"{bad}")
                check(repeat, f"dot kernels not bitwise repeatable: {label}")
                if (graph, Ka, K, slope, dtype) == ("sbm", 64, 64, None,
                                                    torch.float32):
                    dot_err = {"dot_fwd": errs["out"][0],
                               "dot_bwd_rows": errs["grad_D1"][0],
                               "dot_bwd_cols": max(errs["grad_D2"][0],
                                                   errs["grad_B"][0])}
                if (graph, slope, dtype) == ("rmat15", None, torch.float32):
                    dot_err_rmat = {"dot_fwd": errs["out"][0],
                                    "dot_bwd_rows": errs["grad_D1"][0],
                                    "dot_bwd_cols": max(errs["grad_D2"][0],
                                                        errs["grad_B"][0])}
                dot_compared.append({"case": label, "errors": errs,
                                     "carries_in_two_runs": carries,
                                     "repeat": repeat})
    check(dot_carries["sbm"] == {(0, 0, 0)},
          f"a dot kernel launched a carry on sbm: {dot_carries['sbm']}")
    for graph in ("rmat15", "boundary"):  # 1, 1 and 2 carries a run
        check(dot_carries[graph] == {(2, 2, 4)},
              f"dot kernels' carries on {graph}: {dot_carries[graph]}")
    record["dot_vs_plain"] = dot_compared

    phase("12 attention_aggregate on the card (Ka=64, K=64)")
    Ka = K = 64
    dot_leaves = [torch.randn(s, device=dev, generator=gen) * f for s, f in
                  (((n_sbm, Ka), Ka ** -0.25), ((n_sbm, Ka), Ka ** -0.25),
                   ((n_sbm, K), 1.0))]
    g_dot = torch.randn(n_sbm, K, device=dev, generator=gen)

    def dot_grads_of(run, dtype=torch.float32):
        xs = [t.to(dtype, copy=True).requires_grad_(True) for t in dot_leaves]
        out = run(*xs)
        out.backward(g_dot.to(dtype))
        return [out.detach()] + [x.grad for x in xs]

    def dot_chain(q, k, v):
        return spmm(adj.with_data(edge_softmax(adj, sddmm(adj, q, k))), v)

    reset_counts()
    fused_dot = dot_grads_of(lambda q, k, v: attention_aggregate(adj, q, k, v))
    torch.cuda.synchronize()
    dot_launches = counts()
    reset_counts()
    chain_dot = dot_grads_of(dot_chain)
    torch.cuda.synchronize()
    dot_chain_launches = counts()
    reset_counts()
    xla_dot = dot_grads_of(lambda q, k, v: attention_aggregate(
        adj, q, k, v, method="xla"))
    torch.cuda.synchronize()
    xla_dot_launches = counts()
    exact_dot = dot_grads_of(lambda q, k, v: attention_aggregate(
        adj, q, k, v, method="xla"), torch.float64)
    print(f"fused launches {dot_launches}\ncomposed chain launches "
          f"{dot_chain_launches}\nxla launches {xla_dot_launches}", flush=True)
    check((dot_launches["dot_fwd"], dot_launches["dot_bwd_rows"],
           dot_launches["dot_bwd_cols"]) == (1, 1, 1),
          "attention_aggregate: expected exactly 1 launch of each dot kernel")
    check(not any(dot_launches[k] for k in dot_carry_names),
          f"attention_aggregate launched a dot carry on sbm: {dot_launches}")
    check(not any(xla_dot_launches.values()),
          f"attention_aggregate(method='xla') launched {xla_dot_launches}")
    check(dot_chain_launches["edge_segment_reduce"] == 3
          and dot_chain_launches["spmm_csr"] == 4,
          "composed dot chain: expected 3 segment-reduce and 4 sum launches")
    dot_op_errs = {}
    for name, f, c, x in zip(("out", "grad_D1", "grad_D2", "grad_B"),
                             fused_dot, chain_dot, exact_dot):
        scale = float(x.abs().max())
        tol = 1e-5 * scale + 1e-6 if name == "out" else 1e-4 * max(scale, 1.0)
        e_x = float((f.double() - x).abs().max())
        e_c = float((f - c).abs().max())
        dot_op_errs[name] = {"vs_float64": e_x, "vs_chain": e_c}
        print(f"{name}: vs float64 {e_x:.3e}, vs composed chain {e_c:.3e} "
              f"(max |ref| {scale:.3e})", flush=True)
        check(bool(torch.isfinite(f).all()) and e_x <= tol and e_c <= tol,
              f"attention_aggregate {name} disagrees")
    record["attention_aggregate"] = {
        "launches": dot_launches, "chain_launches": dot_chain_launches,
        "xla_launches": xla_dot_launches, "errors": dot_op_errs}

    phase("13 nnz-chunked SpMM vs float64")
    chunk_compared = []
    chunk_graphs = (("sbm", add_self_loops(ds.csr).to("cpu"), adj),
                    ("rmat15", rmat.csr.to("cpu"), rmat))
    for graph, host_csr, a in chunk_graphs:
        vals = torch.randn(a.nnz, device=dev, generator=gen)
        for R, E in CHUNK_SIZES:
            plan = build_spmm_plan(host_csr, rows_per_block=R,
                                   chunk_nnz=E).to(dev)
            print(f"{graph} (R, E)=({R}, {E}): {plan.num_chunks} chunks, "
                  f"{plan.num_pieces} pieces ({plan.nnz / plan.num_pieces:.2f}"
                  f" edges a piece), {plan.cut_rows.numel()} cut rows",
                  flush=True)
            for K in CHUNK_KS:
                for dtype in (torch.float32, torch.bfloat16):
                    for data in (None, vals):
                        label = (f"chunk {graph} ({R}, {E}) K={K} "
                                 f"{'binary' if data is None else 'valued'} "
                                 f"{str(dtype).split('.')[-1]}")
                        B = torch.randn(a.shape[1], K, device=dev,
                                        generator=gen).to(dtype)
                        out = kpal.spmm_pallas(plan, data, B, a.shape[0])
                        again = kpal.spmm_pallas(plan, data, B, a.shape[0])
                        torch.cuda.synchronize()
                        err, ok = bound_check(torch, ref, out, a.csr.indptr,
                                              a.csr.indices, a.rows, data, B)
                        same = torch.equal(out, again)
                        print(f"{label}: max_abs_err={err:.3e} "
                              f"{'ok' if ok else 'OUT OF BOUND'} | repeat "
                              f"{'bitwise' if same else 'DIFFERS'}", flush=True)
                        check(ok, f"chunk kernel disagrees: {label}")
                        check(same, f"chunk kernel not repeatable: {label}")
                        chunk_compared.append({"case": label,
                                               "max_abs_err": err})
    record["chunk_vs_plain"] = chunk_compared
    pal_adj = Adjacency.from_csr(add_self_loops(ds.csr), device=dev,
                                 plan="perrow", rows_per_block=64, chunk_nnz=64)
    d = pal_adj.data.clone().requires_grad_(True)
    B = torch.randn(n_sbm, 32, device=dev, generator=gen, requires_grad=True)
    g = torch.randn(n_sbm, 32, device=dev, generator=gen)
    reset_counts()
    pal_out = spmm(pal_adj.with_data(d), B, method="pallas")
    pal_out.backward(g)
    torch.cuda.synchronize()
    pal_launches = counts()
    d64 = pal_adj.data.double().requires_grad_(True)
    B64 = B.detach().double().requires_grad_(True)
    out64 = spmm(pal_adj.with_data(d64), B64, method="xla")
    out64.backward(g.double())
    print(f"spmm(method='pallas') launches {pal_launches}", flush=True)
    check(pal_launches["spmm_chunk"] == 2 and pal_launches["spmm_csr"] == 0,
          "spmm(method='pallas'): expected 2 chunk launches (forward, grad_B)")
    for name, got, want, fwd in (("out", pal_out, out64, True),
                                 ("grad_B", B.grad, B64.grad, False),
                                 ("grad_values", d.grad, d64.grad, False)):
        err = float((got.double() - want).abs().max())
        scale = float(want.abs().max())
        print(f"pallas {name}: max_abs_err={err:.3e} (max |ref| {scale:.3e})",
              flush=True)
        bound = 1e-5 * scale + 1e-6 if fwd else 1e-5 * max(scale, 1.0)
        check(bool(torch.isfinite(got).all()) and err <= bound,
              f"spmm(method='pallas') {name} disagrees with float64")
    # Without a plan of the transpose (the sweep's adjacency), grad_B takes
    # the CSR kernel: one launch of each, and no plain version.
    fwd_only = Adjacency.from_csr(add_self_loops(ds.csr), device=dev,
                                  plan="perrow", plan_transpose=False,
                                  rows_per_block=64, chunk_nnz=64)
    B.grad = None
    reset_counts()
    spmm(fwd_only, B, method="pallas").backward(g)
    torch.cuda.synchronize()
    fwd_only_launches = counts()
    t = fwd_only.transpose()
    want = spmm(t.with_data(None if t.data is None else t.data.double()),
                g.double(), method="xla")
    err = float((B.grad.double() - want).abs().max())
    print(f"spmm(method='pallas'), plan_transpose=False: launches "
          f"{fwd_only_launches}, grad_B max_abs_err={err:.3e}", flush=True)
    check(fwd_only_launches["spmm_chunk"] == 1
          and fwd_only_launches["spmm_csr"] == 1
          and err <= 1e-5 * max(float(want.abs().max()), 1.0),
          "spmm(method='pallas') without plan_t: expected the chunk kernel "
          "forward and the CSR kernel for grad_B")
    record["pallas_op"] = {"launches": pal_launches,
                           "no_plan_t_launches": fwd_only_launches}

    phase("14 the sweep: bench_graph / bench_sddmm_graph on rmat15 "
          "(synth_graph, edge factor 16)")
    reset_counts()
    sweep_row, sweep_cells = bench_graph("rmat15", [32, 128],
                                         methods=SWEEP_METHODS, validate=True,
                                         seed=SEED)
    torch.cuda.synchronize()
    sweep_launches = counts()
    sddmm_row, sddmm_cells = bench_sddmm_graph("rmat15", [64], validate=True,
                                               seed=SEED)
    print(json.dumps(sweep_row), flush=True)
    print(json.dumps(sddmm_row), flush=True)
    print(f"sweep launches {sweep_launches}", flush=True)
    failed = []
    for (K, method), cell in list(sweep_cells.items()) + list(
            sddmm_cells.items()):
        if "error" not in cell:
            print(f"K={K} {method}: {cell['ms']:.5f} ms ({cell['timer']} "
                  f"time)", flush=True)
            continue
        guarded = method == "dense" and "guard" in cell["error"]
        print(f"K={K} {method}: {cell['error']}"
              + (" (the dense tier's size guard)" if guarded else ""),
              flush=True)
        if not guarded:
            failed.append(f"K={K} {method}")
    check(not failed, f"sweep cells failed: {failed}")
    check(sweep_launches["spmm_chunk"] > 0 and sweep_launches["spmm_csr"] > 0,
          "the sweep's pallas and tiled cells did not launch their kernels")
    record["sweep"] = {"spmm_row": sweep_row, "sddmm_row": sddmm_row,
                       "launches": sweep_launches,
                       "spmm_cells": {f"K={k}-{mt}": v for (k, mt), v in
                                      sweep_cells.items()},
                       "sddmm_cells": {f"K={k}-{mt}": v for (k, mt), v in
                                       sddmm_cells.items()}}

    phase("16 grouped-gather SpMM vs float64")

    def plan_stats(plan):
        """What a grouped plan's staging moves: chunks, NG, the mean groups
        and edges a chunk, the dedup factor, the B rows whole groups hold
        per edge (what PR 5's kernel and the JAX kernel staged) and the B
        rows the kernel stages per edge (those the edges reference)."""
        C = plan.num_chunks
        nnz = max(plan.nnz, 1)
        return {"chunks": C, "NG": plan.groups_per_chunk,
                "groups_a_chunk": plan.staged_rows / plan.group_rows / C,
                "edges_a_chunk": plan.nnz / C,
                "dedup_factor": plan.dedup_factor,
                "group_rows_per_edge": plan.staged_rows / nnz,
                "staged_rows_per_edge": plan.referenced_rows / nnz,
                "max_refs": plan.max_refs}

    def stats_line(st):
        return (f"{st['chunks']} chunks, NG {st['NG']}, "
                f"{st['groups_a_chunk']:.4f} groups and "
                f"{st['edges_a_chunk']:.4f} edges a chunk, dedup "
                f"{st['dedup_factor']:.4f}, B rows per edge "
                f"{st['group_rows_per_edge']:.4f} in whole groups, "
                f"{st['staged_rows_per_edge']:.4f} staged (referenced), at "
                f"most {st['max_refs']} a chunk")

    sbm_host = add_self_loops(ds.csr).to("cpu")
    sbm_rcm, sbm_perm = reorder(sbm_host)
    rmat_host = rmat.csr.to("cpu")
    grouped_compared, grouped_plans = [], []
    for graph, host_csr in (("sbm", sbm_host), ("sbm-rcm", sbm_rcm),
                            ("rmat15", rmat_host),
                            ("rmat15-rcm", reorder(rmat_host)[0])):
        a = Adjacency.from_csr(host_csr, device=dev)
        vals = torch.randn(a.nnz, device=dev, generator=gen)
        for sizes in GROUPED_SIZES:
            plan = build_grouped_plan(host_csr, *sizes).to(dev)
            st = plan_stats(plan)
            grouped_plans.append({"graph": graph, "sizes": list(sizes), **st})
            print(f"{graph} (R, E, NG, G)={sizes}: {stats_line(st)}",
                  flush=True)
            for K in GROUPED_KS:
                errs, all_ok, all_same = [], True, True
                for dtype in (torch.float32, torch.bfloat16):
                    for data in (None, vals):
                        B = torch.randn(a.shape[1], K, device=dev,
                                        generator=gen).to(dtype)
                        out = kgrp.spmm_grouped(plan, data, B, a.shape[0])
                        again = kgrp.spmm_grouped(plan, data, B, a.shape[0])
                        torch.cuda.synchronize()
                        err, ok = bound_check(torch, ref, out, a.csr.indptr,
                                              a.csr.indices, a.rows, data, B)
                        same = torch.equal(out, again)
                        label = (f"grouped {graph} {sizes} K={K} "
                                 f"{'binary' if data is None else 'valued'} "
                                 f"{str(dtype).split('.')[-1]}")
                        check(ok, f"grouped kernel disagrees: {label}")
                        check(same, f"grouped kernel not repeatable: {label}")
                        errs.append(err)
                        all_ok, all_same = all_ok and ok, all_same and same
                        grouped_compared.append({"case": label,
                                                 "max_abs_err": err})
                print(f"grouped {graph} {sizes} K={K}, binary/valued x "
                      f"f32/bf16: max_abs_err "
                      f"{' '.join(f'{e:.3e}' for e in errs)} "
                      f"{'ok' if all_ok else 'OUT OF BOUND'} | repeat "
                      f"{'bitwise' if all_same else 'DIFFERS'}", flush=True)
    record["grouped_vs_plain"] = grouped_compared
    record["grouped_plans"] = grouped_plans
    # The op on a grouped adjacency: the GCN slice's RCM graph, K=32.
    # "pallas" takes the grouped kernel, "auto" the CSR kernel (the rule
    # that phase 15 measures: PERF.md, PR 7).
    grp_adj = Adjacency.from_csr(sbm_rcm, device=dev, plan="grouped")
    grp_fwd_only = Adjacency.from_csr(sbm_rcm, device=dev, plan="grouped",
                                      plan_transpose=False)
    m_r, n_r = grp_adj.shape
    grp_op = {}
    for method in ("pallas", "auto"):
        d = grp_adj.data.clone().requires_grad_(True)
        B = torch.randn(n_r, 32, device=dev, generator=gen, requires_grad=True)
        g = torch.randn(m_r, 32, device=dev, generator=gen)
        reset_counts()
        out = spmm(grp_adj.with_data(d), B, method=method)
        out.backward(g)
        torch.cuda.synchronize()
        launched = counts()
        d64 = grp_adj.data.double().requires_grad_(True)
        B64 = B.detach().double().requires_grad_(True)
        out64 = spmm(grp_adj.with_data(d64), B64, method="xla")
        out64.backward(g.double())
        print(f"spmm(method={method!r}) on a grouped adjacency: launches "
              f"{launched}", flush=True)
        route = "spmm_grouped" if method == "pallas" else "spmm_csr"
        check(launched[route] == 2 and launched["spmm_chunk"] == 0
              and sum(v for k, v in launched.items()
                      if not k.startswith(route)) == 0,
              f"spmm(method={method!r}), grouped: expected 2 {route} launches "
              "(forward, grad_B) and no other")
        errs = {}
        for name, got, want, fwd in (("out", out, out64, True),
                                     ("grad_B", B.grad, B64.grad, False),
                                     ("grad_values", d.grad, d64.grad, False)):
            err = float((got.double() - want).abs().max())
            scale = float(want.abs().max())
            errs[name] = err
            print(f"grouped {method} {name}: max_abs_err={err:.3e} (max |ref| "
                  f"{scale:.3e})", flush=True)
            bound = 1e-5 * scale + 1e-6 if fwd else 1e-5 * max(scale, 1.0)
            check(bool(torch.isfinite(got).all()) and err <= bound,
                  f"spmm(method={method!r}) grouped {name} disagrees with "
                  "float64")
        grp_op[method] = {"launches": launched, "errors": errs}
    B = torch.randn(n_r, 32, device=dev, generator=gen, requires_grad=True)
    g = torch.randn(m_r, 32, device=dev, generator=gen)
    reset_counts()
    spmm(grp_fwd_only, B, method="pallas").backward(g)
    torch.cuda.synchronize()
    fwd_only_launches = counts()
    t = grp_fwd_only.transpose()
    want = spmm(t.with_data(t.data.double()), g.double(), method="xla")
    err = float((B.grad.double() - want).abs().max())
    print(f"grouped, plan_transpose=False: launches {fwd_only_launches}, "
          f"grad_B max_abs_err={err:.3e}", flush=True)
    check(fwd_only_launches["spmm_grouped"] == 1
          and fwd_only_launches["spmm_csr"] == 1
          and err <= 1e-5 * max(float(want.abs().max()), 1.0),
          "grouped without plan_t: expected the grouped kernel forward and "
          "the CSR kernel for grad_B")
    grp_op["no_plan_t_launches"] = fwd_only_launches
    record["grouped_op"] = grp_op
    # The auto rule (PERF.md, PR 7): the split CSR kernel on every graph,
    # with its carry where a row is longer than L (rmat15), without on
    # sbm-pubmed.
    auto_rule = {}
    route = "spmm_csr"
    for graph, a, K in (("rmat15", rmat, 128), ("rmat15", rmat, 32),
                        ("sbm+loops", adj, 128)):
        B = torch.randn(a.shape[1], K, device=dev, generator=gen,
                        requires_grad=True)
        g = torch.randn(a.shape[0], K, device=dev, generator=gen)
        reset_counts()
        out = spmm(a, B)
        out.backward(g)
        torch.cuda.synchronize()
        launched = counts()
        err, ok = bound_check(torch, ref, out.detach(), a.csr.indptr,
                              a.csr.indices, a.rows, a.data, B.detach())
        print(f"auto rule, {graph} K={K}: launches {launched} | max_abs_err "
              f"{err:.3e}", flush=True)
        check(ok and launched[route] == 2 and sum(
            v for k, v in launched.items() if not k.startswith(route)) == 0,
              f"auto rule at {graph} K={K}: expected 2 {route} launches "
              "(forward, grad_B) and no other kernel")
        auto_rule[f"{graph} K={K}"] = {"launches": launched, "max_abs_err": err}
    record["auto_rule"] = auto_rule

    phase(f"17 GCN train through the grouped kernel, dims {GCN_DIMS}, "
          f"RCM-reordered, {EPOCHS} epochs")
    perm_d = torch.from_numpy(sbm_perm).to(dev)
    inv_d = torch.from_numpy(inverse_permutation(sbm_perm)).to(dev)
    ds_rcm = GraphDataset(
        csr=sbm_rcm.to(dev), features=ds.features[perm_d],
        labels=ds.labels[perm_d],
        masks={k: v[perm_d] for k, v in ds.masks.items()},
        num_classes=ds.num_classes, name=f"{ds.name}-rcm")
    print(f"sbm-pubmed+loops, RCM: {stats_line(plan_stats(grp_adj.plan))}",
          flush=True)

    def make_gcn_grouped(method):
        return GCN(GCN_DIMS, dropout_rate=0.5, method=method,
                   generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev).with_norms(grp_adj)

    unpermuted = {}

    def same_as_original_order(model):
        """The trained parameters on the original order and phase 6's CSR
        route give the same logits, un-permuted."""
        orig = make_gcn("auto")
        orig.load_state_dict(model.state_dict())
        orig.eval()
        with torch.no_grad():
            got = model(grp_adj, ds_rcm.features)[inv_d]
            want = orig(adj, ds.features)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"GCN grouped logits, un-permuted, vs the original order: "
              f"max_abs_err={err:.3e} (max |ref| {scale:.3e})", flush=True)
        check(err <= 1e-4 * scale, "GCN grouped: un-permuted logits differ "
              "from the original order's")
        unpermuted.update(max_abs_err=err, max_ref=scale)

    gcn_grouped_runs = drive(
        "GCN grouped", make_gcn_grouped, grp_adj,
        GCN(GCN_DIMS, method="xla").double(), {"spmm_grouped": 4},
        methods=("pallas", "xla"), data=ds_rcm,
        absent=("spmm_csr", "spmm_chunk"), check_model=same_as_original_order)
    record["gcn_grouped"] = dict(gcn_grouped_runs,
                                 unpermuted_vs_original=unpermuted)

    phase("18 joint diag+halo SpMM (kernel row 7) vs float64")

    def csc_vals(vals, t_map):
        """Stacked edge values in each shard's CSC order."""
        if vals is None:
            return None
        idx = t_map.long()
        if vals.dim() == 3:
            idx = idx[..., None].expand(-1, -1, vals.shape[2])
        return torch.gather(vals, 1, idx)

    def row7_check(hp, B, halo, dvs, hvs, g, reduce):
        """Row 7 over all P shards, one launch with the partition's split,
        twice, and its backward (the sum: row 7 over the stacked transposes
        with their splits; max/min: row 3 over the same stacked transposes
        with their splits and the joint out and ties, twice): ({"fwd": err,
        "bwd": err}, ok, bitwise repeat), shard by shard against float64
        (max/min forward: the unsplit plain version exactly)."""
        P = hp.num_parts
        bf16 = B.dtype == torch.bfloat16
        args = (hp.diag_indptr, hp.diag_indices, dvs, B, hp.halo_indptr,
                hp.halo_indices, hvs, halo, reduce)
        out, ties = khalo.halo_spmm_stacked(*args, split=hp.joint_split)
        again, ties2 = khalo.halo_spmm_stacked(*args, split=hp.joint_split)
        grads_t, same = {}, True
        for blk, vals, table, split in (
                ("diag", dvs, B, hp.diag_t_split),
                ("halo", hvs, halo.reshape(-1, B.shape[1]), hp.halo_t_split)):
            t_args = (getattr(hp, f"{blk}_t_indptr"),
                      getattr(hp, f"{blk}_t_rows"),
                      csc_vals(vals, getattr(hp, f"{blk}_t_map")))
            if reduce == "sum":
                grads_t[blk] = khalo.halo_spmm_stacked(*t_args, g,
                                                       split=split)[0]
            else:  # row 3 over all P shards' transposes, one launch, twice
                grads_t[blk], twice = (
                    kmm.spmm_minmax_vjp_stacked(*t_args, table, out, g, ties,
                                                split=split)
                    for _ in range(2))
                same = same and all(
                    a is b or torch.equal(a, b)
                    for a, b in zip(grads_t[blk], twice))
        torch.cuda.synchronize()
        same = same and torch.equal(out, again) and (
            ties is None or torch.equal(ties, ties2))
        ok, fwd, bwd = True, 0.0, 0.0
        tol = 8e-3 if bf16 else 1e-5
        for p in range(P):
            blk = hp.blocks(p)
            dv = None if dvs is None else dvs[p, :hp.diag_nnz[p]]
            hv = None if hvs is None else hvs[p, :hp.halo_nnz[p]]
            Bs, rows = B[p * hp.cpp:(p + 1) * hp.cpp], slice(
                p * hp.rpp, (p + 1) * hp.rpp)
            out_p, g_p = out[rows], g[rows]
            tab = (blk.d_rows, blk.d_indices, blk.h_rows, blk.h_indices)
            f64 = [None if v is None else v.double() for v in (dv, hv)]
            if reduce == "sum":
                absv = [None if v is None else v.abs() for v in f64]
                exact, _ = ref.halo_spmm_rows(tab[0], tab[1], f64[0],
                                              Bs.double(), tab[2], tab[3],
                                              f64[1], halo[p].double(), hp.rpp)
                mag, _ = ref.halo_spmm_rows(tab[0], tab[1], absv[0],
                                            Bs.double().abs(), tab[2], tab[3],
                                            absv[1], halo[p].double().abs(),
                                            hp.rpp)
                bound = 8e-3 * mag if bf16 else 1e-5 * mag + 1e-6
                diff = (out_p.double() - exact).abs()
                ok = ok and bool((diff <= bound).all())
                fwd = max(fwd, float(diff.max()) if diff.numel() else 0.0)
            else:
                want, want_ties = ref.halo_spmm_rows(tab[0], tab[1], dv, Bs,
                                                     tab[2], tab[3], hv,
                                                     halo[p], hp.rpp, reduce)
                ok = ok and torch.equal(out_p, want) and torch.equal(
                    ties[rows], want_ties)
                fwd = max(fwd, float((out_p.double()
                                      - want.double()).abs().max()))
            for name, t_indptr, t_rows, t_map, v, table, n_t in (
                    ("diag", blk.d_t_indptr, blk.d_t_rows, blk.d_t_map, dv,
                     Bs, hp.cpp),
                    ("halo", blk.h_t_indptr, blk.h_t_rows, blk.h_t_map, hv,
                     halo[p], hp.halo_rows)):
                tv = None if v is None else v.index_select(0, t_map.long())
                cols = expand_indptr(t_indptr, t_rows.shape[0])
                if reduce == "sum":
                    got = grads_t[name][p * n_t:(p + 1) * n_t]
                    pairs = [(got, ref.halo_spmm_rows(
                        cols, t_rows, None if tv is None else tv.double(),
                        g_p.double(), None, None, None, None, n_t)[0])]
                else:
                    got = grads_t[name][0][p * n_t:(p + 1) * n_t]
                    gv = (None if grads_t[name][1] is None
                          else grads_t[name][1][p, :t_rows.shape[0]])
                    gt64 = g_p.double() / torch.clamp(ties[rows],
                                                      min=1.0).double()
                    want_B, want_v = ref.spmm_minmax_vjp_cols(
                        cols, t_rows, tv, table, out_p, gt64)
                    pairs = [(got, want_B)] + ([] if want_v is None
                                               else [(gv, want_v)])
                torch.cuda.synchronize()
                for got, want in pairs:
                    if not want.numel():
                        continue
                    e = float((got.double() - want).abs().max())
                    bwd = max(bwd, e)
                    ok = ok and bool(torch.isfinite(got).all()) and \
                        e <= tol * float(want.abs().max()) + 1e-6
        return {"fwd": fwd, "bwd": bwd}, ok, same

    def crossing_segments(hp):
        """Segments of the joint split that start in the diag block and
        end in the halo block (host count)."""
        sp = hp.joint_split.split
        d_deg = torch.diff(hp.diag_indptr.cpu().long()).reshape(-1)
        rows, start = sp.seg_row.cpu().long(), sp.seg_start.cpu().long()
        d_of = d_deg[rows]
        return int(((start < d_of) & (start + sp.seg_len > d_of)
                    & (d_of > 0)).sum())

    # The SBM graph with self-loops (the GCN's and the GAT's), without them
    # (the SAGE-pool's), rmat15 (hub rows: segments at the default L, many
    # across the diag/halo boundary), and the SBM graph split at L = 4 (every
    # row above 4 joint edges cut, most segments across the boundary); K=16
    # is the SAGE-pool's layer-1 max and the 2-head GAT's per-head aggregate.
    halo_graphs = (("sbm", sbm_host, SPLIT_LEN, HALO_KS),
                   ("sbm-noloops", ds.csr.to("cpu"), SPLIT_LEN, HALO_KS),
                   ("rmat15", rmat_host, SPLIT_LEN, HALO_KS),
                   ("sbm-L4", sbm_host, 4, (3, 32, 130)))
    halo_err, halo_compared, halo_layouts = 0.0, [], []
    for graph, host_csr, seg_len, ks in halo_graphs:
        vals = torch.randn(host_csr.nnz, device=dev, generator=gen)
        for P in HALO_PARTS:
            hp = build_halo_partition(host_csr, P, device=dev,
                                      seg_len=seg_len)
            mesh = make_mesh(P, device=dev)
            segs = {name: getattr(hp, f"{name}_split").split.num_segments
                    for name in ("joint", "diag_t", "halo_t")}
            crossing = crossing_segments(hp)
            layout = {"graph": graph, "P": P, "rounds": list(hp.rounds),
                      "halo_rows": hp.halo_rows, "rpp": hp.rpp, "cpp": hp.cpp,
                      "footprint_fraction": hp.footprint_fraction,
                      "diag_nnz": list(hp.diag_nnz),
                      "halo_nnz": list(hp.halo_nnz), "seg_len": seg_len,
                      "segments": segs, "crossing_segments": crossing}
            halo_layouts.append(layout)
            print(f"{graph} P={P}: rounds {hp.rounds}, halo rows "
                  f"{hp.halo_rows}, footprint {hp.footprint_fraction:.4f}, "
                  f"diag nnz {hp.diag_nnz}, halo nnz {hp.halo_nnz}, L "
                  f"{seg_len}: segments {segs}, {crossing} across the "
                  "diag/halo boundary", flush=True)
            if graph in ("rmat15", "sbm-L4"):
                check(segs["joint"] > 0 and crossing > 0,
                      f"{graph} P={P}: no segment across the boundary")
            dvs, hvs = split_edge_values(hp, vals)
            head_vals = {H: split_edge_values(hp, torch.randn(
                host_csr.nnz, H, device=dev, generator=gen))
                for H in HALO_HEADS}
            for K in ks:
                for dtype in (torch.float32, torch.bfloat16):
                    B = quantized((P * hp.cpp, K), dtype)
                    halo = make_exchange(hp, mesh)(B)
                    g = torch.randn(P * hp.rpp, K, device=dev,
                                    generator=gen).to(dtype)
                    variants = [(r, k, (None, None) if k == "binary"
                                 else (dvs, hvs))
                                for r in ("sum", "max", "min")
                                for k in ("binary", "valued")]
                    variants += [("sum", f"heads{H}", head_vals[H])
                                 for H in HALO_HEADS if K % H == 0]
                    label = f"row7 {graph} P={P} K={K} {str(dtype)[6:]}"
                    worst, all_ok, all_same = {}, True, True
                    for reduce, values, (dst, hst) in variants:
                        errs, ok, same = row7_check(hp, B, halo, dst, hst, g,
                                                    reduce)
                        check(ok, f"row 7 disagrees: {label} {reduce} "
                              f"{values}: {errs}")
                        check(same, f"row 7 not repeatable: {label} "
                              f"{reduce} {values}")
                        all_ok, all_same = all_ok and ok, all_same and same
                        worst[f"{reduce}-{values}"] = errs
                        halo_compared.append({"case": f"{label} {reduce} "
                                              f"{values}", **errs})
                    if (graph, P, K, dtype) == ("sbm", SHARDS, 32,
                                                torch.float32):
                        halo_err = worst["sum-valued"]["fwd"]
                    print(f"{label}: fwd/bwd max_abs_err " + " ".join(
                        f"{k}={v['fwd']:.2e}/{v['bwd']:.2e}"
                        for k, v in worst.items())
                        + f" {'ok' if all_ok else 'OUT OF BOUND'} | repeat "
                        f"{'bitwise' if all_same else 'DIFFERS'}", flush=True)
    record["row7_vs_plain"] = halo_compared
    record["halo_layouts"] = halo_layouts

    phase(f"19 halo_spmm on the card: P={SHARDS} shards in one process")
    hp4 = build_halo_partition(sbm_host, SHARDS, device=dev)
    mesh4 = make_mesh(SHARDS, device=dev)
    n_s = sbm_host.shape[0]
    adj64 = Adjacency.from_csr(sbm_host, device=dev)
    # Values and B in multiples of 1/4 and 1/2: products exact in f32 and
    # f64, so the float64 reference meets the same max/min ties.
    op_vals = torch.randint(1, 9, (sbm_host.nnz,), device=dev,
                            generator=gen) / 4.0
    op_B = quantized((SHARDS * hp4.cpp, 32), torch.float32)
    op_g = torch.randn(SHARDS * hp4.rpp, 32, device=dev, generator=gen)
    op_runs = {}
    for reduce in ("sum", "mean", "max", "min"):
        Bl = op_B.clone().requires_grad_(True)
        vl = op_vals.clone().requires_grad_(True)
        dv, hv = split_edge_values(hp4, vl)
        reset_counts()
        out = halo_spmm(hp4, Bl, mesh4, reduce=reduce, diag_vals=dv,
                        halo_vals=hv)
        torch.cuda.synchronize()
        fwd_launches = counts()
        out.backward(op_g)
        torch.cuda.synchronize()
        launched = counts()
        B64 = op_B[:n_s].double().requires_grad_(True)
        v64 = op_vals.double().requires_grad_(True)
        want = spmm(adj64.with_data(v64), B64, reduce=reduce, method="xla")
        want.backward(op_g[:n_s].double())
        errs = {}
        for name, got, w, fwd in (("out", out.detach()[:n_s], want.detach(),
                                   True),
                                  ("grad_B", Bl.grad[:n_s], B64.grad, False),
                                  ("grad_vals", vl.grad, v64.grad, False)):
            e = float((got.double() - w).abs().max())
            scale = float(w.abs().max())
            bound = 1e-5 * scale + 1e-6 if fwd else 1e-5 * max(scale, 1.0)
            errs[name] = e
            check(bool(torch.isfinite(got).all()) and e <= bound,
                  f"halo_spmm {reduce} {name} disagrees with float64: {e}")
        bwd_row7 = launched["halo_spmm"] - fwd_launches["halo_spmm"]
        others = {k: v for k, v in launched.items()
                  if v and k not in ("halo_spmm", "spmm_minmax_vjp")}
        print(f"halo_spmm {reduce}: launches forward {fwd_launches['halo_spmm']}"
              f" row 7, backward {bwd_row7} row 7 + "
              f"{launched['spmm_minmax_vjp']} row 3, carries "
              f"{launched['halo_spmm_carry']} | max_abs_err "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
        # One row-7 launch over the 4 shards forward; the sum backward is
        # row 7 over the stacked diag^T and halo^T blocks (2 launches), the
        # max/min backward row 3 over the same stacked blocks (2 launches).
        # No row or column of the SBM graph is above L: no carry.
        check(fwd_launches["halo_spmm"] == 1,
              f"halo_spmm {reduce}: expected 1 row-7 launch forward")
        want_bwd = ((2, 0) if reduce in ("sum", "mean") else (0, 2))
        check((bwd_row7, launched["spmm_minmax_vjp"]) == want_bwd,
              f"halo_spmm {reduce}: expected backward launches {want_bwd}")
        check(not others, f"halo_spmm {reduce} launched {others}")
        op_runs[reduce] = {"launches_forward": fwd_launches["halo_spmm"],
                           "launches_backward_row7": bwd_row7,
                           "launches_backward_row3":
                               launched["spmm_minmax_vjp"], "errors": errs}
    reset_counts()
    Bx = op_B.clone().requires_grad_(True)
    halo_spmm(hp4, Bx, mesh4, reduce="max", method="xla").sum().backward()
    torch.cuda.synchronize()
    xla_launches = counts()
    check(not any(xla_launches.values()),
          f"halo_spmm(method='xla') launched {xla_launches}")
    # The all-gather tier: each slab through ops/spmm.py (the CSR kernel).
    padj = partition_adjacency(sbm_host, SHARDS, device=dev)
    reset_counts()
    d_out = dist_spmm(padj, op_B[:n_s], mesh4)
    torch.cuda.synchronize()
    dist_launches = counts()
    d_want = spmm(adj64.with_data(adj64.data.double()), op_B[:n_s].double(),
                  method="xla")
    d_err = float((d_out[:n_s].double() - d_want).abs().max())
    print(f"dist_spmm: launches {dist_launches['spmm_csr']} CSR kernel, "
          f"max_abs_err {d_err:.3e}", flush=True)
    check(dist_launches["spmm_csr"] == SHARDS
          and d_err <= 1e-5 * float(d_want.abs().max()) + 1e-6,
          "dist_spmm: expected one CSR-kernel launch a slab, within bound")
    # One rank, one shard, through torch.distributed (NCCL).
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    group = maybe_distributed_init(f"tcp://localhost:{port}", 1, 0, "nccl")
    try:
        hp1 = build_halo_partition(sbm_host, 1, device=dev)
        B1 = op_B[:n_s].clone().requires_grad_(True)
        reset_counts()
        out_nccl = halo_spmm(hp1, B1, make_mesh(1, group=group, device=dev))
        out_nccl.backward(op_g[:n_s])
        torch.cuda.synchronize()
        nccl_launches = counts()["halo_spmm"]
        B1_one = op_B[:n_s].clone().requires_grad_(True)
        out_one = halo_spmm(hp1, B1_one, make_mesh(1, device=dev))
        out_one.backward(op_g[:n_s])
        same = (torch.equal(out_nccl, out_one)
                and torch.equal(B1.grad, B1_one.grad))
    finally:
        torch.distributed.destroy_process_group()
    print(f"NCCL world size 1: rounds {hp1.rounds} (one shard has no round, "
          f"so the exchange sends nothing over NCCL); row-7 launches "
          f"{nccl_launches}; equal to the one-process mesh: {same}",
          flush=True)
    check(hp1.rounds == () and nccl_launches == 3 and same,
          "the world-size-1 NCCL mesh differs from the one-process mesh")
    record["halo_op"] = {"runs": op_runs, "xla_launches": xla_launches,
                         "dist_spmm": {"launches": dist_launches,
                                       "max_abs_err": d_err},
                         "nccl_world1": {"rounds": list(hp1.rounds),
                                         "launches": nccl_launches,
                                         "equal_to_one_process": same}}

    phase(f"20 sharded training over P={SHARDS} shards")

    def sharded_train(build, host_csr, dims, epochs, lr, mesh=None, **kw):
        """Train through the sharded builder (on ``mesh``, by default the
        P=4 one); the run's record, the model and its inputs."""
        step, (model, opt), prepare, hp = build(
            host_csr, dims[0], dims[1], dims[2], mesh or mesh4, lr=lr, **kw)
        x, labels, mask = prepare(ds.features, ds.labels, ds.masks["train"])
        marks, losses = [], []
        reset_counts()
        for epoch in range(epochs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(model, opt, x, labels, mask)[2])
            stop.record()
            if epoch > 3:
                marks.append((start, stop))
        torch.cuda.synchronize()
        launched = counts()
        losses = torch.stack(losses).tolist()
        model.eval()
        with torch.no_grad():
            logits = model(x)
        train_acc = float(((logits.argmax(-1) == labels) & mask).sum()
                          / mask.sum())
        ms = mean([a.elapsed_time(b) for a, b in marks])
        return {"loss_first": losses[0], "loss_last": losses[-1],
                "train_acc": train_acc, "ms_per_epoch_runs": [ms],
                "launches": launched}, model, x, logits, losses

    def sharded_checks(name, run, losses, epochs, per_epoch):
        print(f"sharded {name}: loss {run['loss_first']:.4f} -> "
              f"{run['loss_last']:.4f} | train acc {run['train_acc']:.4f} | "
              f"{run['ms_per_epoch_runs'][0]:.4f} ms/epoch | launches "
              f"{run['launches']}", flush=True)
        check(finite_list(losses) and losses[-1] < losses[0],
              f"sharded {name}: loss did not fall")
        check(run["train_acc"] > 1 / 3, f"sharded {name}: accuracy at chance")
        # One row-7 launch an aggregation over the 4 shards, two for a sum
        # aggregation's backward; no row above L on the SBM graph, so no
        # carry.
        check(run["launches"]["halo_spmm"] == per_epoch * epochs
              and run["launches"]["halo_spmm_carry"] == 0,
              f"sharded {name}: {run['launches']['halo_spmm']} row-7 "
              f"launches in {epochs} epochs, expected {per_epoch} an epoch "
              "and no carry")

    sharded = {}
    gcn_s, gcn_model, gcn_x, gcn_logits, losses = sharded_train(
        build_sharded_gcn, sbm_host, GCN_DIMS, EPOCHS, 1e-2)
    # Row 7: 2 aggregations forward, 2 x 2 backward.
    sharded_checks("GCN", gcn_s, losses, EPOCHS, 6)
    check(not any(v for k, v in gcn_s["launches"].items()
                  if k not in ("halo_spmm", "halo_spmm_carry")),
          f"sharded GCN launched another kernel: {gcn_s['launches']}")
    cpu_mesh = make_mesh(SHARDS, device="cpu")

    def vs_float64(name, run, model, x, logits, cpu_model):
        """Hold the trained model's card logits to the same sharded module's
        float64 forward on the CPU (row 7's and the edge ops' plain
        versions) from the same parameters."""
        cpu_model = cpu_model.double()
        cpu_model.load_state_dict({k: v.cpu().double() for k, v in
                                   model.state_dict().items()})
        with torch.no_grad():
            want = cpu_model(x.cpu().double())
        err = float((logits.cpu().double() - want).abs().max())
        scale = float(want.abs().max())
        print(f"sharded {name} logits vs float64 CPU forward: max_abs_err "
              f"{err:.3e} (max |ref| {scale:.3e})", flush=True)
        check(err <= 1e-4 * scale,
              f"sharded {name} logits disagree with float64")
        run["logits_vs_float64"] = {"max_abs_err": err, "max_ref": scale}

    # The GCN's float64 forward takes the "xla" tier (no tiled=True), an
    # implementation apart from row 7's plain version.
    vs_float64("GCN", gcn_s, gcn_model, gcn_x, gcn_logits, ShardedGCN(
        build_halo_partition(sbm_host, SHARDS), cpu_mesh, *GCN_DIMS))
    sharded["gcn"] = gcn_s
    sage_host = ds.csr.to("cpu")
    sage_s, sage_model, sage_x, sage_logits, losses = sharded_train(
        build_sharded_sage, sage_host, SAGE_DIMS, SHARDED_EPOCHS, 1e-2,
        aggregator="pool")
    # Row 7: 2 max aggregations forward; their backward is row 3, one
    # launch a layer and transposed block (diag^T, halo^T) over the 4
    # shards, no carry (no column of the blocks above L).
    sharded_checks("SAGE-pool", sage_s, losses, SHARDED_EPOCHS, 2)
    check(sage_s["launches"]["spmm_minmax_vjp"] == 4 * SHARDED_EPOCHS
          and sage_s["launches"]["spmm_minmax_vjp_carry"] == 0,
          f"sharded SAGE-pool: {sage_s['launches']['spmm_minmax_vjp']} row-3 "
          f"launches and {sage_s['launches']['spmm_minmax_vjp_carry']} "
          f"carries in {SHARDED_EPOCHS} epochs, expected 4 an epoch and none")
    vs_float64("SAGE-pool", sage_s, sage_model, sage_x, sage_logits,
               ShardedSAGE(build_halo_partition(sage_host, SHARDS), cpu_mesh,
                           *SAGE_DIMS, "pool"))
    sharded["sage_pool"] = sage_s
    gat_s, gat_model, gat_x, gat_logits, losses = sharded_train(
        build_sharded_gat, sbm_host, SHARDED_GAT_DIMS, SHARDED_EPOCHS, GAT_LR,
        heads=SHARDED_GAT_HEADS)
    # Row 7: the per-head aggregation and the mean, forward and backward.
    sharded_checks(f"GAT heads={SHARDED_GAT_HEADS}", gat_s, losses,
                   SHARDED_EPOCHS, 6)
    # Per-head values need the tiled tier: on the CPU, row 7's plain version.
    vs_float64(f"GAT heads={SHARDED_GAT_HEADS}", gat_s, gat_model, gat_x,
               gat_logits, ShardedGAT(
                   build_halo_partition(sbm_host, SHARDS, tiled=True),
                   cpu_mesh, *SHARDED_GAT_DIMS, SHARDED_GAT_HEADS))
    sharded["gat"] = gat_s
    sharded["dryrun_multichip_8"] = dryrun_multichip(8, device=dev)
    record["sharded"] = sharded

    phase("21 interop: AdjacencyMatrix and torch.sparse on the card")
    A = AdjacencyMatrix(adj)
    m_, n_ = A.shape
    x = torch.randn(n_, INTEROP_K, device=dev, generator=gen)
    y = torch.randn(INTEROP_K, m_, device=dev, generator=gen)
    xt = torch.randn(m_, INTEROP_K, device=dev, generator=gen)
    v = torch.randn(n_, device=dev, generator=gen)
    sparse_mm = torch.sparse.mm
    sparse_mm_calls = []

    def counting_sparse_mm(*a, **kw):
        sparse_mm_calls.append(1)
        return sparse_mm(*a, **kw)

    d = adj.data.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    g = torch.randn(m_, INTEROP_K, device=dev, generator=gen)
    torch.sparse.mm = counting_sparse_mm
    try:
        reset_counts()
        products = {"A @ x": A @ x, "x @ A": y @ A, "A.T @ x": A.T @ xt,
                    "A @ v": A @ v}
        (A.with_data(d) @ xg).backward(g)
        torch.cuda.synchronize()
        interop_launches = counts()
    finally:
        torch.sparse.mm = sparse_mm
    interop = {"launches": interop_launches,
               "sparse_mm_calls": len(sparse_mm_calls)}
    csc = (adj.csc.indptr, adj.csc.indices, adj.rows_t, adj.csc.data)
    csr_ = (adj.csr.indptr, adj.csr.indices, adj.rows, adj.data)
    for name, out, operands, B_, transpose in (
            ("A @ x", products["A @ x"], csr_, x, False),
            ("x @ A", products["x @ A"], csc, y.t(), True),
            ("A.T @ x", products["A.T @ x"], csc, xt, False),
            ("A @ v", products["A @ v"][:, None], csr_, v[:, None], False)):
        out = out.t() if transpose else out
        err, ok = bound_check(torch, ref, out, *operands, B_)
        print(f"{name}: shape {tuple(out.shape)} max_abs_err={err:.3e} "
              f"within the sum kernel's bound: {ok}", flush=True)
        check(ok, f"interop {name} outside the sum kernel's float64 bound")
        interop[name] = err
    d64 = adj.data.double().requires_grad_(True)
    x64 = x.double().requires_grad_(True)
    spmm(adj.with_data(d64), x64, method="xla").backward(g.double())
    for name, got, want in (("grad_x", xg.grad, x64.grad),
                            ("grad_values", d.grad, d64.grad)):
        err = float((got.double() - want).abs().max())
        scale = float(want.abs().max())
        print(f"A @ x {name}: max_abs_err={err:.3e} (max |ref| {scale:.3e})",
              flush=True)
        check(bool(torch.isfinite(got).all()) and err <= 1e-5 * max(scale, 1.0),
              f"interop {name} disagrees with float64")
        interop[name] = err
    # A @ x, x @ A, A.T @ x, A @ v and A @ x with values: one row-1 launch
    # each, and its grad_B one more; no row of sbm above L, so no carry.
    print(f"interop launches: {interop_launches}; torch.sparse.mm calls "
          f"{len(sparse_mm_calls)}", flush=True)
    check(interop_launches["spmm_csr"] == 6
          and not any(c for k, c in interop_launches.items()
                      if k != "spmm_csr"),
          f"interop: launches {interop_launches}, expected 6 of spmm_csr")
    check(not sparse_mm_calls, "interop: AdjacencyMatrix called torch.sparse.mm")
    back = csr_from_torch_sparse(csr_to_torch_sparse(adj.csr))
    same = (back.shape == adj.shape and back.indices.device.type == "cuda"
            and torch.equal(back.indptr, adj.csr.indptr)
            and torch.equal(back.indices, adj.csr.indices)
            and torch.equal(back.data, adj.data))
    print(f"csr_from_torch_sparse(csr_to_torch_sparse(csr)) == csr on the "
          f"card: {same}", flush=True)
    check(same, "interop: the torch.sparse round trip changed the CSR")
    interop["round_trip_equal"] = same
    record["interop"] = interop

    phase(f"22 stock baselines against ours, {BASELINE_EPOCHS} epochs each")
    baselines = {}
    for name, ours_make, stock_make, a, lr in (
            ("GCN", make_gcn,
             lambda: GCNBcoo(GCN_DIMS, generator=torch.Generator(
                 device=dev).manual_seed(SEED), device=dev),
             adj, 1e-2),
            ("SAGE-mean", lambda m: make_sage(m, "mean"),
             lambda: SAGEStock(SAGE_DIMS, "mean", generator=torch.Generator(
                 device=dev).manual_seed(SEED), device=dev),
             sage_adj, 1e-2),
            ("SAGE-pool", make_sage,
             lambda: SAGEStock(SAGE_DIMS, "pool", generator=torch.Generator(
                 device=dev).manual_seed(SEED), device=dev),
             sage_adj, 1e-2),
            ("GAT", make_gat,
             lambda: GATStock(GAT_DIMS, generator=torch.Generator(
                 device=dev).manual_seed(SEED), device=dev),
             adj, GAT_LR)):
        stock = stock_make()
        operand = (SAGEStock.from_adjacency(a, stock.aggregator)
                   if isinstance(stock, SAGEStock)
                   else type(stock).from_adjacency(a))
        # The same function: the stock model at ours' parameters, no
        # dropout.
        ours = ours_make("auto").eval()
        stock.load_state_dict(ours.state_dict())
        stock.eval()
        with torch.no_grad():
            want, got = ours(a, ds.features), stock(operand, ds.features)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"{name} stock vs ours at the same parameters: max_abs_err="
              f"{err:.3e} (max |ref| {scale:.3e})", flush=True)
        check(tuple(got.shape) == tuple(want.shape)
              and bool(torch.isfinite(got).all())
              and err <= 1e-5 * scale + 1e-6,
              f"{name}: the stock model's logits differ from ours")
        row = {"logits_max_abs_err": err, "max_ref": scale,
               "ours_ms_per_epoch": [], "stock_ms_per_epoch": [],
               "ours_peak_mb": [], "stock_peak_mb": []}
        for impl in ("ours", "stock", "stock", "ours"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if impl == "ours":
                model, res, launched = train(ours_make, a, "auto",
                                             BASELINE_EPOCHS, lr)
            else:
                model = stock_make()
                reset_counts()
                res = train_node_classifier(
                    model, operand, ds.features, ds.labels, ds.masks,
                    seed=SEED, epochs=BASELINE_EPOCHS, lr=lr)
                torch.cuda.synchronize()
                launched = counts()
                check(not any(launched.values()),
                      f"{name} stock launched a kernel of the port: "
                      f"{launched}")
            loss = res["history"]["loss"]
            check(finite_list(loss) and loss[-1] < loss[0],
                  f"{name} {impl}: loss did not fall")
            check(res["train_acc"] > 1 / 3,
                  f"{name} {impl}: train accuracy at chance")
            row[f"{impl}_ms_per_epoch"].append(res["mean_epoch_time"] * 1e3)
            row[f"{impl}_peak_mb"].append(
                (torch.cuda.max_memory_allocated() - base) / 2**20)
            row[f"{impl}_loss"] = [loss[0], loss[-1]]
            row[f"{impl}_train_acc"] = res["train_acc"]
        for impl in ("ours", "stock"):
            ms = row[f"{impl}_ms_per_epoch"]
            print(f"{name} {impl}: loss {row[impl + '_loss'][0]:.4f} -> "
                  f"{row[impl + '_loss'][1]:.4f} | train acc "
                  f"{row[impl + '_train_acc']:.4f} | {mean(ms):.4f} ms/epoch "
                  f"(runs {', '.join(f'{t:.4f}' for t in ms)}) | peak "
                  f"{max(row[impl + '_peak_mb']):.1f} MB above the run's "
                  f"start | {card}", flush=True)
        # torch.sparse.mm over a matrix of alpha would form its gradient
        # as a dense n x n matrix; the stock GAT's must stay sparse.
        n = a.shape[0]
        check(name != "GAT" or max(row["stock_peak_mb"]) * 2**20
              <= n * n * 4 / 4,
              f"{name} stock: peak memory {max(row['stock_peak_mb']):.1f} MB "
              f"reaches a quarter of a dense {n} x {n} f32 matrix")
        baselines[name] = row
    record["baselines"] = baselines

    phase(f"23 SAGE-LSTM train, dims {SAGE_DIMS}, max_neighbors "
          f"{LSTM_NEIGHBORS}, {BASELINE_EPOCHS} epochs")
    table = build_neighbor_table(ds.csr, max_neighbors=LSTM_NEIGHBORS)
    lstm_model, res, launched = train(
        lambda m: make_sage(m, "lstm", table), sage_adj, "auto",
        BASELINE_EPOCHS)
    loss = res["history"]["loss"]
    print(f"SAGE-LSTM: loss {loss[0]:.4f} -> {loss[-1]:.4f} | train/val/test "
          f"acc {res['train_acc']:.4f}/{res['val_acc']:.4f}/"
          f"{res['test_acc']:.4f} | {res['mean_epoch_time'] * 1e3:.4f} "
          f"ms/epoch | {card}", flush=True)
    check(finite_list(loss) and loss[-1] < loss[0], "SAGE-LSTM: loss did not "
          "fall")
    check(res["train_acc"] > 1 / 3, "SAGE-LSTM: train accuracy at chance")
    lstm_model.eval()
    cpu_lstm = GraphSAGE(SAGE_DIMS, aggregator="lstm",
                         neighbor_table=tuple(t.cpu() for t in table)).double()
    cpu_lstm.load_state_dict({k: v.cpu().double() for k, v in
                              lstm_model.state_dict().items()})
    with torch.no_grad():
        logits = lstm_model(sage_adj, ds.features)
        want = cpu_lstm.eval()(Adjacency.from_csr(ds.csr.to("cpu")),
                               ds.features.cpu().double())
    err = float((logits.cpu().double() - want).abs().max())
    scale = float(want.abs().max())
    print(f"SAGE-LSTM logits vs float64 CPU forward: max_abs_err={err:.3e} "
          f"(max |ref| {scale:.3e})", flush=True)
    check(err <= 1e-4 * scale, "SAGE-LSTM: logits disagree with float64")
    record["sage_lstm"] = {"loss_first": loss[0], "loss_last": loss[-1],
                           "train_acc": res["train_acc"],
                           "test_acc": res["test_acc"],
                           "ms_per_epoch": res["mean_epoch_time"] * 1e3,
                           "logits_max_abs_err": err, "max_ref": scale}

    phase(f"24 GAT train with method='pallas' over a plan='perrow' adjacency, "
          f"dims {GAT_DIMS}, {BASELINE_EPOCHS} epochs")
    perrow_adj = Adjacency.from_csr(add_self_loops(ds.csr), plan="perrow")
    # An epoch, two layers: forward 2 segment reduces (the softmax's max
    # and sum) and 1 chunk launch a layer; backward 3 segment sums (the
    # softmax's, the logits' over the CSR and over the CSC) and 1 chunk
    # launch (grad_B over the transposed plan) a layer.  The final
    # evaluation's forward adds 2 and 1 a layer.
    per_epoch = {"edge_segment_reduce": 10, "spmm_chunk": 4}
    gat_pallas = drive(
        "GAT pallas", make_gat, perrow_adj,
        GAT(GAT_DIMS, method="xla").double(), per_epoch,
        methods=("pallas",), epochs=BASELINE_EPOCHS, lr=GAT_LR,
        absent=("gat_fwd", "gat_bwd_rows", "gat_bwd_cols", "spmm_csr",
                "edge_segment_reduce_carry"))["pallas"]
    got = gat_pallas["launches"]
    want = {"edge_segment_reduce": 10 * BASELINE_EPOCHS + 4,
            "spmm_chunk": 4 * BASELINE_EPOCHS + 2}
    print(f"GAT pallas: launches {got}; expected {want}", flush=True)
    check(all(got[k] == v for k, v in want.items()),
          f"GAT pallas: launches {got}, expected {want}")
    record["gat_pallas"] = gat_pallas

    phase(f"25 checkpoint: GCN {CKPT_EPOCHS} epochs straight against "
          f"{CKPT_EPOCHS // 2}, a checkpoint, a fresh model and "
          f"{CKPT_EPOCHS // 2} more")
    straight = make_gcn("auto")
    train_node_classifier(straight, adj, ds.features, ds.labels, ds.masks,
                          seed=SEED, epochs=CKPT_EPOCHS)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as ckpt_dir:
        half = CKPT_EPOCHS // 2
        train_node_classifier(make_gcn("auto"), adj, ds.features, ds.labels,
                              ds.masks, seed=SEED, epochs=half,
                              checkpoint_dir=ckpt_dir, checkpoint_every=half)
        saved = sorted(os.listdir(ckpt_dir))
        resumed = make_gcn("auto")
        res = train_node_classifier(
            resumed, adj, ds.features, ds.labels, ds.masks, seed=SEED,
            epochs=CKPT_EPOCHS, checkpoint_dir=ckpt_dir,
            checkpoint_every=half)
    torch.cuda.synchronize()
    check(len(res["history"]["loss"]) == CKPT_EPOCHS - half,
          f"checkpoint: the resumed run took {len(res['history']['loss'])} "
          f"epochs, expected {CKPT_EPOCHS - half}")
    ckpt = {"files": saved, "bitwise": True, "max_abs_err": 0.0}
    for k, want in straight.state_dict().items():
        got = resumed.state_dict()[k]
        err = float((got.double() - want.double()).abs().max())
        scale = float(want.abs().max())
        ckpt["bitwise"] &= bool(torch.equal(got, want))
        ckpt["max_abs_err"] = max(ckpt["max_abs_err"], err)
        check(err <= 1e-6 * scale, f"checkpoint: {k} of the resumed run "
              f"differs from the straight run by {err:.3e}")
    print(f"checkpoint files {saved}; resumed parameters vs the straight run: "
          f"max_abs_err={ckpt['max_abs_err']:.3e}, bitwise "
          f"{ckpt['bitwise']}", flush=True)
    record["checkpoint"] = ckpt

    phase("26 native graph IO: the port's library from native/graphio.cpp")
    check(native.available(), f"the native library is unavailable: "
          f"{native.error()}")
    lib_path = native.library_path()
    check(lib_path.parent == _build.BUILD_DIR and lib_path.exists(),
          f"the native library is not under _build/: {lib_path}")
    print(f"g++ {' '.join(native.CXX_FLAGS)} -> "
          f"{os.path.relpath(lib_path, HERE)}", flush=True)
    host_s = {}

    def host_time(name, fn):
        t0 = time.perf_counter()
        out = fn()
        host_s[name] = time.perf_counter() - t0
        return out

    mtx_csr = rmat_host
    mtx_rows = np.repeat(np.arange(mtx_csr.shape[0], dtype=np.int32),
                         np.diff(mtx_csr.indptr.numpy()))
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as mtx_dir:
        mtx_path = os.path.join(mtx_dir, "rmat15.mtx")
        host_time("write_mtx", lambda: write_mtx(
            mtx_path, mtx_rows, mtx_csr.indices.numpy(), None,
            mtx_csr.shape))
        coo_nat = host_time("read_mtx native", lambda: read_mtx(
            mtx_path, use_native=True))
        coo_py = host_time("read_mtx numpy", lambda: read_mtx(
            mtx_path, use_native=False))
    same_mtx = coo_nat.shape == coo_py.shape == tuple(mtx_csr.shape) and all(
        torch.equal(getattr(coo_nat, f), getattr(coo_py, f))
        for f in ("row", "col", "data"))
    same_mtx = same_mtx and torch.equal(coo_nat.col, mtx_csr.indices.cpu())
    adj_nat = host_time("Adjacency.from_csr native", lambda: Adjacency.from_csr(
        mtx_csr, device=dev, use_native=True))
    adj_py = host_time("Adjacency.from_csr numpy", lambda: Adjacency.from_csr(
        mtx_csr, device=dev, use_native=False))
    same_csc = all(torch.equal(getattr(adj_nat.csc, f), getattr(adj_py.csc, f))
                   for f in ("indptr", "indices")) and all(
        torch.equal(getattr(adj_nat, f), getattr(adj_py, f))
        for f in ("perm", "inv_perm", "rows_t"))
    rmat17 = rmat_graph(DIST_SCALE + 2, edge_factor=DIST_EDGE_FACTOR, seed=SEED)
    lab_nat = host_time("fennel rmat17 P=4 native", lambda: fennel_partition(
        rmat17, 4, use_native=True))
    lab_py = host_time("fennel rmat17 P=4 numpy loop", lambda: fennel_partition(
        rmat17, 4, use_native=False))
    rows17 = np.repeat(np.arange(rmat17.shape[0]),
                       np.diff(rmat17.indptr.numpy()))
    cut = {name: float((lab[rows17] != lab[rmat17.indices.numpy()]).mean())
           for name, lab in (("native", lab_nat), ("numpy", lab_py))}
    host_time("partition_order fennel rmat17 P=4", lambda: partition_order(
        rmat17, 4, method="fennel"))
    # The balancing pass, by difference of two host timings (noisy).
    host_s["balancing pass by difference"] = (
        host_s["partition_order fennel rmat17 P=4"]
        - host_s["fennel rmat17 P=4 native"])
    print(f".mtx of rmat15 ({coo_py.row.shape[0]} entries) read back equal "
          f"through native and NumPy: {same_mtx}; Adjacency.from_csr's CSC "
          f"equal both ways: {same_csc}; Fennel rmat17 P=4 edge cut native "
          f"{cut['native']:.4f}, NumPy loop {cut['numpy']:.4f} | host s "
          + " ".join(f"{k}={v:.4f}" for k, v in host_s.items()), flush=True)
    check(same_mtx, "the native .mtx reader differs from the NumPy one")
    check(same_csc, "the native CSC transform differs from the NumPy one")
    check(all(np.bincount(lab, minlength=4).size == 4
              for lab in (lab_nat, lab_py)), "Fennel labels out of range")
    record["native"] = {"library": os.path.relpath(lib_path, HERE),
                        "host_s": host_s, "fennel_edge_cut": cut,
                        "mtx_equal": same_mtx, "csc_equal": same_csc}

    phase(f"27 partition and weak scaling: dist_bench on rmat{DIST_SCALE} "
          f"+ log2 P, K={DIST_K}, P in {list(DIST_DEVICES)}")
    weak, weak_launches = {}, {}
    for method, partition in (("halo-tiled", "auto"), ("allgather", "none")):
        reset_counts()
        weak[method] = bench_weak_scaling(
            list(DIST_DEVICES), DIST_SCALE, DIST_K, DIST_EDGE_FACTOR,
            method=method, partition=partition, device=dev)
        torch.cuda.synchronize()
        weak_launches[method] = counts()
        print(f"dist_bench {method} launches: "
              f"{ {k: v for k, v in weak_launches[method].items() if v} } | "
              f"{card}", flush=True)
    last = weak["halo-tiled"][-1]
    check((last["nodes"], last["nnz"]) == (rmat17.shape[0], rmat17.nnz),
          f"dist_bench's P=4 graph is not rmat17: {last}")
    check(weak_launches["halo-tiled"]["halo_spmm"] > 0
          and not weak_launches["halo-tiled"]["spmm_csr"],
          "dist_bench halo-tiled did not run on row 7 alone")
    check(weak_launches["allgather"]["spmm_csr"] > 0
          and not weak_launches["allgather"]["halo_spmm"],
          "dist_bench allgather did not run on row 1 alone")
    for rows in weak.values():
        check(all(r["ms"] > 0 and r["nnz_per_s"] > 0 for r in rows),
              "dist_bench: a row without a time")
    # The P=4 rmat17 partitioned by "auto", and row 7 on it against float64.
    perm17 = host_time("partition_order auto rmat17 P=4", lambda:
                       partition_order(rmat17, 4, method="auto"))
    part17 = apply_permutation(rmat17, perm17)
    need = {name: halo_need_stats(c, 4) for name, c in (("none", rmat17),
                                                        ("auto", part17))}
    hp17 = {name: build_halo_partition(c, 4, device=dev)
            for name, c in (("none", rmat17), ("auto", part17))}
    footprints = {name: {"padded": need[name]["footprint_frac"],
                         "ragged": need[name]["ragged_frac"],
                         "halo_rows": hp17[name].halo_rows,
                         "exchange": hp17[name].footprint_fraction}
                  for name in need}
    print("rmat17 P=4 footprints (padded all-to-all, ragged, the partition's "
          "halo exchange): " + "; ".join(
              f"{k} {v['padded']:.4f} / {v['ragged']:.4f} / "
              f"{v['exchange']:.4f} ({v['halo_rows']} halo rows a shard)"
              for k, v in footprints.items())
          + f" | partition_order auto {host_s['partition_order auto rmat17 P=4']:.4f}"
          " host s", flush=True)
    check(footprints["auto"]["padded"] <= footprints["none"]["padded"],
          "partition 'auto' made the padded footprint larger than 'none'")
    hp_a = hp17["auto"]
    n17 = part17.shape[0]

    def float64_err(csr, out, B):
        """max |out - A @ B| against float64, and whether every entry lies
        within 1e-5 * (|A| @ |B|) + 1e-6."""
        a64 = Adjacency.from_csr(csr, device=dev)
        a64 = a64.with_data(torch.ones(a64.nnz, device=dev,
                                       dtype=torch.float64))
        diff = (out[:n17].double()
                - spmm(a64, B[:n17].double(), method="xla")).abs()
        mag = spmm(a64, B[:n17].double().abs(), method="xla")
        return float(diff.max()), bool((diff <= 1e-5 * mag + 1e-6).all())

    B17 = torch.randn(4 * hp_a.cpp, DIST_K, device=dev, generator=gen)
    reset_counts()
    out17 = halo_spmm(hp_a, B17, make_mesh(4, device=dev), model_axis=None)
    torch.cuda.synchronize()
    launches17 = counts()
    err17, ok17 = float64_err(part17, out17, B17)
    print(f"halo_spmm rmat17 P=4 ('auto' order) K={DIST_K}: row-7 launches "
          f"{launches17['halo_spmm']} (+{launches17['halo_spmm_carry']} "
          f"carry), max_abs_err {err17:.3e} against float64", flush=True)
    check(ok17, "halo_spmm on rmat17 disagrees with float64")
    check(launches17["halo_spmm"] == 1, "halo_spmm rmat17: expected one "
          "row-7 launch over the 4 shards")
    # The allgather path's shape: row 1 on rmat17's four (rpp, n) slabs.
    padj17 = partition_adjacency(rmat17, 4, device=dev)
    Bg17 = torch.randn(n17, DIST_K, device=dev, generator=gen)
    reset_counts()
    outg17 = dist_spmm(padj17, Bg17, make_mesh(4, device=dev),
                       model_axis=None)
    torch.cuda.synchronize()
    launchesg17 = counts()
    errg17, okg17 = float64_err(rmat17, outg17, Bg17)
    print(f"dist_spmm rmat17 P=4 K={DIST_K}: row-1 launches "
          f"{launchesg17['spmm_csr']} (+{launchesg17['spmm_csr_carry']} "
          f"carry), max_abs_err {errg17:.3e} against float64", flush=True)
    check(okg17, "dist_spmm on rmat17 disagrees with float64")
    check(launchesg17["spmm_csr"] == 4 and not launchesg17["halo_spmm"],
          "dist_spmm rmat17: expected one row-1 launch a slab")
    # Where the op's time goes at P=4: the exchange (one index_select) and
    # the op as a whole; row 7 alone is timed in phase 15.
    exchange17 = make_exchange(hp_a, make_mesh(4, device=dev))
    split17 = {"exchange_ms": timing.device_time(lambda: exchange17(B17))
               * 1e3,
               "op_ms": timing.device_time(lambda: halo_spmm(
                   hp_a, B17, make_mesh(4, device=dev), model_axis=None))
               * 1e3}
    print(f"halo_spmm rmat17 P=4 K={DIST_K} device ms: the op "
          f"{split17['op_ms']:.5f}, its exchange alone "
          f"{split17['exchange_ms']:.5f} (B {B17.numel() * 4 / 1e6:.1f} MB, "
          f"halo tables {4 * hp_a.halo_rows * DIST_K * 4 / 1e6:.1f} MB) | "
          f"{card}", flush=True)
    record["weak_scaling"] = {"rows": weak, "launches": weak_launches,
                              "footprints_rmat17_P4": footprints,
                              "rmat17_row7": {"launches": launches17,
                                              "max_abs_err": err17,
                                              **split17},
                              "rmat17_row1_slabs": {"launches": launchesg17,
                                                    "max_abs_err": errg17}}

    phase("28 the model axis on the card: (data, model) = (2, 2) in one "
          "process")
    mesh21 = make_mesh(2, device=dev)
    mesh22 = make_mesh(2, 2, device=dev)
    hp2 = build_halo_partition(sbm_host, 2, device=dev)
    B2 = quantized((2 * hp2.cpp, 32), torch.float32)
    g2 = torch.randn(2 * hp2.rpp, 32, device=dev, generator=gen)
    axis_runs = {}
    for name, mesh in (("(2, 1)", mesh21), ("(2, 2)", mesh22)):
        Bm = B2.clone().requires_grad_(True)
        reset_counts()
        out = halo_spmm(hp2, Bm, mesh)
        out.backward(g2)
        torch.cuda.synchronize()
        axis_runs[name] = (out.detach(), Bm.grad, counts()["halo_spmm"])
    (o1, gb1, l1), (o2, gb2, l2) = axis_runs["(2, 1)"], axis_runs["(2, 2)"]
    axis_err = {"out": float((o2 - o1).abs().max()),
                "grad_B": float((gb2 - gb1).abs().max())}
    print(f"halo_spmm sbm K=32 on (2, 2) against (2, 1): max_abs_err "
          f"{axis_err}, bitwise {torch.equal(o2, o1)}/{torch.equal(gb2, gb1)};"
          f" row-7 launches {l2} against {l1}", flush=True)
    check(axis_err["out"] <= 1e-5 * float(o1.abs().max())
          and axis_err["grad_B"] <= 1e-5 * float(gb1.abs().max()),
          "halo_spmm on (2, 2) disagrees with (2, 1)")
    check((l1, l2) == (3, 6), f"halo_spmm: expected 3 row-7 launches on "
          f"(2, 1) and 6 on (2, 2), got {l1} and {l2}")
    model_axis = {}
    for name, mesh in (("(2, 1)", mesh21), ("(2, 2)", mesh22),
                       ("(2, 2) again", mesh22), ("(2, 1) again", mesh21)):
        run, mmodel, mx, mlogits, losses = sharded_train(
            build_sharded_gcn, sbm_host, GCN_DIMS, SHARDED_EPOCHS, 1e-2,
            mesh=mesh)
        check(finite_list(losses) and losses[-1] < losses[0],
              f"sharded GCN on {name}: loss did not fall")
        per_epoch = run["launches"]["halo_spmm"] / SHARDED_EPOCHS
        model_axis.setdefault(name.split(" again")[0], []).append(
            {"ms_per_epoch": run["ms_per_epoch_runs"][0],
             "row7_per_epoch": per_epoch, "loss_first": run["loss_first"],
             "loss_last": run["loss_last"], "launches": run["launches"]})
        if name == "(2, 2)":
            # The (2, 1) module from the trained (2, 2) parameters.
            twin = ShardedGCN(mmodel.hp, mesh21, *GCN_DIMS).to(dev)
            twin.load_state_dict(mmodel.state_dict())
            with torch.no_grad():
                twin_logits = twin(mx)
            logit_err = float((mlogits - twin_logits).abs().max())
            logit_scale = float(twin_logits.abs().max())
    for name, runs in model_axis.items():
        ms = ", ".join(f"{r['ms_per_epoch']:.4f}" for r in runs)
        print(f"sharded GCN {GCN_DIMS} on {name}, {SHARDED_EPOCHS} epochs: "
              f"ms/epoch {ms} | row-7 launches an epoch "
              f"{runs[0]['row7_per_epoch']:.1f} | "
              f"loss {runs[0]['loss_first']:.4f} -> "
              f"{runs[0]['loss_last']:.4f} | {card}", flush=True)
    print(f"(2, 2) logits against the (2, 1) module's from the same "
          f"parameters: max_abs_err {logit_err:.3e} (max |ref| "
          f"{logit_scale:.3e})", flush=True)
    check(logit_err <= 1e-5 * logit_scale,
          "the (2, 2) GCN's logits disagree with (2, 1)'s")
    # Row 7 an epoch: (2, 1) 2 aggregations + 2 x 2 backward = 6; (2, 2)
    # the hidden one a slice (2 + 2 x 2) and the output one (1 + 2) = 9.
    check([model_axis[k][0]["row7_per_epoch"] for k in ("(2, 1)", "(2, 2)")]
          == [6, 9], "the model-axis GCN's row-7 launches an epoch")
    dry4 = dryrun_multichip(4, device=dev)
    record["model_axis"] = {"halo_spmm_vs_data_only": axis_err,
                            "gcn": model_axis,
                            "logits_vs_data_only": {"max_abs_err": logit_err,
                                                    "max_ref": logit_scale},
                            "dryrun_multichip_4": dry4}

    phase("29 profiling: trace and op_cost_table")
    pstep, (pmodel, popt), pprep, _ = build_sharded_gcn(
        sbm_host, *GCN_DIMS, mesh22, lr=1e-2)
    px, pl, pm = pprep(ds.features, ds.labels, ds.masks["train"])
    pstep(pmodel, popt, px, pl, pm)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as trace_dir:
        with profiling.trace(trace_dir) as prof:
            pstep(pmodel, popt, px, pl, pm)
            torch.cuda.synchronize()
        trace_files = [f for f in os.listdir(trace_dir)
                       if f.endswith(".pt.trace.json")]
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in device_events)
    print(f"trace of one (2, 2) GCN step: files {trace_files}, "
          f"{len(prof.events())} events, {len(device_events)} on the device,"
          f" device time total {device_us:.1f} us", flush=True)
    check(len(trace_files) == 1, "trace wrote no file")
    flops = profiling.op_cost_table(pmodel.l1, px)
    n_px = px.shape[0]
    print(f"op_cost_table of the GCN's dense layer ({n_px} x {GCN_DIMS[0]} @ "
          f"{GCN_DIMS[0]} x {GCN_DIMS[1]}): {flops}", flush=True)
    check(flops["flops"] == 2.0 * n_px * GCN_DIMS[0] * GCN_DIMS[1],
          f"op_cost_table flops {flops['flops']}")
    record["profiling"] = {"trace_files": trace_files,
                           "events": len(prof.events()),
                           "device_events": len(device_events),
                           "device_time_total_us": device_us,
                           "dense_layer_flops": flops}

    phase("15 timings, in the order plain / kernel / kernel / plain")
    hbm = profiling.measure_hbm_bandwidth()
    print(f"copy bandwidth (256 MiB f32, device time): {hbm:.1f} GB/s, "
          f"published H100 SXM {profiling.H100_HBM_GBPS:.0f} GB/s | {card}",
          flush=True)
    check(hbm > 0, "measure_hbm_bandwidth")
    record["hbm_copy_gbps"] = hbm
    # Device time: CUDA events around calls queued behind a spin kernel,
    # so they run back to back on the card.  Call time: CUDA events around
    # groups of calls, which at these sizes is the host's enqueue rate
    # (the wrapper's checks and the launch).
    def library_time(name, call, want=None, iters=50, live=None):
        """Device ms of one PyTorch call that computes the kernel's function
        (a yardstick the port never calls), or None where the card has no
        such call for these operands or its result differs from ``want``
        (on the rows ``live`` only, where given)."""
        try:
            got = call()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            print(f"library call {name}: none on the card for these operands "
                  f"({str(e).splitlines()[0][:160]})", flush=True)
            return None
        if live is not None:
            got, want = got.index_select(0, live), want.index_select(0, live)
        if want is not None:
            err = float((got.double() - want.double()).abs().max())
            scale = float(want.abs().max())
            print(f"library call {name}: max_abs_err {err:.3e} against the "
                  f"kernel (max |out| {scale:.3e})", flush=True)
            if not err <= 1e-3 * max(scale, 1.0):
                return None
        return timing.device_time(call, iters=iters) * 1e3

    # The CSR kernel (row 1) at the GCN slice's shapes, at rmat15 (edge
    # factor 8) K=128 and at the sweep's rmat15 (edge factor 16) K=128,
    # with the adjacency's split; "fast": bf16 B (rounded once, outside the
    # timed call) and f32 out.  torch.sparse.mm at the rmat15 shapes (the
    # sbm one is timed at the end, with the earlier kernels' library calls).
    sweep_csr = synth_graph("rmat15", seed=SEED)
    sweep_adj = Adjacency.from_csr(sweep_csr, device=dev)
    shapes = []
    for K in (32, 3):
        shapes.append((f"sbm csr K={K}", adj, "csr", K, f32))
        shapes.append((f"sbm csc K={K}", adj, "csc", K, f32))
    shapes.append(("sbm csr K=32 fast", adj, "csr", 32, bf16))
    for graph, a in (("rmat15", rmat), ("rmat15-ef16", sweep_adj)):
        shapes.append((f"{graph} csr K=128 binary", a, "csr", 128, f32))
        shapes.append((f"{graph} csr K=128 binary fast", a, "csr", 128, bf16))

    timings = []
    for label, a, direction, K, dtype in shapes:
        indptr, indices, rows, data, split = csr_of[direction](a)
        m, n_in = indptr.shape[0] - 1, (a.shape[1] if direction == "csr"
                                        else a.shape[0])
        B = torch.randn(n_in, K, device=dev, generator=gen)
        Bk = B.to(dtype)  # the kernel's operand: B, or B rounded to bf16

        def kernel():
            return kspmm.spmm_csr(indptr, indices, data, Bk, split=split,
                                  out_dtype=f32)

        def plain():
            return ref.spmm_rows(rows, indices, data, Bk.float(), m)

        err, ok = bound_check(torch, ref, kernel(), indptr, indices, rows,
                              data, Bk.float())
        check(ok, f"CSR kernel disagrees at {label}")
        k_dev, p_dev = alternate(timing.device_time, kernel, plain)
        k_call, p_call = alternate(lambda f: timing.benchmark(f).mean_s,
                                   kernel, plain)
        nnz = int(indices.shape[0])
        gf = timing.spmm_flops(nnz, K) / 1e6  # per ms
        lib_ms = None
        if label.startswith("rmat15") and dtype == f32:
            lib = csr_to_torch_sparse(CSR(indptr, indices, None, (m, n_in)))
            lib_ms = library_time("torch.sparse.mm",
                                  lambda: torch.sparse.mm(lib, B))
        row = {"shape": label, "nnz": nnz, "K": K,
               "segments": split.num_segments, "max_abs_err": err,
               "kernel_device_ms": k_dev, "plain_device_ms": p_dev,
               "kernel_call_ms": k_call, "plain_call_ms": p_call,
               "kernel_gflops": gf / mean(k_dev),
               "plain_gflops": gf / mean(p_dev), "library_ms": lib_ms,
               # indptr, indices (and values), B in its dtype, out in f32
               "bytes": ((m + 1) * 4 + nnz * (8 if data is not None else 4)
                         + n_in * K * Bk.element_size() + m * K * 4),
               "ops": 2 * nnz * K}
        timings.append(row)
        print(f"{label}: {split.num_segments} segments | max_abs_err "
              f"{err:.3e} | device time kernel {mean(k_dev):.5f} ms "
              f"({row['kernel_gflops']:.3f} GFLOP/s) | plain {mean(p_dev):.5f} "
              f"ms ({row['plain_gflops']:.3f} GFLOP/s) | torch.sparse.mm "
              f"{lib_ms} ms | bound "
              f"{profiling.bound(row['bytes'], row['ops'])[0] * 1e3:.5f} ms | "
              f"call time kernel {mean(k_call):.5f} ms, plain "
              f"{mean(p_call):.5f} ms | {card}", flush=True)
    record["timings"] = timings

    # The split's segment length L: the CSR kernel at both rmat15 K=128,
    # each L twice, in the order 32 ... 256 ... 32.
    split_sweep = []
    for graph, a in (("rmat15", rmat), ("rmat15-ef16", sweep_adj)):
        B = torch.randn(a.shape[1], 128, device=dev, generator=gen)
        splits = {L: build_row_split(a.csr.indptr, L).to(dev)
                  for L in SPLIT_SWEEP}
        ms = {L: [] for L in SPLIT_SWEEP}
        for L in SPLIT_SWEEP + SPLIT_SWEEP[::-1]:
            ms[L].append(timing.device_time(lambda: kspmm.spmm_csr(
                a.csr.indptr, a.csr.indices, None, B, split=splits[L])) * 1e3)
        for L in SPLIT_SWEEP:
            split_sweep.append({"graph": graph, "L": L, "K": 128,
                                "long_rows": splits[L].num_long_rows,
                                "segments": splits[L].num_segments,
                                "kernel_device_ms": ms[L]})
            print(f"CSR kernel {graph} K=128 L={L}: {splits[L].num_long_rows} "
                  f"rows longer than L in {splits[L].num_segments} segments | "
                  f"device time {', '.join(f'{x:.5f}' for x in ms[L])} ms | "
                  f"{card}", flush=True)
    record["split_sweep"] = split_sweep

    # Max/min at the SAGE-pool slice's shapes: layer 0 gathers K=128 (the
    # pooled input), layer 1 K=16; relu'd inputs, as the pool layer gives.
    # Then rmat15 K=128, where the hub row and column set the time.  The
    # plain max/min (and later the plain attention and row 7 over its
    # shards) is 15-40 launches a call, so 10 calls a group keep the launch
    # queue from filling behind the spin kernel (see timing.device_time).
    # Row 3 is called as the op calls it, with g and ties (the kernel folds
    # g / max(ties, 1)) and the CSC's split; its plain version takes the
    # folded table.  Bytes: each input read once, each output written once
    # (f32, binary): forward indptr, indices, B, out, ties; backward colptr,
    # rows, B, out, g, ties, grad_B.
    def few_time(f):
        return timing.device_time(f, iters=10)

    mm_timings = []
    for graph, a, K in [("sbm", sage_adj, K) for K in MINMAX_SBM_KS] + [
            ("rmat15", rmat, 128)]:
        B = torch.relu(torch.randn(a.shape[1], K, device=dev, generator=gen))
        g = torch.randn(a.shape[0], K, device=dev, generator=gen)
        out, ties = kmm.spmm_minmax(a.csr.indptr, a.csr.indices, None, B,
                                    "max", split=a.split)
        # Row 1 over the same edges at the same K: a yardstick of one gather
        # pass, not the same function.
        row1 = timing.device_time(lambda: kspmm.spmm_csr(
            a.csr.indptr, a.csr.indices, None, B, split=a.split)) * 1e3

        def fwd_kernel():
            return kmm.spmm_minmax(a.csr.indptr, a.csr.indices, None, B, "max",
                                   split=a.split)

        def fwd_plain():
            return ref.spmm_minmax_rows(a.rows, a.csr.indices, None, B,
                                        a.shape[0], "max")

        def bwd_kernel():
            return kmm.spmm_minmax_vjp(a.csc.indptr, a.csc.indices, None, B,
                                       out, g, ties, split=a.split_t)

        def bwd_plain(gt=None):
            return ref.spmm_minmax_vjp_cols(
                a.rows_t, a.csc.indices, None, B, out,
                g / torch.clamp(ties, min=1.0) if gt is None else gt)

        def fwd_error():
            return float((fwd_kernel()[0] - fwd_plain()[0]).abs().max())

        def bwd_error():
            gt64 = g.double() / torch.clamp(ties, min=1.0).double()
            return float((bwd_kernel()[0].double()
                          - bwd_plain(gt64)[0]).abs().max())

        m, n = a.shape
        idx = (m + 1) * 4 + a.nnz * 4
        for label, kernel, plain, error, nbytes, ops in (
                ("spmm_minmax", fwd_kernel, fwd_plain, fwd_error,
                 idx + (n + 2 * m) * K * 4, 2 * a.nnz * K),
                ("spmm_minmax_vjp", bwd_kernel, bwd_plain, bwd_error,
                 idx + (2 * n + 3 * m) * K * 4, 3 * a.nnz * K)):
            carried = {"spmm_minmax": lambda: kmm.carry_launches,
                       "spmm_minmax_vjp": lambda: kmm.vjp_carry_launches}[label]
            carries = carried()
            err = error()
            carries = carried() - carries
            k_dev, p_dev = alternate(few_time, kernel, plain)
            row = {"kernel": label, "shape": f"{graph} K={K}", "nnz": a.nnz,
                   "K": K, "kernel_device_ms": k_dev, "plain_device_ms": p_dev,
                   "bytes": nbytes, "ops": ops, "max_abs_err": err,
                   "carry_launches": carries, "row1_ms": row1}
            mm_timings.append(row)
            print(f"{label} {graph} K={K}: max_abs_err {err:.3e} | device "
                  f"time kernel {mean(k_dev):.5f} ms"
                  f" | plain {mean(p_dev):.5f} ms | bound "
                  f"{profiling.bound(nbytes, ops)[0] * 1e3:.5f} ms | row 1 at "
                  f"K={K} {row1:.5f} ms | carries a call {carries} | {card}",
                  flush=True)
    record["minmax_timings"] = mm_timings

    # Edge segment reduce at the composed chain's K=1 (sum: the normaliser
    # and the backward; max: the shift) and at 8 heads; then rmat15 (its hub
    # rows split, with the carry); the adjacency's split, as the ops pass it.
    # torch.segment_reduce with the same op beside each, held to the kernel
    # on the rows with an edge (an empty row's max is -inf there, 0 here;
    # rmat15 has 11,708 empty rows, sbm with self-loops none).
    seg_timings = []
    for graph, a, K, op in (("sbm", adj, 1, "sum"), ("sbm", adj, 1, "max"),
                            ("sbm", adj, 8, "sum"), ("rmat15", rmat, 1, "sum"),
                            ("rmat15", rmat, 1, "max"),
                            ("rmat15", rmat, 8, "sum")):
        vals = torch.randn(a.nnz, K, device=dev, generator=gen)

        def kernel():
            return kedge.edge_segment_reduce(a.csr.indptr, vals, op,
                                             split=a.split)

        def plain():
            return ref.edge_segment_rows(a.rows, vals, a.shape[0], op)

        before = kedge.carry_launches
        got = kernel()
        carries = kedge.carry_launches - before
        k_dev, p_dev = alternate(timing.device_time, kernel, plain)
        m = a.shape[0]
        nbytes, ops = profiling.edge_reduce_work(m, a.nnz, K)
        want = ref.edge_segment_rows(a.rows, vals.double(), m, op)
        row = {"kernel": "edge_segment_reduce", "shape": f"{graph} K={K} {op}",
               "nnz": a.nnz, "K": K, "kernel_device_ms": k_dev,
               "plain_device_ms": p_dev, "bytes": nbytes, "ops": ops,
               "carry_launches": carries,
               "max_abs_err": float((got.double() - want).abs().max())}
        lengths = (a.csr.indptr[1:] - a.csr.indptr[:-1]).long()
        row["library_ms"] = library_time(
            f"torch.segment_reduce {graph} K={K} {op}",
            lambda: torch.segment_reduce(vals, op, lengths=lengths, axis=0,
                                         unsafe=True),
            want=got, live=lengths.nonzero()[:, 0])
        seg_timings.append(row)
        print(f"edge_segment_reduce {graph} K={K} {op}: device time kernel "
              f"{mean(k_dev):.5f} ms ({carries} carry launches) | plain "
              f"{mean(p_dev):.5f} ms | bound "
              f"{profiling.bound(nbytes, ops)[0] * 1e3:.5f} ms | "
              f"torch.segment_reduce {row.get('library_ms')} ms | {card}",
              flush=True)
    record["edge_reduce_timings"] = seg_timings

    # The fused kernels (row 5) at GAT_TIMED, with the adjacency's splits
    # (rmat15: hub rows and columns in segments, and the carries), against
    # their plain versions (which walk every edge in torch ops; 10 calls a
    # group for both), with row 1 over the same graph at the same K beside them: a
    # yardstick of one gather pass, not the same function.
    gat_timings = []
    for graph, H, dh in GAT_TIMED:
        a = {"sbm": adj, "rmat15": rmat}[graph]
        m, n = a.shape
        K = H * dh
        src = torch.randn(m, H, device=dev, generator=gen)
        dst = torch.randn(n, H, device=dev, generator=gen)
        B = torch.randn(n, K, device=dev, generator=gen)
        g = torch.randn(m, K, device=dev, generator=gen)
        kw = dict(slope=SLOPE, heads=H)
        out, mx, den = kgat.gat_forward(a.csr.indptr, a.csr.indices, src, dst,
                                        B, split=a.split, **kw)
        s_row = ref.gat_row_dot(g, out, H)
        edges = (a.rows, a.csr.indices)
        tables = (src, dst, B, g, mx, den, s_row)
        row1 = timing.device_time(lambda: kspmm.spmm_csr(
            a.csr.indptr, a.csr.indices, None, B, split=a.split)) * 1e3
        for label, kernel, plain in (
                ("gat_fwd",
                 lambda: kgat.gat_forward(a.csr.indptr, a.csr.indices, src,
                                          dst, B, split=a.split, **kw),
                 lambda: ref.gat_fused_rows(*edges, src, dst, B, m, SLOPE,
                                            "exact", H)),
                ("gat_bwd_rows",
                 lambda: kgat.gat_backward_rows(a.csr.indptr, a.csr.indices,
                                                *tables, split=a.split, **kw),
                 lambda: ref.gat_fused_vjp_rows(*edges, *tables, m, SLOPE, H)),
                ("gat_bwd_cols",
                 lambda: kgat.gat_backward_cols(a.csc.indptr, a.csc.indices,
                                                *tables, split=a.split_t,
                                                **kw),
                 lambda: ref.gat_fused_vjp_cols(*edges, *tables, SLOPE, H))):
            before = counts()
            kernel()
            carries = counts()[label + "_carry"] - before[label + "_carry"]
            k_dev, p_dev = alternate(few_time, kernel, plain)
            nbytes, ops = gat_bytes(label, m, n, a.nnz, H, K)
            row = {"kernel": label, "shape": f"{graph} H={H} dh={dh}",
                   "nnz": a.nnz, "K": K, "kernel_device_ms": k_dev,
                   "plain_device_ms": p_dev, "row1_ms": row1,
                   "carry_launches": carries, "bytes": nbytes, "ops": ops,
                   "max_abs_err": gat_err[(graph, H, dh)][label]}
            bound_s, bound_by = profiling.bound(nbytes, ops)
            gat_timings.append(row)
            print(f"{label} {graph} H={H} dh={dh}: device time kernel "
                  f"{mean(k_dev):.5f} ms ({carries} carry launches) | plain "
                  f"{mean(p_dev):.5f} ms | bound {bound_s * 1e3:.5f} ms "
                  f"({bound_by}) | row 1 at K={K} {row1:.5f} ms | {card}",
                  flush=True)
    record["gat_timings"] = gat_timings

    # Dot-product attention at (Ka, K) = (64, 64) on both graphs, with the
    # adjacency's splits (rmat15: hub rows and columns in segments, and the
    # carries); 10 calls a group, as for the GAT kernels (a plain call is
    # 15-25 launches).
    dot_timings = []
    for graph, a in (("sbm", adj), ("rmat15", rmat)):
        m, n = a.shape
        Ka = K = 64
        D1 = torch.randn(m, Ka, device=dev, generator=gen) * Ka ** -0.25
        D2 = torch.randn(n, Ka, device=dev, generator=gen) * Ka ** -0.25
        B = torch.randn(n, K, device=dev, generator=gen)
        g = torch.randn(m, K, device=dev, generator=gen)
        out, mx, den = kgat.dot_forward(a.csr.indptr, a.csr.indices, D1, D2, B,
                                        split=a.split)
        tabs = (D1, D2, B, g, mx, den, ref.dot_row_dot(g, out))
        edges = (a.rows, a.csr.indices)
        errs = {"sbm": dot_err, "rmat15": dot_err_rmat}[graph]
        for label, kernel, plain in (
                ("dot_fwd",
                 lambda: kgat.dot_forward(a.csr.indptr, a.csr.indices, D1, D2,
                                          B, split=a.split),
                 lambda: ref.dot_attention_rows(*edges, D1, D2, B, m)),
                ("dot_bwd_rows",
                 lambda: kgat.dot_backward_rows(a.csr.indptr, a.csr.indices,
                                                *tabs, split=a.split),
                 lambda: ref.dot_attention_vjp_rows(*edges, *tabs, m)),
                ("dot_bwd_cols",
                 lambda: kgat.dot_backward_cols(a.csc.indptr, a.csc.indices,
                                                *tabs, split=a.split_t),
                 lambda: ref.dot_attention_vjp_cols(*edges, *tabs))):
            before = counts()
            kernel()
            carries = counts()[label + "_carry"] - before[label + "_carry"]
            k_dev, p_dev = alternate(few_time, kernel, plain)
            nbytes, ops = profiling.dot_attention_work(label, m, n, a.nnz, K,
                                                       Ka)
            row = {"kernel": label, "shape": f"{graph} Ka={Ka} K={K}",
                   "nnz": a.nnz, "K": K, "kernel_device_ms": k_dev,
                   "plain_device_ms": p_dev, "bytes": nbytes, "ops": ops,
                   "carry_launches": carries, "max_abs_err": errs[label]}
            dot_timings.append(row)
            print(f"{label} {graph} Ka={Ka} K={K}: device time kernel "
                  f"{mean(k_dev):.5f} ms ({carries} carry launches) | plain "
                  f"{mean(p_dev):.5f} ms | bound "
                  f"{profiling.bound(nbytes, ops)[0] * 1e3:.5f} ms | {card}",
                  flush=True)
        # scaled_dot_product_attention with the adjacency as a dense mask
        # computes the same out on every row with an edge (an empty row gets
        # NaN: rmat15 has 11,708), so it is held to the kernel on those rows.
        # rmat15's mask is 32,768^2 bytes, 1.07 GB.
        mask = torch.zeros(m, n, dtype=torch.bool, device=dev)
        mask[a.rows.long(), a.csr.indices.long()] = True
        live = (a.csr.indptr[1:] > a.csr.indptr[:-1]).nonzero()[:, 0]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                D1[None, None], D2[None, None], B[None, None],
                attn_mask=mask[None, None], scale=1.0)[0, 0]

        got = sdpa().index_select(0, live)
        want = out.index_select(0, live)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        lib_ms = (timing.device_time(sdpa, iters=10) * 1e3
                  if err <= 1e-3 * max(scale, 1.0) else None)
        print(f"library call scaled_dot_product_attention {graph}: max_abs_err "
              f"{err:.3e} against the kernel on {live.numel()} rows with an "
              f"edge (max |out| {scale:.3e}) | {lib_ms} ms", flush=True)
        dot_timings[-3]["library_ms"] = lib_ms
        del mask, got
    record["dot_timings"] = dot_timings

    # The chunk kernel against the CSR kernel (spmm_csr), its plain version
    # and torch.sparse.mm (cuSPARSE), at the GCN slice's sbm K=32 (valued),
    # at rmat15 (edge factor 8, the earlier phases' graph) and the sweep's
    # rmat15 (synth_graph, edge factor 16) at K=32 and K=128, both plan
    # sizes: the numbers of the auto rule.
    chunk_timings = []
    for graph, host_csr, a, K in (
            ("sbm", add_self_loops(ds.csr).to("cpu"), adj, 32),
            ("rmat15", rmat.csr.to("cpu"), rmat, 32),
            ("rmat15", rmat.csr.to("cpu"), rmat, 128),
            ("rmat15-ef16", sweep_csr, sweep_adj, 32),
            ("rmat15-ef16", sweep_csr, sweep_adj, 128)):
        m, n = a.shape
        B = torch.randn(n, K, device=dev, generator=gen)
        data = a.data
        lib = csr_to_torch_sparse(a.csr)
        lib_ms = library_time("torch.sparse.mm",
                              lambda: torch.sparse.mm(lib, B))
        for R, E in CHUNK_SIZES:
            plan = build_spmm_plan(host_csr, rows_per_block=R,
                                   chunk_nnz=E).to(dev)

            def chunk():
                return kpal.spmm_pallas(plan, data, B, m)

            def plain():
                return ref.spmm_chunks(plan.chunk_start, plan.chunk_count,
                                       a.csr.indices, data, B, a.rows, m)

            def csr_kernel():
                return kspmm.spmm_csr(a.csr.indptr, a.csr.indices, data, B,
                                      split=a.split)

            # The error at this row's own shape, against float64.
            err, ok = bound_check(torch, ref, chunk(), a.csr.indptr,
                                  a.csr.indices, a.rows, data, B)
            check(ok, f"chunk kernel disagrees at {graph} K={K} ({R}, {E})")
            k_dev, p_dev = alternate(few_time, chunk, plain)
            c_dev, b1_dev = alternate(timing.device_time, chunk, csr_kernel)
            # The bound is the function's (row 9's is the same): the plan's
            # work list is the kernel's own metadata, not counted.
            row = {"kernel": "spmm_chunk", "shape": f"{graph} K={K} (R, E)="
                   f"({R}, {E})", "nnz": a.nnz, "K": K, "chunks":
                   plan.num_chunks, "cut_rows": plan.cut_rows.numel(),
                   "max_abs_err": err,
                   "kernel_device_ms": k_dev + c_dev, "plain_device_ms": p_dev,
                   "spmm_csr_device_ms": b1_dev, "library_ms": lib_ms,
                   "bytes": profiling.spmm_bytes(a.nnz, m, K, n,
                                                 valued=data is not None),
                   "ops": 2 * a.nnz * K}
            chunk_timings.append(row)
            print(f"spmm_chunk {row['shape']}: {plan.num_chunks} chunks, "
                  f"{row['cut_rows']} cut rows | max_abs_err {err:.3e} | "
                  f"device time kernel "
                  f"{mean(k_dev + c_dev):.5f} ms | plain {mean(p_dev):.5f} ms"
                  f" | spmm_csr {mean(b1_dev):.5f} ms | torch.sparse.mm "
                  f"{lib_ms} ms | {card}", flush=True)
    record["chunk_timings"] = chunk_timings

    # The grouped kernel (row 9) against its plain version, the chunk kernel
    # at (64, 64) on the same ordering, the CSR kernel and torch.sparse.mm:
    # at the sweep's rmat15 K=128 (edge factor 16, binary), as generated and
    # RCM-reordered, at the JAX defaults and at G = 1 (a group is one row),
    # and at the GCN slice's RCM-reordered sbm K=32 (valued).
    sweep_rcm = reorder(sweep_csr)[0]
    grouped_timings = []
    for graph, host_csr, K, sizes in (
            ("rmat15-ef16", sweep_csr, 128, (64, 64, 32, 8)),
            ("rmat15-ef16", sweep_csr, 128, (64, 64, 64, 1)),
            ("rmat15-ef16-rcm", sweep_rcm, 128, (64, 64, 32, 8)),
            ("rmat15-ef16-rcm", sweep_rcm, 128, (64, 64, 64, 1)),
            ("sbm-rcm", sbm_rcm, 32, (64, 64, 32, 8))):
        a = Adjacency.from_csr(host_csr, device=dev)
        m, n = a.shape
        B = torch.randn(n, K, device=dev, generator=gen)
        data = a.data
        plan = build_grouped_plan(host_csr, *sizes).to(dev)
        chunk_plan = build_spmm_plan(host_csr, rows_per_block=64,
                                     chunk_nnz=64).to(dev)
        lib = csr_to_torch_sparse(host_csr.to(dev))
        lib_ms = library_time("torch.sparse.mm",
                              lambda: torch.sparse.mm(lib, B))

        def grouped():
            return kgrp.spmm_grouped(plan, data, B, m)

        def plain():
            return ref.spmm_grouped_chunks(
                plan.chunk_count, plan.groups, plan.group_count, plan.slots,
                plan.group_rows, data, B, a.rows, m)

        def chunk():
            return kpal.spmm_pallas(chunk_plan, data, B, m)

        def csr_kernel():
            return kspmm.spmm_csr(a.csr.indptr, a.csr.indices, data, B,
                                  split=a.split)

        err, ok = bound_check(torch, ref, grouped(), a.csr.indptr,
                              a.csr.indices, a.rows, data, B)
        check(ok, f"grouped kernel disagrees at {graph} K={K} {sizes}")
        k_dev, p_dev = alternate(few_time, grouped, plain)
        g_dev, c_dev = alternate(timing.device_time, grouped, chunk)
        g2_dev, b1_dev = alternate(timing.device_time, grouped, csr_kernel)
        # The bound is the function's, as for the chunk kernel: the plan's
        # work list and staged group rows are the kernel's own traffic.
        J = plan.cut_rows.numel()
        row = {"kernel": "spmm_grouped", "shape": f"{graph} K={K} (R, E, NG, "
               f"G)={sizes}", "nnz": a.nnz, "K": K, **plan_stats(plan),
               "cut_rows": J, "max_abs_err": err,
               "kernel_device_ms": k_dev + g_dev + g2_dev,
               "plain_device_ms": p_dev, "spmm_chunk_device_ms": c_dev,
               "spmm_csr_device_ms": b1_dev, "library_ms": lib_ms,
               "bytes": profiling.spmm_bytes(a.nnz, m, K, n,
                                             valued=data is not None),
               "ops": 2 * a.nnz * K}
        grouped_timings.append(row)
        print(f"spmm_grouped {row['shape']}: {stats_line(plan_stats(plan))} | "
              f"max_abs_err {err:.3e} | device time kernel "
              f"{mean(row['kernel_device_ms']):.5f} ms | plain "
              f"{mean(p_dev):.5f} ms | spmm_chunk (64, 64) "
              f"{mean(c_dev):.5f} ms | spmm_csr {mean(b1_dev):.5f} ms | "
              f"torch.sparse.mm {lib_ms} ms | bound "
              f"{profiling.bound(row['bytes'], row['ops'])[0] * 1e3:.5f} ms | "
              f"{card}", flush=True)
    record["grouped_timings"] = grouped_timings

    # Row 9's launch shape: producer warps a CTA and the widest K tile, at
    # the sweep's rmat15 K=128 (defaults) and the GCN slice's RCM sbm K=32.
    launch_sweep = []
    chosen = (kgrp.PRODUCERS, kgrp.MAX_COLS)
    for graph, host_csr, K in (("rmat15-ef16", sweep_csr, 128),
                               ("sbm-rcm", sbm_rcm, 32)):
        a = Adjacency.from_csr(host_csr, device=dev)
        plan = build_grouped_plan(host_csr).to(dev)
        B = torch.randn(a.shape[1], K, device=dev, generator=gen)
        for producers in (1, 2, 4):
            for cols in (32, 64, 128, 256):
                if cols > 32 and cols > K:
                    continue
                kgrp.PRODUCERS, kgrp.MAX_COLS = producers, cols
                ms = timing.device_time(lambda: kgrp.spmm_grouped(
                    plan, a.data, B, a.shape[0])) * 1e3
                launch_sweep.append({"graph": graph, "K": K,
                                     "producers": producers,
                                     "max_cols": cols, "kernel_device_ms": ms})
                print(f"spmm_grouped {graph} K={K} producers={producers} "
                      f"widest tile={cols}: {ms:.5f} ms | {card}", flush=True)
    kgrp.PRODUCERS, kgrp.MAX_COLS = chosen
    record["grouped_launch_sweep"] = launch_sweep

    # Row 7 (halo_spmm) over P=4 shards: one launch over all shards with
    # the partition's split (and its carry), at the sharded GCN's layer-0
    # shape (the SBM graph with self-loops, valued sum, K=32) and at rmat15
    # K=128 (binary: the hub row of degree 3,866 in shard 0) for the sum,
    # the max (with ties) and the sum backward over both transposes, each at
    # L = 64 and 128.  Against the first port's launch pattern (this kernel
    # given one shard and no split a launch: one launch a shard, hub rows
    # walked by one warp), its plain version, the whole-graph kernel (row 1;
    # row 2 for
    # the max; row 1 over the CSC for the backward) and torch.sparse.mm of
    # each shard's [A_diag | A_halo] (transposed for the backward) over its
    # tables (the library call; the port never calls it).  The bound counts
    # both blocks' indptr, indices and values, each table row the edges
    # reference once and every output row, over every shard.
    halo_timings = []

    def row7_case(graph, hp, a, op, K):
        """One timed row-7 case: (record row, printed line)."""
        B = torch.randn(SHARDS * hp.cpp, K, device=dev, generator=gen)
        halo = make_exchange(hp, mesh4_for(hp))(B)
        g = torch.randn(SHARDS * hp.rpp, K, device=dev, generator=gen)
        valued = hp.diag_data is not None
        dvs, hvs = hp.diag_data, hp.halo_data
        bwd = op == "sum-bwd"
        reduce = "sum" if bwd else op
        shards = []
        for p in range(SHARDS):
            blk = hp.blocks(p)
            dv = None if dvs is None else dvs[p, :hp.diag_nnz[p]]
            hv = None if hvs is None else hvs[p, :hp.halo_nnz[p]]
            shards.append((p, blk, dv, hv, B[p * hp.cpp:(p + 1) * hp.cpp],
                           halo[p], g[p * hp.rpp:(p + 1) * hp.rpp]))
        t_vals = {blk: csc_vals(v, getattr(hp, f"{blk}_t_map"))
                  for blk, v in (("diag", dvs), ("halo", hvs))}

        def t_blocks(p, blk, dv, hv):
            """Shard p's transposed blocks: (indptr, rows, CSC values,
            output rows)."""
            return [(blk.d_t_indptr, blk.d_t_rows,
                     None if dv is None else dv[blk.d_t_map.long()], hp.cpp),
                    (blk.h_t_indptr, blk.h_t_rows,
                     None if hv is None else hv[blk.h_t_map.long()],
                     hp.halo_rows)]

        if bwd:
            def new():
                return [khalo.halo_spmm_stacked(
                    getattr(hp, f"{blk}_t_indptr"),
                    getattr(hp, f"{blk}_t_rows"), t_vals[blk], g,
                    split=getattr(hp, f"{blk}_t_split"))[0]
                    for blk in ("diag", "halo")][-1]

            def old():
                return [khalo.halo_spmm_rows(tp, tr, tv, g_p)[0]
                        for p, blk, dv, hv, Bs, hb, g_p in shards
                        for tp, tr, tv, _ in t_blocks(p, blk, dv, hv)][-1]

            t_cols = {(p, i): expand_indptr(tp, tr.shape[0])
                      for p, blk, dv, hv, *_ in shards
                      for i, (tp, tr, _, _) in enumerate(
                          t_blocks(p, blk, dv, hv))}

            def plain():
                return [ref.halo_spmm_rows(t_cols[p, i], tr, tv, g_p, None,
                                           None, None, None, n_t)[0]
                        for p, blk, dv, hv, Bs, hb, g_p in shards
                        for i, (tp, tr, tv, n_t) in enumerate(
                            t_blocks(p, blk, dv, hv))][-1]

            def whole():
                return kspmm.spmm_csr(a.csc.indptr, a.csc.indices, a.csc.data,
                                      g[:a.shape[0]], split=a.split_t)
        else:
            def new():
                return khalo.halo_spmm_stacked(
                    hp.diag_indptr, hp.diag_indices, dvs, B, hp.halo_indptr,
                    hp.halo_indices, hvs, halo, reduce,
                    split=hp.joint_split)[0]

            def old():
                return [khalo.halo_spmm_rows(
                    blk.d_indptr, blk.d_indices, dv, Bs, blk.h_indptr,
                    blk.h_indices, hv, hb, reduce)[0]
                    for p, blk, dv, hv, Bs, hb, g_p in shards][-1]

            def plain():
                return [ref.halo_spmm_rows(
                    blk.d_rows, blk.d_indices, dv, Bs, blk.h_rows,
                    blk.h_indices, hv, hb, hp.rpp, reduce)[0]
                    for p, blk, dv, hv, Bs, hb, g_p in shards][-1]

            def whole():
                if op == "max":
                    return kmm.spmm_minmax(a.csr.indptr, a.csr.indices,
                                           a.data, B[:a.shape[1]], "max",
                                           split=a.split)[0]
                return kspmm.spmm_csr(a.csr.indptr, a.csr.indices, a.data,
                                      B[:a.shape[1]], split=a.split)

        # [A_diag | A_halo] of each shard as one CSR (its transpose for the
        # backward) and its dense operand.
        libs = []
        for p, blk, dv, hv, Bs, hb, g_p in shards:
            rows = torch.cat([blk.d_rows, blk.h_rows]).long()
            cols = torch.cat([blk.d_indices, blk.h_indices + hp.cpp]).long()
            v = (torch.ones(rows.shape[0], device=dev) if dv is None
                 else torch.cat([dv, hv]))
            shape = (hp.rpp, hp.cpp + hp.halo_rows)
            if bwd:
                rows, cols, shape = cols, rows, shape[::-1]
            lib = torch.sparse_coo_tensor(torch.stack([rows, cols]), v,
                                          shape).coalesce().to_sparse_csr()
            libs.append((lib, g_p if bwd else torch.cat([Bs, hb])))
        kw = {"reduce": "amax"} if op == "max" else {}
        lib_ms = library_time(
            f"torch.sparse.mm per shard ({op})",
            lambda: [torch.sparse.mm(L_, T_, **kw) for L_, T_ in libs][-1],
            iters=20)
        # Errors: the sum against float64 within the sum kernel's bound, the
        # max exactly against the plain version (out and ties).
        if bwd:
            got = {blk: khalo.halo_spmm_stacked(
                getattr(hp, f"{blk}_t_indptr"), getattr(hp, f"{blk}_t_rows"),
                t_vals[blk], g, split=getattr(hp, f"{blk}_t_split"))[0]
                for blk in ("diag", "halo")}
            err, ok = 0.0, True
            for p, blk, dv, hv, *_ in shards:
                for i, (tp, tr, tv, n_t) in enumerate(t_blocks(p, blk, dv, hv)):
                    want = ref.halo_spmm_rows(
                        t_cols[p, i], tr, None if tv is None else tv.double(),
                        shards[p][6].double(), None, None, None, None, n_t)[0]
                    part = got["diag" if i == 0 else "halo"][
                        p * n_t:(p + 1) * n_t]
                    e = float((part.double() - want).abs().max())
                    err = max(err, e)
                    ok = ok and e <= 1e-5 * float(want.abs().max()) + 1e-6
        elif op == "max":
            out, ties = khalo.halo_spmm_stacked(
                hp.diag_indptr, hp.diag_indices, dvs, B, hp.halo_indptr,
                hp.halo_indices, hvs, halo, "max", split=hp.joint_split)
            err, ok = 0.0, True
            for p, blk, dv, hv, Bs, hb, g_p in shards:
                want, want_ties = ref.halo_spmm_rows(
                    blk.d_rows, blk.d_indices, dv, Bs, blk.h_rows,
                    blk.h_indices, hv, hb, hp.rpp, "max")
                rows = slice(p * hp.rpp, (p + 1) * hp.rpp)
                err = max(err, float((out[rows] - want).abs().max()))
                ok = ok and torch.equal(out[rows], want) and torch.equal(
                    ties[rows], want_ties)
        else:
            err, ok = bound_check(torch, ref, new()[:a.shape[0]],
                                  a.csr.indptr, a.csr.indices, a.rows, a.data,
                                  B[:a.shape[1]])
        check(ok, f"row 7 disagrees at {graph} K={K} {op}")
        khalo.reset_launches()
        new()
        per_call = (khalo.launches, khalo.carry_launches)
        k_dev, p_dev = alternate(few_time, new, plain)
        k2_dev, o_dev = alternate(timing.device_time, new, old)
        k3_dev, w_dev = alternate(timing.device_time, new, whole)
        seg_len = hp.joint_split.split.seg_len
        row = {"kernel": "halo_spmm", "shape": f"{graph} P={SHARDS} K={K} "
               f"{'valued' if valued else 'binary'} {op} L={seg_len}",
               "seg_len": seg_len,
               "segments": {blk: getattr(hp, f"{blk}_split").split.num_segments
                            for blk in ("joint", "diag_t", "halo_t")},
               "launches_per_call": per_call, "nnz": hp.nnz, "K": K,
               "halo_rows": hp.halo_rows, "max_abs_err": err,
               "kernel_device_ms": k_dev + k2_dev + k3_dev,
               "plain_device_ms": p_dev, "per_shard_device_ms": o_dev,
               "whole_graph_device_ms": w_dev, "library_ms": lib_ms}
        if op == "sum":
            # Each shard's launch alone, unsplit and with its
            # part of the split, beside its longest row (diag + halo edges).
            row["shard_unsplit_ms"] = [timing.device_time(
                lambda s=s: khalo.halo_spmm_rows(
                    s[1].d_indptr, s[1].d_indices, s[2], s[4], s[1].h_indptr,
                    s[1].h_indices, s[3], s[5])[0]) * 1e3 for s in shards]
            row["shard_split_ms"] = [timing.device_time(
                lambda s=s: khalo.halo_spmm_rows(
                    s[1].d_indptr, s[1].d_indices, s[2], s[4], s[1].h_indptr,
                    s[1].h_indices, s[3], s[5], split=hp.joint_split,
                    shard=s[0])[0]) * 1e3 for s in shards]
            row["shard_longest_row"] = [
                int((torch.diff(blk.d_indptr) + torch.diff(blk.h_indptr))
                    .max()) for _, blk, *_ in shards]
        # Bytes: each shard reads its indptrs, indices and values, once each
        # table row its edges reference, and writes every output row (and,
        # for the max, the ties).
        nbytes = 0
        for p, blk, *_ in shards:
            nnz_p = hp.diag_nnz[p] + hp.halo_nnz[p]
            edge_bytes = nnz_p * (8 if valued else 4)
            if bwd:
                referenced = int(torch.unique(torch.cat(
                    [blk.d_rows, blk.h_rows])).numel())
                nbytes += ((hp.cpp + 1 + hp.halo_rows + 1) * 4 + edge_bytes
                           + (referenced + hp.cpp + hp.halo_rows) * K * 4)
            else:
                used = (int(torch.unique(blk.d_indices).numel())
                        + int(torch.unique(blk.h_indices).numel()))
                outs = hp.rpp * K * 4 * (2 if op == "max" else 1)
                nbytes += 2 * (hp.rpp + 1) * 4 + edge_bytes + used * K * 4 \
                    + outs
        row.update(bytes=nbytes, ops=2 * hp.nnz * K)
        bound_ms = profiling.bound(nbytes, row["ops"])[0] * 1e3
        line = (f"halo_spmm {row['shape']} (all shards): "
                f"max_abs_err {err:.3e} | launches a call {per_call} | "
                f"device time kernel {mean(row['kernel_device_ms']):.5f} ms | "
                f"a launch a shard, unsplit {mean(o_dev):.5f} ms | plain "
                f"{mean(p_dev):.5f} "
                f"ms | whole-graph kernel {mean(w_dev):.5f} ms | "
                f"torch.sparse.mm per shard {lib_ms} ms | bound "
                f"{bound_ms:.5f} ms | segments {row['segments']}")
        if op == "sum":
            line += (f" | per shard, unsplit "
                     f"{', '.join(f'{x:.5f}' for x in row['shard_unsplit_ms'])}"
                     f" ms, split {', '.join(f'{x:.5f}' for x in row['shard_split_ms'])}"
                     f" ms, longest rows {row['shard_longest_row']}")
        return row, line + f" | {card}"

    def mesh4_for(hp):
        return make_mesh(hp.num_parts, device=dev)

    # ... and dist_bench's P=4 shape: rmat17 in the "auto" order, K=64.
    for graph, host_csr, K, ops, seg_lens in (
            ("sbm", sbm_host, 32, ("sum",), HALO_SPLIT_LENS),
            ("rmat15", rmat_host, 128, ("sum", "max", "sum-bwd"),
             HALO_SPLIT_LENS),
            ("rmat17-auto", part17, DIST_K, ("sum",), (SPLIT_LEN,))):
        a = Adjacency.from_csr(host_csr, device=dev)
        for seg_len in seg_lens:
            hp = build_halo_partition(host_csr, SHARDS, device=dev,
                                      seg_len=seg_len)
            for op in ops:
                row, line = row7_case(graph, hp, a, op, K)
                halo_timings.append(row)
                print(line, flush=True)
    record["halo_timings"] = halo_timings

    for name, runs, make, a, lr in (
            ("GCN", gcn_runs, make_gcn, adj, 1e-2),
            ("SAGE-pool", sage_runs, make_sage, sage_adj, 1e-2),
            ("GAT", gat_runs, make_gat, adj, GAT_LR)):
        for method in ("xla", "auto"):
            runs[method]["ms_per_epoch_runs"].append(
                train(make, a, method, lr=lr)[1]["mean_epoch_time"] * 1e3)
        for method, r in runs.items():
            ms = r["ms_per_epoch_runs"]
            r["ms_per_epoch"] = mean(ms)
            print(f"{name} {method}: {mean(ms):.4f} ms/epoch (runs "
                  f"{', '.join(f'{x:.4f}' for x in ms)}) | {card}", flush=True)
    # The GCN on the grouped route (RCM order) against phase 6's CSR route.
    gcn_routes = {"csr": [], "grouped": []}
    for route in ("csr", "grouped", "grouped", "csr"):
        res = (train(make_gcn, adj, "auto") if route == "csr" else
               train(make_gcn_grouped, grp_adj, "pallas", data=ds_rcm))[1]
        gcn_routes[route].append(res["mean_epoch_time"] * 1e3)
    for route, ms in gcn_routes.items():
        print(f"GCN, {route} route: {mean(ms):.4f} ms/epoch (runs "
              f"{', '.join(f'{x:.4f}' for x in ms)}) | {card}", flush=True)
    record["gcn_routes_ms_per_epoch"] = gcn_routes
    # The sharded GCN (P=4 shards in one process, row 7) against phase 6's
    # single-device run.
    gcn_sharded_ms = {"single": [], "sharded": []}
    for route in ("single", "sharded", "sharded", "single"):
        gcn_sharded_ms[route].append(
            train(make_gcn, adj, "auto")[1]["mean_epoch_time"] * 1e3
            if route == "single" else sharded_train(
                build_sharded_gcn, sbm_host, GCN_DIMS, EPOCHS,
                1e-2)[0]["ms_per_epoch_runs"][0])
    for route, ms in gcn_sharded_ms.items():
        print(f"GCN {route} ({'P=4 shards' if route == 'sharded' else 'one'}"
              f" device): {mean(ms):.4f} ms/epoch (runs "
              f"{', '.join(f'{x:.4f}' for x in ms)}) | {card}", flush=True)
    record["gcn_sharded_ms_per_epoch"] = gcn_sharded_ms
    # The device's share of an epoch: one train step's device time (queued
    # behind a spin kernel, so without the host's gaps) over its ms/epoch.
    model = make_gcn("auto")
    single_step = make_train_step(
        model, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                 weight_decay=5e-4),
        adj, ds.features, ds.labels, ds.masks["train"],
        generator=torch.Generator(device=dev).manual_seed(SEED))
    step, (smodel, sopt), prepare, _ = build_sharded_gcn(
        sbm_host, *GCN_DIMS, mesh4, lr=1e-2)
    sx, slab, smask = prepare(ds.features, ds.labels, ds.masks["train"])
    busy = {}
    for route, fn in (("single", single_step),
                      ("sharded", lambda: step(smodel, sopt, sx, slab,
                                               smask)[2])):
        step_ms = timing.device_time(fn, iters=3) * 1e3
        busy[route] = {"device_ms_per_step": step_ms,
                       "busy_share": step_ms / mean(gcn_sharded_ms[route])}
        print(f"GCN {route}: device time a step {step_ms:.4f} ms, busy share "
              f"of its ms/epoch {busy[route]['busy_share']:.4f} | {card}",
              flush=True)
    record["gcn_busy"] = busy
    mh_ms = gat_mh_runs["auto"]["ms_per_epoch_runs"][0]
    print(f"GAT heads={GAT_MH_HEADS} auto: {mh_ms:.4f} ms/epoch | {card}",
          flush=True)
    # The port's headline line (bench/headline.py), on a line of its own.
    head = headline(device=dev)
    check(head["value"] > 0 and head["vs_baseline"] > 0,
          f"headline: {head}")
    print(json.dumps(head), flush=True)
    print(f"headline measured on {card}", flush=True)
    record["headline"] = head

    # The library calls of the earlier kernels, at their kernels-line shapes.
    B32 = torch.randn(adj.shape[1], 32, device=dev, generator=gen)
    lib_sbm = csr_to_torch_sparse(adj.csr)
    timings[0]["library_ms"] = library_time(
        "torch.sparse.mm", lambda: torch.sparse.mm(lib_sbm, B32),
        want=kspmm.spmm_csr(adj.csr.indptr, adj.csr.indices, adj.data, B32,
                            split=adj.split))
    B128 = torch.relu(torch.randn(sage_adj.shape[1], 128, device=dev,
                                  generator=gen))
    lib_sage = csr_to_torch_sparse(sage_adj.csr)
    mm_timings[0]["library_ms"] = library_time(
        "torch.sparse.mm(reduce='amax')",
        lambda: torch.sparse.mm(lib_sage, B128, reduce="amax"),
        want=kmm.spmm_minmax(sage_adj.csr.indptr, sage_adj.csr.indices, None,
                             B128, "max", split=sage_adj.split)[0])

    def kernel_entry(name, source, replaces, launches, err, row):
        bound_s, bound_by = profiling.bound(row["bytes"], row["ops"])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": mean(row["kernel_device_ms"]),
                "plain_ms": mean(row["plain_device_ms"]),
                "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                "library_ms": row.get("library_ms"), "shape": row["shape"]}

    def more_shapes(rows):
        """The kernel's other timed shapes, each with its own error, times
        and bound."""
        return [{**{k: v for k, v in kernel_entry("", "", "", 0,
                                                  r["max_abs_err"], r).items()
                    if k not in ("name", "route", "source", "replaces",
                                 "launches")},
                 **{k: r[k] for k in ("row1_ms", "carry_launches") if k in r}}
                for r in rows]

    chunk_row = next(r for r in chunk_timings
                     if r["shape"] == "rmat15-ef16 K=128 (R, E)=(64, 64)")
    grouped_row = grouped_timings[-1]  # the GCN slice's sbm-rcm K=32
    grouped_launches = gcn_grouped_runs["pallas"]["launches"]
    kernels = {"kernels": [
        dict(kernel_entry("spmm_csr", kspmm.SOURCE, kspmm.REPLACES,
                          gcn_runs["auto"]["launches"]["spmm_csr"], slice_err,
                          timings[0]),
             carry_launches=gcn_runs["auto"]["launches"]["spmm_csr_carry"],
             dist_bench_launches=weak_launches["allgather"]["spmm_csr"],
             more=more_shapes(t for t in timings
                              if t["shape"].startswith("rmat15"))),
        # Row 2: launches and carries of SAGE-pool's run (phase 7); times at
        # sbm K=128, the other timed shapes (sbm K=16, rmat15 K=128) in more.
        dict(kernel_entry("spmm_minmax", kmm.SOURCE, kmm.REPLACES,
                          sage_runs["auto"]["launches"]["spmm_minmax"],
                          fwd_err, mm_timings[0]),
             carry_launches=sage_runs["auto"]["launches"]["spmm_minmax_carry"],
             row1_ms=mm_timings[0]["row1_ms"],
             more=more_shapes(r for r in mm_timings[2:]
                              if r["kernel"] == "spmm_minmax")),
        # Row 3: launches and carries of SAGE-pool's run (phase 7) and of the
        # sharded SAGE-pool's (phase 20); times at sbm K=128, the other timed
        # shapes (sbm K=16, rmat15 K=128) in more.
        dict(kernel_entry("spmm_minmax_vjp", kmm.SOURCE, kmm.VJP_REPLACES,
                          sage_runs["auto"]["launches"]["spmm_minmax_vjp"],
                          bwd_err, mm_timings[1]),
             carry_launches=sage_runs["auto"]["launches"][
                 "spmm_minmax_vjp_carry"],
             sharded_launches=sharded["sage_pool"]["launches"][
                 "spmm_minmax_vjp"],
             more=more_shapes(r for r in mm_timings[2:]
                              if r["kernel"] == "spmm_minmax_vjp")),
        # Row 4: launches and carries of the composed chain (phase 9), times
        # at sbm K=1 sum, the other timed shapes in more.
        dict(kernel_entry("edge_segment_reduce", kedge.SOURCE, kedge.REPLACES,
                          chain_launches["edge_segment_reduce"],
                          att_err["edge_segment_reduce"], seg_timings[0]),
             carry_launches=chain_launches["edge_segment_reduce_carry"],
             gat_pallas_launches=gat_pallas["launches"]["edge_segment_reduce"],
             more=more_shapes(seg_timings[1:])),
        # Row 5: launches and carries of the GAT's run (phase 10), times at
        # sbm H=1 dh=64, the other timed shapes in more.
        *(dict(kernel_entry(name, kgat.SOURCE, replaces,
                            gat_runs["auto"]["launches"][name],
                            att_err[name], gat_timings[i]),
               carry_launches=gat_runs["auto"]["launches"][name + "_carry"],
               row1_ms=gat_timings[i]["row1_ms"],
               more=more_shapes(r for r in gat_timings[3:]
                                if r["kernel"] == name))
          for i, (name, replaces) in enumerate((
              ("gat_fwd", kgat.REPLACES),
              ("gat_bwd_rows", kgat.BWD_ROWS_REPLACES),
              ("gat_bwd_cols", kgat.BWD_COLS_REPLACES)))),
        # Row 6: launches and carries of attention_aggregate's run (phase
        # 12), times at sbm Ka=K=64, rmat15 in more.
        *(dict(kernel_entry(name, kgat.DOT_SOURCE, replaces,
                            dot_launches[name], dot_err[name], dot_timings[i]),
               carry_launches=dot_launches[name + "_carry"],
               more=more_shapes([dot_timings[i + 3]]))
          for i, (name, replaces) in enumerate((
              ("dot_fwd", kgat.DOT_REPLACES),
              ("dot_bwd_rows", kgat.DOT_BWD_ROWS_REPLACES),
              ("dot_bwd_cols", kgat.DOT_BWD_COLS_REPLACES)))),
        dict(kernel_entry("spmm_chunk", kpal.SOURCE, kpal.REPLACES,
                          sweep_launches["spmm_chunk"],
                          chunk_row["max_abs_err"], chunk_row),
             carry_launches=sweep_launches["spmm_chunk_carry"],
             gat_pallas_launches=gat_pallas["launches"]["spmm_chunk"],
             gat_pallas_carry_launches=gat_pallas["launches"][
                 "spmm_chunk_carry"],
             more=more_shapes(r for r in chunk_timings if r is not chunk_row)),
        dict(kernel_entry("spmm_grouped", kgrp.SOURCE, kgrp.REPLACES,
                          grouped_launches["spmm_grouped"],
                          grouped_row["max_abs_err"], grouped_row),
             carry_launches=grouped_launches["spmm_grouped_carry"],
             more=more_shapes(grouped_timings[:-1])),
        # Launches: the sharded GCN's run (phase 20); error: the main path's
        # shape (phase 18, sbm P=4 K=32 f32 valued sum, one launch over the
        # four shards); times: that shape at L = 64, the other rows in more.
        dict(kernel_entry("halo_spmm", khalo.SOURCE, khalo.REPLACES,
                          sharded["gcn"]["launches"]["halo_spmm"], halo_err,
                          halo_timings[0]),
             carry_launches=sharded["gcn"]["launches"]["halo_spmm_carry"],
             dist_bench_launches=weak_launches["halo-tiled"]["halo_spmm"],
             model_axis_launches=model_axis["(2, 2)"][0]["launches"][
                 "halo_spmm"],
             more=more_shapes(halo_timings[1:])),
    ]}
    record.update(kernels)
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
