// The joint diag+halo SpMM of the sharded tier, for Hopper (sm_90a): one
// launch over n stacked shards, with long rows split over warps.  For shard
// i and its row r (stacked row q = i * m + r):
//
//     out[q, k] = reduce over the diag edges e of (i, r) of  val_e * B[i][col_e, k]
//                 joined with the halo edges e of (i, r) of   val_e * halo[i][col_e, k]
//
// reduce is sum, or max/min with the exact count of the edges, over BOTH
// blocks, that achieve the extremum (ties, f32); a row with no edge in either
// block gives 0 and 0 ties.  Edge values are none (1.0), one per edge, or
// one per head per edge: with H heads over K = H * dh columns, column k takes
// vals[e * H + k / dh] (sum only).
//
// Replaces kernel row 7, the stream reduce of gespmm_tpu/parallel/halo.py
// launched through _reduce_part at three places: _tiled_apply (:357-377,
// call :373) for the sum forward, once over the diag block and once over
// the halo block, added afterwards; _minmax_block_raw (:460-476, call :472)
// for each block's raw extremum and tie counts, which _minmax_fwd_raw
// (:479-508) folds into the joint extremum and joint ties; and
// _minmax_bwd_block (:538-594, call :583), the max/min backward, which here
// is kernel row 3 (spmm_minmax.cu) over each transposed block, given the
// joint out and ties from this kernel.  The sum backward is this kernel over
// the stacked transposed blocks with the halo block left out (h_indptr
// null): grad_B = A_diag^T g and grad_halo = A_halo^T g, values in CSC order.
//
// Layout.  The n shards' blocks are stacked as the host pre-pass keeps them
// (gespmm_tpu_torch/parallel/halo.py::HaloPartition): indptrs (n, m + 1),
// indices and values (n, stride) padded per shard, and each table holds
// tab_rows rows a shard: B (n * cpp, K), the halo tables (n, halo_rows, K)
// as the exchange delivers them; out is (n * m, K).
//
// What bounds it: bytes, as the CSR sum kernel (spmm_csr.cu): every nonzero
// gathers one K-wide row of its table for 2K flops.  The design is that
// kernel's, over the joint edge list of a row (its diag edges, then its halo
// edges):
//   * one launch over all the shards a process holds, so that one shard's
//     long tail overlaps the others' work (one launch a shard left each
//     launch waiting on its own longest row, and sbm's short rows paying a
//     launch's ramp four times);
//   * the items are every shard's segments first, then every (shard, row).
//     A row of at most L joint edges is walked by its own warp, across both
//     blocks, and written to out.  A longer row is skipped there, and each of
//     its segments, L consecutive positions of the joint edge list (the
//     host-built split, sparse/partition.py::build_shard_split), is walked by
//     one warp, which may cross from the diag block into the halo block
//     mid-segment.  The warp writes an f32 partial (max/min: the segment's
//     extremum and its count) to its slot of a scratch buffer, and a carry
//     pass of carry.cuh, one warp per long row, adds the partials in segment
//     order (max/min: folds the pairs, minmax_fold_pair, which gives the
//     unsplit walk's out and ties bit for bit).  With no segment in the
//     launch the no-split instantiation runs and no carry is launched;
//   * the (index, value) pairs of 32 joint positions load at a time, one per
//     lane, from either block, and are broadcast with __shfl_sync; the table
//     rows of 4 edges are loaded before any is folded (4 gathers in flight a
//     warp); each lane owns VEC
//     consecutive columns (vector loads); a second grid dimension walks K
//     slabs of 32 * VEC columns.  Per-head values are read per edge and
//     column group, from L1;
//   * every output element is written once, without atomics, so two calls
//     give bitwise-equal results.
// Max/min contributions come from minmax.cuh's minmax_contrib, the
// expression spmm_minmax.cu's backward recomputes to find the achieving
// edges.
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// K % VEC == 0 and every table, out, ties and partial aligned to VEC
// elements).  The caller guarantees that every index is below its table's
// tab_rows; slots past a shard's indptr[m] are never read.  Each entry point
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "carry.cuh"
#include "minmax.cuh"

namespace {

using gespmm::from_f32;
using gespmm::kThreads;
using gespmm::kWarps;
using gespmm::Pack;
using gespmm::to_f32;

constexpr unsigned kFull = 0xffffffffu;

// How edges carry values, and the reduction.
enum Vals { kBinary = 0, kScalar = 1, kHeads = 2 };
enum Op { kSum = 0, kMax = 1, kMin = 2 };

// One stacked block: shard i's indptr row is indptr + i * (m + 1), its
// edges indices/vals + i * stride (values * heads for per-head values),
// its table table + i * tab_rows * K.
template <typename T>
struct Block {
  const int* indptr;
  const int* indices;
  const float* vals;
  const T* table;
  int64_t stride, tab_rows;
};

// Folds an edge's gathered row p (value w, or its per-head values vh) into
// the lane's (acc, count).
template <typename T, int VEC, int VALS, int OP>
__device__ __forceinline__ void fold_edge(const Pack<T, VEC>& p, float w,
                                          const float* __restrict__ vh,
                                          const int (&head)[VEC],
                                          float (&acc)[VEC],
                                          int (&count)[VEC]) {
#pragma unroll
  for (int t = 0; t < VEC; ++t) {
    const float b = to_f32(p.v[t]);
    const float x = VALS == kHeads ? __ldg(vh + head[t]) : w;
    if (OP == kSum) {
      acc[t] = VALS == kBinary ? acc[t] + b : fmaf(x, b, acc[t]);
    } else {
      gespmm::minmax_fold<OP == kMax>(
          gespmm::minmax_contrib<VALS != kBinary>(x, b), acc[t], count[t]);
    }
  }
}

// Walks the joint positions [j0, j1) of shard i's row for the lane's VEC
// columns, in order: position j < d_deg is diag edge ds + j, any other halo
// edge hs + j - d_deg.  Warp-uniform down to the shuffles: all 32 lanes
// take part.  Each round loads the (index, value) pairs of 32 positions,
// one a lane, from whichever block holds it, so a row's diag and halo edges
// share their index loads, and a round may cross from one block into the
// other.  The table rows of kBatch edges are loaded before any is folded, so
// that a warp has kBatch gathers in flight: the first port's unrolled
// one-edge loop, its load behind `if (active)`, compiled in this kernel to a
// branch around each load, one or two gathers in flight and a slower walk
// a hub edge (scripts/row7_walk_ab.py times the two walks; PERF.md, section 6).
// A lane past K (the last K slab) reads column 0 of each row and drops its
// result.
template <typename T, int VEC, int VALS, int OP>
__device__ __forceinline__ void walk_joint(const Block<T>& d,
                                           const Block<T>& h, int i, int ds,
                                           int d_deg, int hs, int j0, int j1,
                                           int K, int k, bool active,
                                           int heads, const int (&head)[VEC],
                                           float (&acc)[VEC],
                                           int (&count)[VEC]) {
  using P = Pack<T, VEC>;
  constexpr int kBatch = 4;
  const int lane = threadIdx.x & 31;
  const int vw = VALS == kHeads ? heads : 1;  // values a edge
  // Shard i's view of each block, from the row's first edge on (an absent or
  // empty block may have null pointers; they are offset, never read).
  const int* __restrict__ d_idx = d.indices + i * d.stride + ds;
  const int* __restrict__ h_idx = h.indices + i * h.stride + hs;
  const float* __restrict__ d_val =
      VALS == kBinary ? nullptr : d.vals + (i * d.stride + ds) * vw;
  const float* __restrict__ h_val =
      VALS == kBinary ? nullptr : h.vals + (i * h.stride + hs) * vw;
  const int kk = active ? k : 0;
  const T* __restrict__ d_col = d.table + i * d.tab_rows * K + kk;
  const T* __restrict__ h_col = h.table + i * h.tab_rows * K + kk;
  // The per-head values of joint position jj (per-head values only).
  auto edge_vals = [&](int jj) -> const float* {
    if (VALS != kHeads) return nullptr;
    return jj < d_deg ? d_val + jj * vw : h_val + (jj - d_deg) * vw;
  };
  for (int base = j0; base < j1; base += 32) {
    const int j = base + lane;
    int c = 0;
    float v = 0.f;
    if (j < j1) {
      const bool diag = j < d_deg;
      c = __ldg(diag ? d_idx + j : h_idx + (j - d_deg));
      if (VALS == kScalar) v = __ldg(diag ? d_val + j : h_val + (j - d_deg));
    }
    const int n_here = min(32, j1 - base);
    int u0 = 0;
    for (; u0 + kBatch <= n_here; u0 += kBatch) {
      P p[kBatch];
      float w[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int jj = base + u0 + u;
        const int cj = __shfl_sync(kFull, c, u0 + u);
        w[u] = VALS == kScalar ? __shfl_sync(kFull, v, u0 + u) : 1.f;
        p[u] = *reinterpret_cast<const P*>(
            (jj < d_deg ? d_col : h_col) + (int64_t)cj * K);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int jj = base + u0 + u;
        fold_edge<T, VEC, VALS, OP>(p[u], w[u], edge_vals(jj), head, acc,
                                    count);
      }
    }
    for (; u0 < n_here; ++u0) {
      const int jj = base + u0;
      const int cj = __shfl_sync(kFull, c, u0);
      const float w = VALS == kScalar ? __shfl_sync(kFull, v, u0) : 1.f;
      fold_edge<T, VEC, VALS, OP>(
          *reinterpret_cast<const P*>((jj < d_deg ? d_col : h_col)
                                      + (int64_t)cj * K),
          w, edge_vals(jj), head, acc, count);
    }
  }
}

// SPLIT: the launch has segments.  Without (S = 0: no joint row longer than
// L) the kernel is the plain one-warp-a-row walk, with no segment test.  The
// halo block is left out with a null h.indptr (the sum backward over one
// transposed block).
template <typename T, int VEC, int VALS, int OP, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
halo_spmm_kernel(int n, int m, int K, int heads, int L, int S, int row0,
                 Block<T> d, Block<T> h, const int* __restrict__ seg_row,
                 const int* __restrict__ seg_start, T* __restrict__ out,
                 float* __restrict__ ties, float* __restrict__ partial,
                 float* __restrict__ partial_count) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;  // first column of this lane
  const bool active = k < K;  // K % VEC == 0, so k < K covers all VEC
  const bool two = h.indptr != nullptr;  // warp-uniform: a launch argument
  // The head of each of the lane's columns (per-head values only).
  int head[VEC];
  const int dh = VALS == kHeads ? K / heads : K;
#pragma unroll
  for (int t = 0; t < VEC; ++t) head[t] = active ? (k + t) / dh : 0;
  const int items = S + n * m;
  const int stride = gridDim.x * kWarps;
  for (int item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < items;
       item += stride) {
    const bool seg = SPLIT && item < S;
    const int q = seg ? seg_row[item] - row0 : item - S;
    const int i = q / m, r = q - i * m;
    const int* dp = d.indptr + (int64_t)i * (m + 1) + r;
    const int ds = dp[0], d_deg = dp[1] - ds;
    int hs = 0, deg = d_deg;
    if (two) {
      const int* hp = h.indptr + (int64_t)i * (m + 1) + r;
      hs = hp[0];
      deg += hp[1] - hs;
    }
    int j0 = 0, j1 = deg;  // the joint positions this warp walks
    if (seg) {
      j0 = seg_start[item];
      j1 = min(j0 + L, deg);
    } else if (SPLIT && deg > L) {
      continue;  // its segments and the carry write it
    }
    float acc[VEC];
    int count[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      acc[t] = OP == kSum ? 0.f : gespmm::minmax_identity<OP == kMax>();
      count[t] = 0;
    }
    walk_joint<T, VEC, VALS, OP>(d, h, i, ds, d_deg, hs, j0, j1, K, k,
                                 active, heads, head, acc, count);
    if (!active) continue;
    if (seg) {
      F a;
#pragma unroll
      for (int t = 0; t < VEC; ++t) a.v[t] = acc[t];
      *reinterpret_cast<F*>(partial + (int64_t)item * K + k) = a;
      if (OP != kSum) {
        F c;
#pragma unroll
        for (int t = 0; t < VEC; ++t) c.v[t] = (float)count[t];
        *reinterpret_cast<F*>(partial_count + (int64_t)item * K + k) = c;
      }
      continue;
    }
    P o;
    if (OP == kSum) {
#pragma unroll
      for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[t]);
    } else {
      F c;
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        o.v[t] = from_f32<T>(deg == 0 ? 0.f : acc[t]);
        c.v[t] = (float)count[t];  // 0 for a row without edges
      }
      *reinterpret_cast<F*>(ties + (int64_t)q * K + k) = c;
    }
    *reinterpret_cast<P*>(out + (int64_t)q * K + k) = o;
  }
}

struct Args {
  int n, m, K, heads, L, S, J, row0, slot0;
  const int *d_indptr, *d_indices;
  const float* d_vals;
  const void* d_table;
  int64_t d_stride, d_tab_rows;
  const int *h_indptr, *h_indices;
  const float* h_vals;
  const void* h_table;
  int64_t h_stride, h_tab_rows;
  const int *seg_row, *seg_start, *long_rows, *seg_ptr;
  void* out;
  float *ties, *partial, *partial_count;
};

template <typename T, int VEC, int VALS, int OP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const Block<T> d{a.d_indptr, a.d_indices, a.d_vals, (const T*)a.d_table,
                   a.d_stride, a.d_tab_rows};
  const Block<T> h{a.h_indptr, a.h_indices, a.h_vals, (const T*)a.h_table,
                   a.h_stride, a.h_tab_rows};
  const dim3 grid = gespmm::warp_grid(a.S + a.n * a.m, a.K, VEC);
  void (*kernel)(int, int, int, int, int, int, int, Block<T>, Block<T>,
                 const int*, const int*, T*, float*, float*, float*) =
      a.S > 0 ? halo_spmm_kernel<T, VEC, VALS, OP, true>
              : halo_spmm_kernel<T, VEC, VALS, OP, false>;
  kernel<<<grid, kThreads, 0, stream>>>(a.n, a.m, a.K, a.heads, a.L, a.S,
                                        a.row0, d, h, a.seg_row, a.seg_start,
                                        (T*)a.out, a.ties, a.partial,
                                        a.partial_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.J == 0) return err;
  if constexpr (OP == kSum) {
    return gespmm::launch_carry<T, VEC>(a.J, a.K, a.long_rows, a.seg_ptr,
                                        a.partial, (T*)a.out, stream, a.row0,
                                        a.slot0);
  } else {
    return gespmm::launch_minmax_carry<T, VEC, OP == kMax>(
        a.J, a.K, a.long_rows, a.seg_ptr, a.partial, a.partial_count,
        (T*)a.out, a.ties, stream, a.row0, a.slot0);
  }
}

template <int VEC>
bool aligned(const void* p, size_t item) {
  return p == nullptr || (uintptr_t)p % (VEC * item) == 0;
}

template <typename T, int VEC>
cudaError_t run_vec(const Args& a, int op, int vals_kind, cudaStream_t stream) {
  if (a.K % VEC != 0 || !aligned<VEC>(a.d_table, sizeof(T)) ||
      !aligned<VEC>(a.h_table, sizeof(T)) || !aligned<VEC>(a.out, sizeof(T)) ||
      !aligned<VEC>(a.ties, sizeof(float)) ||
      !aligned<VEC>(a.partial, sizeof(float)) ||
      !aligned<VEC>(a.partial_count, sizeof(float)))
    return cudaErrorInvalidValue;
  if (op == kSum) {
    if (vals_kind == kHeads) return launch<T, VEC, kHeads, kSum>(a, stream);
    if (vals_kind == kScalar) return launch<T, VEC, kScalar, kSum>(a, stream);
    return launch<T, VEC, kBinary, kSum>(a, stream);
  }
  if (op == kMax) {
    if (vals_kind == kScalar) return launch<T, VEC, kScalar, kMax>(a, stream);
    return launch<T, VEC, kBinary, kMax>(a, stream);
  }
  if (vals_kind == kScalar) return launch<T, VEC, kScalar, kMin>(a, stream);
  return launch<T, VEC, kBinary, kMin>(a, stream);
}

template <typename T>
cudaError_t run(const Args& a, int vec, int op, cudaStream_t stream) {
  // heads: 0 for a binary matrix, else the values a edge (per-head values,
  // heads > 1, only with sum, and H must divide K).  The pointers of an
  // empty block may be null (PyTorch gives null for an empty tensor), so
  // the kind of values is an argument, not read from them.  Max/min need
  // ties, sum none; segments need a partial buffer (max/min: two) and L.
  if (a.n < 1 || a.m < 1 || a.K < 1 || a.heads < 0 ||
      (a.heads > 0 && a.K % a.heads != 0) || op < kSum || op > kMin ||
      (op != kSum && a.heads > 1) ||
      (a.h_indptr != nullptr && a.h_table == nullptr) ||
      ((op == kSum) != (a.ties == nullptr)) || a.S < 0 || a.J < 0 ||
      (a.S > 0 && (a.L < 1 || a.partial == nullptr ||
                   (op != kSum && a.partial_count == nullptr))))
    return cudaErrorInvalidValue;
  const int vals_kind = a.heads == 0 ? kBinary
                        : a.heads > 1 ? kHeads : kScalar;
  switch (vec) {
    case 4:
      return run_vec<T, 4>(a, op, vals_kind, stream);
    case 2:
      return run_vec<T, 2>(a, op, vals_kind, stream);
    case 1:
      return run_vec<T, 1>(a, op, vals_kind, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// n >= 1 stacked shards of m >= 1 output rows, K >= 1 (the caller returns
// early otherwise); op 0 sum, 1 max, 2 min; heads 0 for a binary matrix
// (d_vals and h_vals unread), else the f32 values a edge.  Each block: its
// (n, m + 1) indptr, its indices and values with `stride` edges a shard, its
// table with `tab_rows` rows a shard.  The halo block may be left out with a
// null h_indptr.  The split: L, S segments (seg_row: stacked rows from row0
// on; seg_start: the first joint position in the row) and J long rows
// (long_rows, seg_ptr: carry slots from slot0 on); S = J = 0 for none.
// ties is the (n * m, K) f32 tie count for max/min and null for sum;
// partial (and, for max/min, partial_count) the (S, K) f32 scratch.
#define GESPMM_HALO_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                        \
      int n, int m, int K, int vec, int op, int heads, int L, int S, int J,   \
      int row0, int slot0, const int* d_indptr, const int* d_indices,         \
      const float* d_vals, const void* d_table, int64_t d_stride,           \
      int64_t d_tab_rows, const int* h_indptr, const int* h_indices,        \
      const float* h_vals, const void* h_table, int64_t h_stride,           \
      int64_t h_tab_rows, const int* seg_row, const int* seg_start,         \
      const int* long_rows, const int* seg_ptr, void* out, float* ties,       \
      float* partial, float* partial_count, void* stream) {                   \
    const Args a{n,         m,         K,          heads,     L,              \
                 S,         J,         row0,       slot0,     d_indptr,       \
                 d_indices, d_vals,    d_table,    d_stride,  d_tab_rows,     \
                 h_indptr,  h_indices, h_vals,     h_table,   h_stride,       \
                 h_tab_rows, seg_row,  seg_start,  long_rows, seg_ptr,        \
                 out,       ties,      partial,    partial_count};            \
    return (int)run<T>(a, vec, op, (cudaStream_t)stream);                     \
  }

GESPMM_HALO_ENTRY(gespmm_halo_spmm_f32, float)
GESPMM_HALO_ENTRY(gespmm_halo_spmm_bf16, __nv_bfloat16)

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
