// Max/min CSR SpMM with exact tie counts, and its backward over the CSC, for
// Hopper (sm_90a).
//
// Forward (kernel row 2), over the CSR:
//
//     out[r, k]  = max|min_{e in row r} val_e * B[col_e, k]   (0 for an empty row)
//     ties[r, k] = #{e in row r : val_e * B[col_e, k] == that extremum}   (f32)
//
// Replaces the max/min branch of gespmm_tpu/kernels/spmm_stream.py::
// _reduce_kernel (spmm_stream.py:123-228) with want_ties, launched through
// _reduce_part (:275) by spmm_tiled(reduce="max"/"min") (:428).  The TPU has
// no per-row accumulator on its matrix unit, so it scans each chunk of the
// gathered stream with a segmented shift-scan of (value, count) pairs and
// scatters each run's last slot through a one-hot matmul.  Here a walker owns
// a row and each lane keeps a running (extremum, count) pair per column in
// registers: a strictly better contribution resets the count to 1, an equal
// one adds 1.  Nothing is scanned and nothing of the stream reaches memory.
// Its design is the backward's below:
//   * the work items are the segments of the rows longer than L edges first
//     (the CSR's split, sparse/partition.py::build_row_split), then every
//     row.  A row of at most L edges is walked whole by one walker and
//     written to out and ties; a longer one is skipped there, and each of
//     its segments is walked by its own walker, which writes its (extremum,
//     count) pair in f32 to its slot of two scratch buffers; carry.cuh's
//     pair carry (minmax_carry_kernel, minmax.cuh::minmax_fold_pair) folds
//     a row's pairs in segment order, which gives the one-walker walk's out
//     and ties bit for bit.  The carry is launched only when the launch has
//     a segment (sbm-pubmed without self-loops has none: its longest row has
//     15 edges).  The first port walked every row with one warp, so the
//     3,866-edge hub of rmat15 was one warp's serial walk;
//   * the walk is carry.cuh::walk_edges, shared with the chunk kernel: a
//     walker of SW = 4-32 lanes (walk_shape; at K = 16 a 4-lane walker of
//     16-byte lanes, eight rows a warp, where one warp a row left half the
//     lanes idle), the B rows of kFwdBatch = 4 edges gathered before any
//     compare, with no branch around a gather;
//   * a launch without segments whose walkers are whole warps (K >= 128)
//     runs the first port's kernel instead (one warp a row, the edges one at
//     a time under `#pragma unroll 4`), 1-2% faster there at sbm K=128.
//
// Backward (kernel row 3), over the CSC (the rows of A^T), from the
// cotangent g and the forward's out and ties:
//
//     w_e[k]       = [val_e * B[c, k] == out[r_e, k]] * g[r_e, k] / max(ties[r_e, k], 1)
//     grad_B[c, k] = sum_{e in col c} val_e * w_e[k]
//     grad_val[e]  = sum_k w_e[k] * B[c, k]            (CSC order)
//
// Replaces the weight stream of spmm_minmax_vjp_tiled (spmm_stream.py:920;
// reduced through _reduce_part at :1014; grad_val is XLA there, :1025).  The
// TPU recounted ties in a first pass (:974) unless the forward gave them; the
// forward kernel here always does.  The JAX design folds g / ties into one
// row-space table so that a slot gathers one table, not several
// (:985-992); here the fold happens inside the kernel, per achieving edge,
// with the IEEE division (__fdiv_rn of g cast to f32 by fmaxf(ties, 1)),
// bitwise the table that torch's g.float() / clamp(ties, min=1) forms, so
// no (m, K) f32 table is written and read back before the walk.
//
// The achievement test must find exactly the edges the forward chose, so
// the forwards form a contribution with minmax.cuh's minmax_contrib (one
// f32 product, __fmul_rn(val, B), or B itself for a binary matrix), the
// expression the joint diag+halo forward (halo_spmm.cu) uses too.  out is
// compared as stored (in B's dtype, cast up), as gespmm_tpu's reference VJP
// does.
//
// What bounds them: bytes.  The forward reads one K-wide B row per nonzero
// as the sum kernel does (spmm_csr.cu), with a compare and a select in place
// of an FMA; each lane owns VEC consecutive columns (vector loads), and a
// second grid dimension walks K slabs of SW * VEC columns.  The backward
// gathers three row-space rows per nonzero (out, g and ties) and reads B
// once per column.  Its design is that of the split walks of spmm_csr.cu and
// gat_fused.cu:
//   * the work items are the segments of the columns longer than L edges
//     first (the host-built split, sparse/partition.py::build_row_split, or
//     build_shard_split for stacked shards), then every column.  A column of
//     at most L edges is walked whole by one walker and written to grad_B; a
//     longer one is skipped there, and each of its segments is walked by its
//     own walker, which writes an f32 partial of grad_B to its slot of a
//     scratch buffer; carry.cuh's sum carry adds a column's partials in
//     segment order.  The carry is launched only when the launch has a
//     segment (sbm-pubmed has none: its longest column has 15 edges).
//     grad_val is per edge, so a segment writes its edges' values itself;
//   * a walker is SW = 4, 8, 16 or 32 lanes of a warp, the fewest that cover
//     K / VEC columns (kernels/spmm_csr.py::walk_shape, the rule of the
//     fused GAT kernels): at K = 16 a 4-lane walker with 16-byte lanes walks
//     8 columns a warp, at K = 128 one warp walks one column;
//   * each lane of a walker loads one edge's (row, value) of a round of SW,
//     broadcast by shuffle; the out, g and ties rows of kBatch = 2 edges are
//     gathered before any is compared, with no branch around a gather: the
//     round's last edge loaded again in place of edges past its end, column
//     0 for lanes past K (an `if (active)` load in an unrolled loop compiled
//     to a branch around each gather in halo_spmm.cu).  Deeper batches hold
//     more registers, fewer warps fit an SM, and a short column's chain of
//     dependent loads (colptr, rows, the rows of out, g and ties) is what
//     the warps overlap (4 and 8 edges were slower, and so were register
//     caps: scripts/row3_ab.py --variants, recorded in PERF.md).  B[c] is
//     loaded once per item and stays in registers;
//   * g and ties are gathered by every lane, not only where a column
//     achieves the output: a 16-byte lane of 4 columns at ~4 edges a column
//     needs them about 2/3 of the time, and the lazy loads' branch cost more
//     than the sectors they skipped (scripts/row3_ab.py builds that variant;
//     its times are in PERF.md);
//   * one launch may cover n stacked shards (the sharded tier's max/min
//     backward over one transposed block): shard i's colptr row, its edges
//     at i * stride, its rows of out/g/ties at i * out_rows, its columns'
//     rows of B and grad_B at i * cols;
//   * every output element is written once, without atomics: grad_val is
//     reduced across a walker's lanes with a fixed butterfly and across K
//     slabs by the caller in slab order, so two calls agree bit for bit.
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// K % VEC == 0 and every table aligned to VEC elements) and SW (for the
// backward, so that it knows the slab count of the grad_val partials).
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it does
// not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "carry.cuh"
#include "minmax.cuh"

namespace {

using gespmm::dispatch;  // (VEC, SW) -> the instantiation
using gespmm::from_f32;
using gespmm::kMaxBlocksX;
using gespmm::kThreads;
using gespmm::kWarps;
using gespmm::Pack;
using gespmm::Sub;
using gespmm::to_f32;

constexpr int kBatch = 2;  // edges whose rows are gathered before a compare
// ... in the forward, which gathers one table: 4 was the fastest of 1, 2 and 4
// at sbm K=128 and K=16 and rmat15 K=128 (scripts/row2_ab.py --variants).
constexpr int kFwdBatch = 4;

// A lane's running (extremum, count) pairs of its VEC columns.
template <typename T, int VEC, bool HAS_VALS, bool IS_MAX>
struct MinmaxFold {
  float best[VEC];
  int count[VEC];
  __device__ __forceinline__ void operator()(float v, const Pack<T, VEC>& b) {
#pragma unroll
    for (int x = 0; x < VEC; ++x)
      gespmm::minmax_fold<IS_MAX>(
          gespmm::minmax_contrib<HAS_VALS>(v, to_f32(b.v[x])), best[x],
          count[x]);
  }
};

// The forward's launch: the CSR of m rows, and its split: segments [0, S)
// (seg_row, seg_start: the segment's first edge, absolute) of the J rows
// above L edges (long_rows, seg_ptr: carry slots); best and count are the
// segments' (S, K) f32 (extremum, count) pairs.
template <typename T>
struct Fwd {
  int m, K, L, S, J;
  const int *indptr, *indices;
  const float* vals;
  const int *seg_row, *seg_start, *long_rows, *seg_ptr;
  const T* B;
  T* out;
  float *ties, *best, *count;
};

// SPLIT: the launch has segments.  Without (S = 0) the kernel is the plain
// walker-a-row walk, with no segment test to pay for (the test cost 1.4-2.2%
// at sbm K=16: scripts/row2_ab.py --variants, "one kernel").
template <typename T, int VEC, int SW, bool HAS_VALS, bool IS_MAX, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
spmm_minmax_kernel(const Fwd<T> a) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  const int K = a.K;
  const int k = (blockIdx.y * SW + w.lane) * VEC;  // first column of this lane
  const bool active = k < K;  // K % VEC == 0, so k < K covers all VEC
  const int kk = active ? k : 0;  // a lane past K reads column 0, drops it
  const int items = a.S + a.m;
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < items;
       item += gridDim.x * kPerBlock) {
    const bool seg = SPLIT && item < a.S;
    int row, s, t;  // the edges [s, t) of row `row` this walker walks
    if (seg) {
      row = a.seg_row[item];
      s = a.seg_start[item];
      t = min(s + a.L, a.indptr[row + 1]);
    } else {
      row = item - a.S;
      s = a.indptr[row];
      t = a.indptr[row + 1];
      if (SPLIT && t - s > a.L) continue;  // its segments and the carry
    }
    MinmaxFold<T, VEC, HAS_VALS, IS_MAX> f;
#pragma unroll
    for (int x = 0; x < VEC; ++x) {
      f.best[x] = gespmm::minmax_identity<IS_MAX>();
      f.count[x] = 0;
    }
    gespmm::walk_edges<T, VEC, SW, kFwdBatch, HAS_VALS>(
        w, s, t, K, kk, a.indices, a.vals, a.B, f);
    if (!active) continue;
    F n;
#pragma unroll
    for (int x = 0; x < VEC; ++x) n.v[x] = (float)f.count[x];  // 0 if empty
    if (seg) {
      F e;
#pragma unroll
      for (int x = 0; x < VEC; ++x) e.v[x] = f.best[x];
      *reinterpret_cast<F*>(a.best + (int64_t)item * K + k) = e;
      *reinterpret_cast<F*>(a.count + (int64_t)item * K + k) = n;
      continue;
    }
    P o;
#pragma unroll
    for (int x = 0; x < VEC; ++x) o.v[x] = from_f32<T>(t == s ? 0.f : f.best[x]);
    *reinterpret_cast<P*>(a.out + (int64_t)row * K + k) = o;
    *reinterpret_cast<F*>(a.ties + (int64_t)row * K + k) = n;
  }
}

// The first port's forward, one warp a row and the edges one at a time
// under `#pragma unroll 4`, kept for a launch of whole-warp walkers (K >=
// 128) without segments: there it beat the batched walker by 1-2% in six
// A/B pairs at sbm K=128, and no batch depth, tail or loop of the walker
// matched it (scripts/row2_ab.py --variants --pairs 3; PERF.md).
template <typename T, int VEC, bool HAS_VALS, bool IS_MAX>
__global__ void __launch_bounds__(kThreads)
spmm_minmax_row_kernel(const Fwd<T> a) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;  // first column of this lane
  const bool active = k < a.K;  // K % VEC == 0, so k < K covers all VEC
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < a.m;
       row += stride) {
    const int start = a.indptr[row];
    const int end = a.indptr[row + 1];
    float best[VEC];
    int count[VEC];
#pragma unroll
    for (int x = 0; x < VEC; ++x) {
      best[x] = gespmm::minmax_identity<IS_MAX>();
      count[x] = 0;
    }
    for (int base = start; base < end; base += 32) {
      // Warp-uniform down to the shuffles: all 32 lanes take part.
      const int e = base + lane;
      int c = 0;
      float v = 0.f;
      if (e < end) {
        c = __ldg(a.indices + e);
        if (HAS_VALS) v = __ldg(a.vals + e);
      }
      const int n_here = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < n_here; ++j) {
        const int cj = __shfl_sync(0xffffffffu, c, j);
        float vj = 1.f;
        if (HAS_VALS) vj = __shfl_sync(0xffffffffu, v, j);
        if (active) {
          const P p = *reinterpret_cast<const P*>(a.B + (int64_t)cj * a.K + k);
#pragma unroll
          for (int x = 0; x < VEC; ++x) {
            gespmm::minmax_fold<IS_MAX>(
                gespmm::minmax_contrib<HAS_VALS>(vj, to_f32(p.v[x])), best[x],
                count[x]);
          }
        }
      }
    }
    if (active) {
      const bool empty = end == start;
      P o;
      F n;
#pragma unroll
      for (int x = 0; x < VEC; ++x) {
        o.v[x] = from_f32<T>(empty ? 0.f : best[x]);
        n.v[x] = (float)count[x];  // 0 for an empty row
      }
      *reinterpret_cast<P*>(a.out + (int64_t)row * a.K + k) = o;
      *reinterpret_cast<F*>(a.ties + (int64_t)row * a.K + k) = n;
    }
  }
}

// The backward's launch: n >= 1 stacked shards of `cols` columns each.
// Shard i: colptr row i (cols + 1 entries), rows and vals from i * stride
// on, rows of out/g/ties from i * out_rows on, rows of B and grad_B from i *
// cols on (column q = i * cols + c).  The split: segments [0, S) (seg_row:
// stacked columns from row0 on; seg_start: the first edge, relative to the
// column's first edge when seg_rel, else absolute) and J long columns
// (long_rows, seg_ptr: carry slots from slot0 on).
template <typename T>
struct Vjp {
  int n, cols, K, L, S, J, row0, slot0, seg_rel;
  int64_t stride, out_rows;
  const int *colptr, *rows;
  const float* vals;
  const T *B, *out, *g;
  const float* ties;
  const int *seg_row, *seg_start, *long_rows, *seg_ptr;
  T* grad_B;
  float *grad_vals, *partial;
};

// SPLIT: the launch has segments.  Without (S = 0) the kernel is the plain
// walker-a-column walk, with no segment test to pay for.
template <typename T, int VEC, int SW, bool HAS_VALS, bool WANT_VALS,
          bool SPLIT>
__global__ void __launch_bounds__(kThreads)
spmm_minmax_vjp_kernel(const Vjp<T> a) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  const int K = a.K;
  const int k = (blockIdx.y * SW + w.lane) * VEC;  // first column of this lane
  const bool active = k < K;  // K % VEC == 0, so k < K covers all VEC
  const int kk = active ? k : 0;  // a lane past K reads column 0, drops it
  // This slab's row of the (slabs, n * stride) grad_val partials.
  float* const gv =
      WANT_VALS ? a.grad_vals + (int64_t)blockIdx.y * a.n * a.stride : nullptr;
  const int items = a.S + a.n * a.cols;
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < items;
       item += gridDim.x * kPerBlock) {
    const bool seg = SPLIT && item < a.S;
    const int q = seg ? a.seg_row[item] - a.row0 : item - a.S;
    const int i = q / a.cols, c = q - i * a.cols;
    const int* cp = a.colptr + (int64_t)i * (a.cols + 1) + c;
    const int start = cp[0], end = cp[1];
    int s = start, t = end;  // the edges this walker walks
    if (seg) {
      s = a.seg_start[item] + (a.seg_rel ? start : 0);
      t = min(s + a.L, end);
    } else if (SPLIT && end - start > a.L) {
      continue;  // its segments and the carry write it
    }
    const int64_t e0 = (int64_t)i * a.stride;  // shard i's first edge slot
    const int* __restrict__ r_of = a.rows + e0;
    const float* __restrict__ v_of = HAS_VALS ? a.vals + e0 : nullptr;
    const int64_t t0 = (int64_t)i * a.out_rows * K + kk;
    const T* __restrict__ o_tab = a.out + t0;
    const T* __restrict__ g_tab = a.g + t0;
    const float* __restrict__ n_tab = a.ties + t0;
    float b[VEC], acc[VEC];
    {
      const P p = *reinterpret_cast<const P*>(a.B + (int64_t)q * K + kk);
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        b[u] = to_f32(p.v[u]);
        acc[u] = 0.f;
      }
    }
    for (int base = s; base < t; base += SW) {
      // Walker-uniform down to the shuffles: all SW lanes take part.
      const int e = base + w.lane;
      const bool live = e < t;
      const int r = live ? __ldg(r_of + e) : 0;
      const float v = HAS_VALS && live ? __ldg(v_of + e) : 0.f;
      const int n_here = min(SW, t - base);
      for (int u0 = 0; u0 < n_here; u0 += kBatch) {
        int64_t off[kBatch];
        float vj[kBatch];
        P o[kBatch], gg[kBatch];
        F nn[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = min(u0 + u, n_here - 1);  // past the end: the last edge
          off[u] = (int64_t)w.get(r, j) * K;
          vj[u] = HAS_VALS ? w.get(v, j) : 1.f;
          o[u] = *reinterpret_cast<const P*>(o_tab + off[u]);
          gg[u] = *reinterpret_cast<const P*>(g_tab + off[u]);
          nn[u] = *reinterpret_cast<const F*>(n_tab + off[u]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool edge = u0 + u < n_here;  // walker-uniform
          bool hit[VEC];
#pragma unroll
          for (int x = 0; x < VEC; ++x)
            hit[x] = active && edge &&
                     gespmm::minmax_contrib<HAS_VALS>(vj[u], b[x]) ==
                         to_f32(o[u].v[x]);
          float part = 0.f;
#pragma unroll
          for (int x = 0; x < VEC; ++x) {
            const float wt =
                hit[x] ? __fdiv_rn(to_f32(gg[u].v[x]), fmaxf(nn[u].v[x], 1.f))
                       : 0.f;
            acc[x] = HAS_VALS ? fmaf(wt, vj[u], acc[x]) : acc[x] + wt;
            if (WANT_VALS) part = fmaf(wt, b[x], part);
          }
          if (WANT_VALS) {
            part = w.sum(part);
            if (w.lane == 0 && edge) gv[e0 + base + u0 + u] = part;
          }
        }
      }
    }
    if (!active) continue;
    if (seg) {
      F p;
#pragma unroll
      for (int x = 0; x < VEC; ++x) p.v[x] = acc[x];
      *reinterpret_cast<F*>(a.partial + (int64_t)item * K + k) = p;
    } else {
      P p;
#pragma unroll
      for (int x = 0; x < VEC; ++x) p.v[x] = from_f32<T>(acc[x]);
      *reinterpret_cast<P*>(a.grad_B + (int64_t)q * K + k) = p;
    }
  }
}

// Whether p (null too) is aligned to `bytes`.
bool aligned(const void* p, size_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

template <typename T, int VEC, int SW, bool HAS_VALS, bool IS_MAX>
cudaError_t launch_fwd(const Fwd<T>& a, cudaStream_t stream) {
  constexpr int kPerBlock = kThreads / SW;
  const int items = a.S + a.m;
  const unsigned blocks = (unsigned)((items + kPerBlock - 1) / kPerBlock);
  const dim3 grid(blocks < kMaxBlocksX ? blocks : kMaxBlocksX,
                  (unsigned)((a.K + SW * VEC - 1) / (SW * VEC)));
  if (a.S > 0) {
    spmm_minmax_kernel<T, VEC, SW, HAS_VALS, IS_MAX, true>
        <<<grid, kThreads, 0, stream>>>(a);
  } else if constexpr (SW == 32) {
    spmm_minmax_row_kernel<T, VEC, HAS_VALS, IS_MAX>
        <<<grid, kThreads, 0, stream>>>(a);
  } else {
    spmm_minmax_kernel<T, VEC, SW, HAS_VALS, IS_MAX, false>
        <<<grid, kThreads, 0, stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.J == 0) return err;
  return gespmm::launch_minmax_carry<T, VEC, IS_MAX>(
      a.J, a.K, a.long_rows, a.seg_ptr, a.best, a.count, a.out, a.ties,
      stream, 0, 0);
}

template <typename T>
cudaError_t forward(const Fwd<T>& a, int vec, int sw, int is_max,
                    cudaStream_t stream) {
  const bool bad =
      a.m < 1 || a.K < 1 || vec < 1 || a.K % vec != 0 || a.S < 0 || a.J < 0 ||
      (a.S > 0) != (a.J > 0) ||
      (a.S > 0 && (a.L < 1 || a.best == nullptr || a.count == nullptr)) ||
      !aligned(a.B, vec * sizeof(T)) || !aligned(a.out, vec * sizeof(T)) ||
      !aligned(a.ties, vec * sizeof(float)) ||
      !aligned(a.best, vec * sizeof(float)) ||
      !aligned(a.count, vec * sizeof(float));
  if (bad) return cudaErrorInvalidValue;
  return dispatch(vec, sw, [&](auto v, auto s) -> cudaError_t {
    constexpr int VEC = decltype(v)::value, SW = decltype(s)::value;
    if (a.vals != nullptr) {
      return is_max ? launch_fwd<T, VEC, SW, true, true>(a, stream)
                    : launch_fwd<T, VEC, SW, true, false>(a, stream);
    }
    return is_max ? launch_fwd<T, VEC, SW, false, true>(a, stream)
                  : launch_fwd<T, VEC, SW, false, false>(a, stream);
  });
}

template <typename T, int VEC, int SW, bool HAS_VALS, bool WANT_VALS>
cudaError_t launch_vjp(const Vjp<T>& a, cudaStream_t stream) {
  constexpr int kPerBlock = kThreads / SW;
  const int items = a.S + a.n * a.cols;
  const unsigned blocks = (unsigned)((items + kPerBlock - 1) / kPerBlock);
  const dim3 grid(blocks < kMaxBlocksX ? blocks : kMaxBlocksX,
                  (unsigned)((a.K + SW * VEC - 1) / (SW * VEC)));
  if (a.S > 0) {
    spmm_minmax_vjp_kernel<T, VEC, SW, HAS_VALS, WANT_VALS, true>
        <<<grid, kThreads, 0, stream>>>(a);
  } else {
    spmm_minmax_vjp_kernel<T, VEC, SW, HAS_VALS, WANT_VALS, false>
        <<<grid, kThreads, 0, stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.J == 0) return err;
  return gespmm::launch_carry<T, VEC>(a.J, a.K, a.long_rows, a.seg_ptr,
                                      a.partial, a.grad_B, stream, a.row0,
                                      a.slot0);
}

template <typename T>
cudaError_t backward(const Vjp<T>& a, int vec, int sw, cudaStream_t stream) {
  const bool bad =
      a.n < 1 || a.cols < 1 || a.K < 1 || vec < 1 || a.K % vec != 0 ||
      a.stride < 0 || a.out_rows < 0 || a.S < 0 || a.J < 0 ||
      (a.S > 0) != (a.J > 0) ||
      (a.S > 0 && (a.L < 1 || a.partial == nullptr)) ||
      (a.grad_vals != nullptr && a.vals == nullptr) ||
      (uintptr_t)a.B % (vec * sizeof(T)) != 0 ||
      (uintptr_t)a.out % (vec * sizeof(T)) != 0 ||
      (uintptr_t)a.g % (vec * sizeof(T)) != 0 ||
      (uintptr_t)a.grad_B % (vec * sizeof(T)) != 0 ||
      (uintptr_t)a.ties % (vec * sizeof(float)) != 0 ||
      (uintptr_t)a.partial % (vec * sizeof(float)) != 0;
  if (bad) return cudaErrorInvalidValue;
  return dispatch(vec, sw, [&](auto v, auto s) -> cudaError_t {
    constexpr int VEC = decltype(v)::value, SW = decltype(s)::value;
    if (a.grad_vals != nullptr)
      return launch_vjp<T, VEC, SW, true, true>(a, stream);
    if (a.vals != nullptr)
      return launch_vjp<T, VEC, SW, true, false>(a, stream);
    return launch_vjp<T, VEC, SW, false, false>(a, stream);
  });
}

}  // namespace

// Forward: m >= 1, K >= 1, nnz >= 1 (the caller returns early otherwise);
// vals may be null (a binary matrix); is_max is 1 for max, 0 for min; the
// SW-lane walker.  The split as Fwd documents it: L, S segments and J long
// rows, S = J = 0 for none, else best and count are (S, K) f32 scratch.
#define GESPMM_FWD_ENTRY(NAME, T)                                             \
  extern "C" int NAME(int m, int K, int vec, int sw, int is_max, int L,       \
                      int S, int J, const int* indptr, const int* indices,    \
                      const float* vals, const int* seg_row,                  \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const void* B, void* out,           \
                      float* ties, float* best, float* count, void* stream) { \
    const Fwd<T> a{m,         K,         L,        S,          J,             \
                   indptr,    indices,   vals,     seg_row,    seg_start,     \
                   long_rows, seg_ptr,   (const T*)B, (T*)out, ties,          \
                   best,      count};                                         \
    return (int)forward<T>(a, vec, sw, is_max, (cudaStream_t)stream);         \
  }

GESPMM_FWD_ENTRY(gespmm_spmm_minmax_f32, float)
GESPMM_FWD_ENTRY(gespmm_spmm_minmax_bf16, __nv_bfloat16)

// Backward over n >= 1 stacked CSCs of cols >= 1 columns (colptr (n, cols +
// 1), rows and vals (n, stride), vals in CSC order; n = 1 for one matrix),
// K >= 1, with the SW-lane walker: out and g (B's dtype) and ties (f32) are
// (n * out_rows, K), B and grad_B (n * cols, K).  grad_vals, if not null, is
// a (ceil(K / (SW * vec)), n * stride) f32 buffer of per-slab partials that
// the caller sums over slabs (slots past a shard's edges are not written);
// it needs vals.  The split as Vjp documents it; S = J = 0 for none, else
// partial is the (S, K) f32 scratch buffer.
#define GESPMM_VJP_ENTRY(NAME, T)                                             \
  extern "C" int NAME(                                                        \
      int n, int cols, int K, int vec, int sw, int L, int S, int J, int row0, \
      int slot0, int seg_rel, int64_t stride, int64_t out_rows,               \
      const int* colptr, const int* rows, const float* vals, const void* B,   \
      const void* out, const void* g, const float* ties, const int* seg_row,  \
      const int* seg_start, const int* long_rows, const int* seg_ptr,         \
      void* grad_B, float* grad_vals, float* partial, void* stream) {         \
    const Vjp<T> a{n,        cols,      K,         L,           S,           \
                   J,        row0,      slot0,     seg_rel,     stride,      \
                   out_rows, colptr,    rows,      vals,        (const T*)B, \
                   (const T*)out, (const T*)g, ties, seg_row,   seg_start,   \
                   long_rows, seg_ptr,  (T*)grad_B, grad_vals,  partial};    \
    return (int)backward<T>(a, vec, sw, (cudaStream_t)stream);                \
  }

GESPMM_VJP_ENTRY(gespmm_spmm_minmax_vjp_f32, float)
GESPMM_VJP_ENTRY(gespmm_spmm_minmax_vjp_bf16, __nv_bfloat16)

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
