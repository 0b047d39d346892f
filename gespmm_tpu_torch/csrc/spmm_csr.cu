// Fused CSR SpMM for Hopper (sm_90a), with long rows split over warps:
//
//     out[r, :] = sum_{e in row r} val_e * B[col_e, :]      (f32 accumulation)
//
// Replaces the sum branch of gespmm_tpu/kernels/spmm_stream.py::_reduce_kernel
// (spmm_stream.py:232-267), launched by _reduce_part (:275, pallas_call :370),
// fed by _gather_part (:401) and driven by spmm_tiled (:428).  On the TPU the
// gathered contributions val_e * B[col_e] were written to device memory by an
// XLA gather and read back by the Pallas reduction.  Here one kernel gathers,
// scales and reduces, and each row's contributions stay in registers.
//
// What bounds it: bytes.  Every nonzero gathers one K-wide row of B (4K bytes
// in f32) for 2K flops, about 0.5 flop per byte, far below the card's ridge
// point.  The gathers are random rows, so the design aims at full, coalesced
// transactions, at many of them in flight, and at no warp walking more than L
// edges:
//   * one walker per work item over a grid-stride loop: the SW lanes of a
//     walker (a warp, or half of one) read one B row as one contiguous
//     transaction, each lane VEC consecutive elements (16-byte loads for f32
//     at VEC=4) of a slab of SW * VEC columns.  A walker holds NS slabs at
//     once and walks the item's edges once for all of them: each edge's
//     index and value are broadcast once and its NS loads issued before
//     their FMAs.  kernels/spmm_csr.py::csr_shape picks (VEC, SW, NS) so
//     that the narrow widths take one walk with few idle lanes: K = 47 on
//     16-lane walkers of three slabs (47 of 48 lanes, two rows a warp),
//     K = 100 at VEC 4 (one slab of 25 lanes).  Where K has more slabs than
//     NS (K = 256: two), a second grid dimension walks the groups of NS;
//   * the items are the segments of the long rows first, then every row.  A
//     row of at most L edges is walked by its own walker and written to out;
//     a longer row is skipped there, and each of its segments (L consecutive
//     edges, from the host-built split list, partition.py::build_row_split)
//     is walked by one walker, which writes an f32 partial sum to its slot of
//     a scratch buffer.  The carry pass of carry.cuh, one warp per long row,
//     adds the row's partials in segment order.  It is launched only when a
//     long row exists, so a graph without one (the GCN slice's sbm) keeps one
//     launch a call.  On a hub-heavy graph the one-warp walk of a hub row
//     (3,866 edges on rmat15) set the whole launch's time;
//   * the (col, val) pairs are loaded SW at a time, one per lane, in one
//     coalesced load, and broadcast with __shfl_sync (the coalesced row
//     caching of the GE-SpMM design, with registers in place of shared
//     memory), the edge loop unrolled 4 deep so that a warp has several B-row
//     loads in flight (deeper batches, 8 rows loaded before their FMAs, were
//     slower on the card at every timed shape: PERF.md, PR 7);
//   * each output element is written once, with no atomics, so the result is
//     deterministic.
// B may be bf16 with an f32 out (mode="fast": B rounded to bf16 once, half the
// gathered bytes, f32 accumulation and output).
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// K % VEC == 0 and B, out and partial aligned to VEC elements), SW and NS.
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it does
// not take.

#include "carry.cuh"

namespace {

using namespace gespmm;  // the launch shape, type helpers and carry pass

// One call's operands: the CSR, its row split (S segments of at most L
// edges, J long rows; S = J = 0 without one), B, out and the (S, K) f32
// scratch of the segments' partial sums.
template <typename TB, typename TO>
struct Call {
  int m, K, L, S, J;
  const int* indptr;
  const int* indices;
  const float* vals;
  const int* seg_row;
  const int* seg_start;
  const int* long_rows;
  const int* seg_ptr;
  const TB* B;
  TO* out;
  float* partial;
  cudaStream_t stream;
};

// The sums of edges [s, t) for this lane's columns of the walker's NS slabs:
// acc[i] for the VEC columns from kk[i] (none where kk[i] >= K: the lane
// loads nothing there and its sums are dropped).  Every lane of the walker
// calls it with the same s and t.  Each edge's (col, val) pair is broadcast
// once and its B row's NS loads are issued before their FMAs; each column is
// summed by fmaf in edge order, so its bits do not depend on the shape.
template <typename TB, int VEC, int SW, int NS, bool HAS_VALS>
__device__ __forceinline__ void walk(const Sub<SW>& w, int s, int t, int K,
                                     const int (&kk)[NS],
                                     const int* __restrict__ indices,
                                     const float* __restrict__ vals,
                                     const TB* __restrict__ B,
                                     float (&acc)[NS][VEC]) {
  using P = Pack<TB, VEC>;
  for (int base = s; base < t; base += SW) {
    // Everything down to the shuffles is walker-uniform: all SW lanes take
    // part in every shuffle.
    const int e = base + w.lane;
    int c = 0;
    float v = 0.f;
    if (e < t) {
      c = __ldg(indices + e);
      if (HAS_VALS) v = __ldg(vals + e);
    }
    const int cnt = min(SW, t - base);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int cj = w.get(c, j);
      float vj = 1.f;
      if (HAS_VALS) vj = w.get(v, j);
      const TB* __restrict__ row = B + (int64_t)cj * K;
      P p[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (kk[i] < K)
          p[i] = *reinterpret_cast<const P*>(row + kk[i]);
        else
          p[i] = P{};
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          acc[i][u] = fmaf(vj, to_f32(p[i].v[u]), acc[i][u]);
    }
  }
}

// SPLIT: the split has segments.  Without (S = 0: no row longer than L) the
// kernel is the plain walker-a-row walk, with no segment test to pay for.
// A walker is SW lanes; blockIdx.y picks its group of NS slabs.
template <typename TB, typename TO, int VEC, int SW, int NS, bool HAS_VALS,
          bool SPLIT>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(int m, int S, int K, int L, const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ vals,
                const int* __restrict__ seg_row,
                const int* __restrict__ seg_start, const TB* __restrict__ B,
                TO* __restrict__ out, float* __restrict__ partial) {
  constexpr int kWalkers = kThreads / SW;
  const Sub<SW> w;
  // The first column of this lane in each slab.  The host picks VEC > 1
  // only when K % VEC == 0, so kk[i] < K covers all VEC.  A lane past K
  // loads nothing: loading the row's last columns in its place, in a sector
  // the walker loads anyway, cost 5% at rmat15 K=256 (PERF.md §6, row 1).
  int kk[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i)
    kk[i] = ((blockIdx.y * NS + i) * SW + w.lane) * VEC;
  const int items = S + m;
  const int stride = gridDim.x * kWalkers;
  for (int item = blockIdx.x * kWalkers + threadIdx.x / SW; item < items;
       item += stride) {
    int s, t;
    if (SPLIT && item < S) {  // a segment of a long row
      s = seg_start[item];
      t = min(s + L, indptr[seg_row[item] + 1]);
    } else {
      s = indptr[item - S];
      t = indptr[item - S + 1];
      if (SPLIT && t - s > L) continue;  // its segments and the carry write it
    }
    float acc[NS][VEC];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[i][u] = 0.f;
    walk<TB, VEC, SW, NS, HAS_VALS>(w, s, t, K, kk, indices, vals, B, acc);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (kk[i] >= K) continue;
      if (SPLIT && item < S) {
        Pack<float, VEC> o;
#pragma unroll
        for (int u = 0; u < VEC; ++u) o.v[u] = acc[i][u];
        *reinterpret_cast<Pack<float, VEC>*>(
            partial + (int64_t)item * K + kk[i]) = o;
      } else {
        Pack<TO, VEC> o;
#pragma unroll
        for (int u = 0; u < VEC; ++u) o.v[u] = from_f32<TO>(acc[i][u]);
        *reinterpret_cast<Pack<TO, VEC>*>(
            out + (int64_t)(item - S) * K + kk[i]) = o;
      }
    }
  }
}

// The main pass on walkers of SW lanes holding NS slabs of SW*VEC columns
// (grid y: the groups of NS slabs), then the carry when a row is long.
template <typename TB, typename TO, int VEC, int SW, int NS>
cudaError_t launch_shape(const Call<TB, TO>& a) {
  if (a.K % VEC != 0 || a.L < 1 || (uintptr_t)a.B % (VEC * sizeof(TB)) != 0 ||
      (uintptr_t)a.out % (VEC * sizeof(TO)) != 0 ||
      (a.S > 0 && (uintptr_t)a.partial % (VEC * sizeof(float)) != 0))
    return cudaErrorInvalidValue;
  constexpr int kWalkers = kThreads / SW;
  const unsigned blocks = (unsigned)((a.S + a.m + kWalkers - 1) / kWalkers);
  const int slabs = (a.K + SW * VEC - 1) / (SW * VEC);
  const dim3 grid(blocks < kMaxBlocksX ? blocks : kMaxBlocksX,
                  (unsigned)((slabs + NS - 1) / NS));
  void (*kernel)(int, int, int, int, const int*, const int*, const float*,
                 const int*, const int*, const TB*, TO*, float*) =
      a.vals != nullptr
          ? (a.S > 0 ? spmm_csr_kernel<TB, TO, VEC, SW, NS, true, true>
                     : spmm_csr_kernel<TB, TO, VEC, SW, NS, true, false>)
          : (a.S > 0 ? spmm_csr_kernel<TB, TO, VEC, SW, NS, false, true>
                     : spmm_csr_kernel<TB, TO, VEC, SW, NS, false, false>);
  kernel<<<grid, kThreads, 0, a.stream>>>(a.m, a.S, a.K, a.L, a.indptr,
                                          a.indices, a.vals, a.seg_row,
                                          a.seg_start, a.B, a.out, a.partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.J == 0) return err;
  return launch_carry<TO, VEC>(a.J, a.K, a.long_rows, a.seg_ptr, a.partial,
                               a.out, a.stream);
}

// The (VEC, SW, NS) that kernels/spmm_csr.py::csr_shape picks: whole warps
// holding one slab at VEC 1, 2 or 4, and 16-lane walkers holding three
// slabs at VEC 1 (33 <= K <= 48).
template <typename TB, typename TO>
cudaError_t launch(const Call<TB, TO>& a, int vec, int sw, int ns) {
  if (vec == 1 && sw == 16 && ns == 3)
    return launch_shape<TB, TO, 1, 16, 3>(a);
  if (sw != 32 || ns != 1) return cudaErrorInvalidValue;
  switch (vec) {
    case 4:
      return launch_shape<TB, TO, 4, 32, 1>(a);
    case 2:
      return launch_shape<TB, TO, 2, 32, 1>(a);
    case 1:
      return launch_shape<TB, TO, 1, 32, 1>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// m >= 1, K >= 1 (the caller returns early otherwise); (vec, sw, ns) the
// walker shape; L the segment length of the split, S its segments and J its
// long rows (S = J = 0: no split, no carry), partial an (S, K) f32 scratch
// buffer; vals may be null (1.0).
#define GESPMM_CSR_ENTRY(NAME, TB, TO)                                        \
  extern "C" int NAME(int m, int K, int vec, int sw, int ns, int L, int S,   \
                      int J,                                                  \
                      const int* indptr, const int* indices,                  \
                      const float* vals, const int* seg_row,                  \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const void* B, void* out,           \
                      float* partial, void* stream) {                         \
    const Call<TB, TO> a{m, K, L, S, J, indptr, indices, vals, seg_row,      \
                         seg_start, long_rows, seg_ptr, (const TB*)B,         \
                         (TO*)out, partial, (cudaStream_t)stream};            \
    return (int)launch<TB, TO>(a, vec, sw, ns);                               \
  }

GESPMM_CSR_ENTRY(gespmm_spmm_csr_f32, float, float)
GESPMM_CSR_ENTRY(gespmm_spmm_csr_bf16, __nv_bfloat16, __nv_bfloat16)
// bf16 B, f32 out: the bf16 stream of mode="fast".
GESPMM_CSR_ENTRY(gespmm_spmm_csr_bf16_f32, __nv_bfloat16, float)

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
