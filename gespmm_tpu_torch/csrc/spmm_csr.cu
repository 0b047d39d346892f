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
//   * one warp per work item over a grid-stride loop: the 32 lanes read one
//     B row as one contiguous transaction, each lane VEC consecutive elements
//     (16-byte loads for f32 at VEC=4); when K > 32 * VEC a second grid
//     dimension walks the K slabs;
//   * the items are the segments of the long rows first, then every row.  A
//     row of at most L edges is walked by its own warp and written to out; a
//     longer row is skipped there, and each of its segments (L consecutive
//     edges, from the host-built split list, partition.py::build_row_split)
//     is walked by one warp, which writes an f32 partial sum to its slot of
//     a scratch buffer.  The carry pass of carry.cuh, one warp per long row,
//     adds the row's partials in segment order.  It is launched only when a
//     long row exists, so a graph without one (the GCN slice's sbm) keeps one
//     launch a call.  On a hub-heavy graph the one-warp walk of a hub row
//     (3,866 edges on rmat15) set the whole launch's time;
//   * the (col, val) pairs are loaded 32 at a time, one per lane, in one
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
// K % VEC == 0 and B, out and partial aligned to VEC elements).  Each entry
// point launches on the given stream, does not synchronise, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not take.

#include "carry.cuh"

namespace {

using namespace gespmm;  // the launch shape, type helpers and carry pass

constexpr unsigned kFull = 0xffffffffu;

// The sum of edges [s, t) for this lane's columns; every lane of the warp
// calls it with the same s and t.
template <typename TB, int VEC, bool HAS_VALS>
__device__ __forceinline__ void walk(int s, int t, int K, int k, bool active,
                                     const int* __restrict__ indices,
                                     const float* __restrict__ vals,
                                     const TB* __restrict__ B,
                                     float (&acc)[VEC]) {
  using P = Pack<TB, VEC>;
  const int lane = threadIdx.x & 31;
  for (int base = s; base < t; base += 32) {
    // Everything down to the shuffles is warp-uniform: all 32 lanes take
    // part in every __shfl_sync.
    const int e = base + lane;
    int c = 0;
    float v = 0.f;
    if (e < t) {
      c = __ldg(indices + e);
      if (HAS_VALS) v = __ldg(vals + e);
    }
    const int cnt = min(32, t - base);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int cj = __shfl_sync(kFull, c, j);
      float vj = 1.f;
      if (HAS_VALS) vj = __shfl_sync(kFull, v, j);
      if (active) {
        const P p = *reinterpret_cast<const P*>(B + (int64_t)cj * K + k);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(vj, to_f32(p.v[i]), acc[i]);
      }
    }
  }
}

// SPLIT: the split has segments.  Without (S = 0: no row longer than L) the
// kernel is the plain one-warp-a-row walk, with no segment test to pay for.
template <typename TB, typename TO, int VEC, bool HAS_VALS, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(int m, int S, int K, int L, const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ vals,
                const int* __restrict__ seg_row,
                const int* __restrict__ seg_start, const TB* __restrict__ B,
                TO* __restrict__ out, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;  // first column of this lane
  // The host picks VEC > 1 only when K % VEC == 0, so k < K covers all VEC.
  const bool active = k < K;
  const int items = S + m;
  const int stride = gridDim.x * kWarps;
  for (int item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < items;
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
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    walk<TB, VEC, HAS_VALS>(s, t, K, k, active, indices, vals, B, acc);
    if (!active) continue;
    if (SPLIT && item < S) {
      Pack<float, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = acc[i];
      *reinterpret_cast<Pack<float, VEC>*>(partial + (int64_t)item * K + k) = o;
    } else {
      Pack<TO, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<TO>(acc[i]);
      *reinterpret_cast<Pack<TO, VEC>*>(out + (int64_t)(item - S) * K + k) = o;
    }
  }
}

template <typename TB, typename TO, int VEC>
cudaError_t launch_vec(int m, int K, int L, int S, int J, const int* indptr,
                       const int* indices, const float* vals,
                       const int* seg_row, const int* seg_start,
                       const int* long_rows, const int* seg_ptr, const TB* B,
                       TO* out, float* partial, cudaStream_t stream) {
  if (K % VEC != 0 || L < 1 || (uintptr_t)B % (VEC * sizeof(TB)) != 0 ||
      (uintptr_t)out % (VEC * sizeof(TO)) != 0 ||
      (S > 0 && (uintptr_t)partial % (VEC * sizeof(float)) != 0))
    return cudaErrorInvalidValue;
  const dim3 grid = warp_grid(S + m, K, VEC);
  void (*kernel)(int, int, int, int, const int*, const int*, const float*,
                 const int*, const int*, const TB*, TO*, float*) =
      vals != nullptr ? (S > 0 ? spmm_csr_kernel<TB, TO, VEC, true, true>
                               : spmm_csr_kernel<TB, TO, VEC, true, false>)
                      : (S > 0 ? spmm_csr_kernel<TB, TO, VEC, false, true>
                               : spmm_csr_kernel<TB, TO, VEC, false, false>);
  kernel<<<grid, kThreads, 0, stream>>>(m, S, K, L, indptr, indices, vals,
                                        seg_row, seg_start, B, out, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || J == 0) return err;
  return launch_carry<TO, VEC>(J, K, long_rows, seg_ptr, partial, out, stream);
}

template <typename TB, typename TO>
cudaError_t launch(int m, int K, int vec, int L, int S, int J,
                   const int* indptr, const int* indices, const float* vals,
                   const int* seg_row, const int* seg_start,
                   const int* long_rows, const int* seg_ptr, const TB* B,
                   TO* out, float* partial, cudaStream_t stream) {
  switch (vec) {
    case 4:
      return launch_vec<TB, TO, 4>(m, K, L, S, J, indptr, indices, vals,
                                   seg_row, seg_start, long_rows, seg_ptr, B,
                                   out, partial, stream);
    case 2:
      return launch_vec<TB, TO, 2>(m, K, L, S, J, indptr, indices, vals,
                                   seg_row, seg_start, long_rows, seg_ptr, B,
                                   out, partial, stream);
    case 1:
      return launch_vec<TB, TO, 1>(m, K, L, S, J, indptr, indices, vals,
                                   seg_row, seg_start, long_rows, seg_ptr, B,
                                   out, partial, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// m >= 1, K >= 1 (the caller returns early otherwise); L the segment length
// of the split, S its segments and J its long rows (S = J = 0: no split, no
// carry), partial an (S, K) f32 scratch buffer; vals may be null (1.0).
#define GESPMM_CSR_ENTRY(NAME, TB, TO)                                        \
  extern "C" int NAME(int m, int K, int vec, int L, int S, int J,             \
                      const int* indptr, const int* indices,                  \
                      const float* vals, const int* seg_row,                  \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const void* B, void* out,           \
                      float* partial, void* stream) {                         \
    return (int)launch<TB, TO>(m, K, vec, L, S, J, indptr, indices, vals,     \
                               seg_row, seg_start, long_rows, seg_ptr,        \
                               (const TB*)B, (TO*)out, partial,               \
                               (cudaStream_t)stream);                         \
  }

GESPMM_CSR_ENTRY(gespmm_spmm_csr_f32, float, float)
GESPMM_CSR_ENTRY(gespmm_spmm_csr_bf16, __nv_bfloat16, __nv_bfloat16)
// bf16 B, f32 out: the bf16 stream of mode="fast".
GESPMM_CSR_ENTRY(gespmm_spmm_csr_bf16_f32, __nv_bfloat16, float)

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
