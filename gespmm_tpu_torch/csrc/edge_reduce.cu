// Per-row sum or max of CSR-ordered edge values, for Hopper (sm_90a):
//
//     out[r, k] = sum|max_{e in row r} vals[e, k]      (f32 accumulation)
//
// with a non-finite max (an empty row) written as 0.  Replaces the
// _reduce_part pass of gespmm_tpu/kernels/spmm_stream.py::edge_segment_reduce
// (spmm_stream.py:816), which on the TPU gathered the (nnz, K) values into
// the plan's slot order (an XLA take, through device memory) and reduced
// them with the Pallas stream kernel's one-hot matmul.  Here the values are
// already in CSR order, so each row's segment is one contiguous run of
// memory and nothing is gathered.  It backs edge_softmax (its max and its
// normalizer forward, its row sum backward) and the backward of
// additive_attention_logits (over the CSR and over the CSC).
//
// What bounds it: bytes, and at the graphs' sizes launch latency.  Every
// value is read once and does one add or compare; K is the head count (1
// to 8), so a row is a few dozen bytes.  The design reads each row's run
// coalesced and reduces it without atomics:
//   * a walker of SW = 4-32 lanes a row (carry.cuh's Sub), so that a warp
//     walks several short rows (kernels/edge_reduce.py::walk_width: the
//     smallest that covers half the mean degree, at least 8 where K > KC);
//     lane i takes edges s + i, s + i + SW, ...;
//   * the rows above L edges are split (attention.cuh: the segments are work
//     items before the rows, sparse/partition.py::build_row_split); a
//     segment writes its K-wide partial to a scratch slot, and a carry pass
//     adds a long row's slots in segment order (carry.cuh's sum carry) or
//     takes their maximum (max_carry_kernel).  No carry is launched when the
//     split has no segment (sbm-pubmed);
//   * a lane keeps KC running values (KC columns at a time, a loop over
//     column chunks for K > KC) in f32 registers; the value loads never sit
//     behind a branch: a column past K loads column K - 1 again and drops it;
//   * the walker's values are combined by a fixed xor-shuffle tree, so the
//     result is the same on every run; each output element is written once.
// A split row's sum is taken in another order than the unsplit walk's, so
// it differs from it in rounding; a max is exact either way.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

using gespmm::from_f32;
using gespmm::Int;
using gespmm::item_edges;
using gespmm::item_grid;
using gespmm::Item;
using gespmm::kThreads;
using gespmm::kWarps;
using gespmm::Split;
using gespmm::Sub;
using gespmm::to_f32;

constexpr int KC = 4;  // columns a lane carries at once (edge_reduce.py's KC)

template <typename T, bool IS_MAX, int SW>
__global__ void __launch_bounds__(kThreads)
edge_reduce_kernel(int m, int S, int K, int L, const int* __restrict__ indptr,
                   const int* __restrict__ seg_row,
                   const int* __restrict__ seg_start,
                   const T* __restrict__ vals, T* __restrict__ out,
                   float* __restrict__ part) {
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  const float init = IS_MAX ? -CUDART_INF_F : 0.f;
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + m;
       item += gridDim.x * kPerBlock) {
    Item it;
    if (!item_edges(item, S, L, indptr, seg_row, seg_start, it)) continue;
    for (int k0 = 0; k0 < K; k0 += KC) {
      int col[KC];
      float acc[KC];
#pragma unroll
      for (int t = 0; t < KC; ++t) {
        col[t] = min(k0 + t, K - 1);
        acc[t] = init;
      }
#pragma unroll 4
      for (int e = it.s + w.lane; e < it.t; e += SW) {
        const T* v = vals + (int64_t)e * K;
#pragma unroll
        for (int t = 0; t < KC; ++t) {
          const float x = to_f32(__ldg(v + col[t]));
          acc[t] = IS_MAX ? fmaxf(acc[t], x) : acc[t] + x;
        }
      }
      // The same butterfly on every lane: all SW end with the walker's value.
#pragma unroll
      for (int t = 0; t < KC; ++t) acc[t] = IS_MAX ? w.max(acc[t]) : w.sum(acc[t]);
      float mine = acc[0];
#pragma unroll
      for (int t = 1; t < KC; ++t) mine = w.lane == t ? acc[t] : mine;
      if (w.lane < KC && k0 + w.lane < K) {
        if (item < S) {
          part[(int64_t)item * K + k0 + w.lane] = mine;
        } else {
          if (IS_MAX && !isfinite(mine)) mine = 0.f;
          out[(int64_t)it.row * K + k0 + w.lane] = from_f32<T>(mine);
        }
      }
    }
  }
}

// The max carry: one warp per long row takes the maximum of its segments'
// partials in segment order (a long row has edges; a non-finite maximum is
// written as 0, as for a whole row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
max_carry_kernel(int J, int K, const int* __restrict__ long_rows,
                 const int* __restrict__ seg_ptr,
                 const float* __restrict__ part, T* __restrict__ out) {
  const int k = blockIdx.y * 32 + (threadIdx.x & 31);
  if (k >= K) return;
  const int stride = gridDim.x * kWarps;
  for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < J; j += stride) {
    float best = -CUDART_INF_F;
    for (int s = seg_ptr[j]; s < seg_ptr[j + 1]; ++s)
      best = fmaxf(best, part[(int64_t)s * K + k]);
    if (!isfinite(best)) best = 0.f;
    out[(int64_t)long_rows[j] * K + k] = from_f32<T>(best);
  }
}

template <typename T>
cudaError_t launch(int m, int K, int is_max, int sw, const Split& sp,
                   const int* indptr, const T* vals, T* out, float* part,
                   cudaStream_t stream) {
  if (K < 1 || gespmm::bad_split(sp)) return cudaErrorInvalidValue;
  auto walk = [&](auto W) {
    constexpr int SW = decltype(W)::value;
    const dim3 grid = item_grid(sp.S + m, SW);
    if (is_max)
      edge_reduce_kernel<T, true, SW><<<grid, kThreads, 0, stream>>>(
          m, sp.S, K, sp.L, indptr, sp.seg_row, sp.seg_start, vals, out, part);
    else
      edge_reduce_kernel<T, false, SW><<<grid, kThreads, 0, stream>>>(
          m, sp.S, K, sp.L, indptr, sp.seg_row, sp.seg_start, vals, out, part);
    return cudaGetLastError();
  };
  cudaError_t err;
  switch (sw) {
    case 32: err = walk(Int<32>()); break;
    case 16: err = walk(Int<16>()); break;
    case 8: err = walk(Int<8>()); break;
    case 4: err = walk(Int<4>()); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || sp.J == 0) return err;
  if (!is_max)
    return gespmm::launch_carry<T, 1>(sp.J, K, sp.long_rows, sp.seg_ptr, part,
                                      out, stream);
  max_carry_kernel<T><<<gespmm::warp_grid(sp.J, K, 1), kThreads, 0, stream>>>(
      sp.J, K, sp.long_rows, sp.seg_ptr, part, out);
  return cudaGetLastError();
}

}  // namespace

// m >= 1, K >= 1 (the caller returns early otherwise); vals is (nnz, K) in
// the edge order of indptr and out (m, K), both contiguous; is_max is 1 for
// max, 0 for sum; sw (4, 8, 16 or 32) lanes a walker.  The split of indptr:
// segment length L, S segments and J long rows (S = J = 0: no split, no
// carry) with the lists seg_row, seg_start (S), long_rows (J) and seg_ptr
// (J + 1); part is an (S, K) f32 scratch buffer (null when S = 0).
#define GESPMM_EDGE_REDUCE(NAME, T)                                           \
  extern "C" int NAME(int m, int K, int is_max, int sw, int L, int S, int J,  \
                      const int* seg_row, const int* seg_start,               \
                      const int* long_rows, const int* seg_ptr,               \
                      const int* indptr, const void* vals, void* out,         \
                      float* part, void* stream) {                            \
    return (int)launch<T>(m, K, is_max, sw,                                   \
                          Split{L, S, J, seg_row, seg_start, long_rows,       \
                                seg_ptr},                                     \
                          indptr, (const T*)vals, (T*)out, part,              \
                          (cudaStream_t)stream);                              \
  }

GESPMM_EDGE_REDUCE(gespmm_edge_reduce_f32, float)
GESPMM_EDGE_REDUCE(gespmm_edge_reduce_bf16, __nv_bfloat16)

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
