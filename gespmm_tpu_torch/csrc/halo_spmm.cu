// The joint diag+halo SpMM of one shard of the sharded tier, for Hopper
// (sm_90a).  One warp per output row r of the shard:
//
//     out[r, k] = reduce over the diag edges e of r of  val_e * B_shard[col_e, k]
//                 joined with the halo edges e of r of   val_e * halo[col_e, k]
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
// one transposed block with the other left out (h_indptr null): grad_B_shard
// = A_diag^T g and grad_halo = A_halo^T g, values in CSC order.
//
// One launch a shard replaces the TPU's two stream reductions and the add,
// or its two raw reductions, the fold and the tie pass: the warp walks the
// row's diag edges, gathering B_shard rows, then its halo edges, gathering
// halo-table rows, and keeps an f32 sum, or one (extremum, count) pair a
// column, in registers across both walks.  Max/min contributions come from
// minmax.cuh's minmax_contrib, the expression spmm_minmax.cu's backward
// recomputes to find the achieving edges.
//
// What bounds it: bytes, as the CSR sum kernel (spmm_csr.cu): every nonzero
// gathers one K-wide row of its table for 2K flops.  The layout is that
// kernel's: the row's (index, value) pairs load 32 at a time, one per lane,
// and are broadcast with __shfl_sync; each lane owns VEC consecutive columns
// (vector loads); a second grid dimension walks K slabs of 32 * VEC columns.
// Per-head values are read per edge and column group, from L1 (every lane of
// the warp reads the same edge's H values).  Every output element is written
// once, without atomics, so two calls give bitwise-equal results.  Not here
// yet: nnz-balanced splitting of hub rows (a warp walks a hub row serially).
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// K % VEC == 0 and every table aligned to VEC elements).  The caller
// guarantees that every diag index is below B_shard's rows and every halo
// index below the halo table's rows (gespmm_tpu_torch/parallel/halo.py
// builds them so on the host); slots past indptr[m] are never read.  Each
// entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it does
// not take.

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

// Walks the edges [start, end) of one block for the lane's VEC columns,
// folding each contribution into (acc, count).  Warp-uniform down to the
// shuffles: all 32 lanes take part.
template <typename T, int VEC, int VALS, int OP>
__device__ __forceinline__ void walk_block(int start, int end, int K, int k,
                                           bool active, int heads,
                                           const int (&head)[VEC],
                                           const int* __restrict__ indices,
                                           const float* __restrict__ vals,
                                           const T* __restrict__ table,
                                           float (&acc)[VEC], int (&count)[VEC]) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  for (int base = start; base < end; base += 32) {
    const int e = base + lane;
    int c = 0;
    float v = 0.f;
    if (e < end) {
      c = __ldg(indices + e);
      if (VALS == kScalar) v = __ldg(vals + e);
    }
    const int n_here = min(32, end - base);
#pragma unroll 4
    for (int j = 0; j < n_here; ++j) {
      const int cj = __shfl_sync(kFull, c, j);
      float vj = 1.f;
      if (VALS == kScalar) vj = __shfl_sync(kFull, v, j);
      if (active) {
        const P p = *reinterpret_cast<const P*>(table + (int64_t)cj * K + k);
        const float* vh =
            VALS == kHeads ? vals + (int64_t)(base + j) * heads : nullptr;
#pragma unroll
        for (int t = 0; t < VEC; ++t) {
          const float b = to_f32(p.v[t]);
          const float w = VALS == kHeads ? __ldg(vh + head[t]) : vj;
          if (OP == kSum) {
            acc[t] = VALS == kBinary ? acc[t] + b : fmaf(w, b, acc[t]);
          } else {
            gespmm::minmax_fold<OP == kMax>(
                gespmm::minmax_contrib<VALS != kBinary>(w, b), acc[t],
                count[t]);
          }
        }
      }
    }
  }
}

template <typename T, int VEC, int VALS, int OP>
__global__ void __launch_bounds__(kThreads)
halo_spmm_kernel(int m, int K, int heads, const int* __restrict__ d_indptr,
                 const int* __restrict__ d_indices,
                 const float* __restrict__ d_vals, const T* __restrict__ d_table,
                 const int* __restrict__ h_indptr,
                 const int* __restrict__ h_indices,
                 const float* __restrict__ h_vals, const T* __restrict__ h_table,
                 T* __restrict__ out, float* __restrict__ ties) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;  // first column of this lane
  const bool active = k < K;  // K % VEC == 0, so k < K covers all VEC
  // The head of each of the lane's columns (per-head values only).
  int head[VEC];
  const int dh = VALS == kHeads ? K / heads : K;
#pragma unroll
  for (int t = 0; t < VEC; ++t) head[t] = active ? (k + t) / dh : 0;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < m;
       row += stride) {
    float acc[VEC];
    int count[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      acc[t] = OP == kSum ? 0.f : gespmm::minmax_identity<OP == kMax>();
      count[t] = 0;
    }
    const int d_start = d_indptr[row], d_end = d_indptr[row + 1];
    walk_block<T, VEC, VALS, OP>(d_start, d_end, K, k, active, heads, head,
                                 d_indices, d_vals, d_table, acc, count);
    int edges = d_end - d_start;
    if (h_indptr != nullptr) {  // warp-uniform: a launch argument
      const int h_start = h_indptr[row], h_end = h_indptr[row + 1];
      walk_block<T, VEC, VALS, OP>(h_start, h_end, K, k, active, heads, head,
                                   h_indices, h_vals, h_table, acc, count);
      edges += h_end - h_start;
    }
    if (active) {
      P o;
      if (OP == kSum) {
#pragma unroll
        for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[t]);
      } else {
        F n;
#pragma unroll
        for (int t = 0; t < VEC; ++t) {
          o.v[t] = from_f32<T>(edges == 0 ? 0.f : acc[t]);
          n.v[t] = (float)count[t];  // 0 for a row without edges
        }
        *reinterpret_cast<F*>(ties + (int64_t)row * K + k) = n;
      }
      *reinterpret_cast<P*>(out + (int64_t)row * K + k) = o;
    }
  }
}

struct Args {
  int m, K, heads;
  const int *d_indptr, *d_indices;
  const float* d_vals;
  const void* d_table;
  const int *h_indptr, *h_indices;
  const float* h_vals;
  const void* h_table;
  void* out;
  float* ties;
};

template <typename T, int VEC, int VALS, int OP>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid = gespmm::warp_grid(a.m, a.K, VEC);
  halo_spmm_kernel<T, VEC, VALS, OP><<<grid, kThreads, 0, stream>>>(
      a.m, a.K, a.heads, a.d_indptr, a.d_indices, a.d_vals,
      (const T*)a.d_table, a.h_indptr, a.h_indices, a.h_vals,
      (const T*)a.h_table, (T*)a.out, a.ties);
}

template <int VEC>
bool aligned(const void* p, size_t item) {
  return p == nullptr || (uintptr_t)p % (VEC * item) == 0;
}

template <typename T, int VEC>
cudaError_t run_vec(const Args& a, int op, int vals_kind, cudaStream_t stream) {
  if (a.K % VEC != 0 || !aligned<VEC>(a.d_table, sizeof(T)) ||
      !aligned<VEC>(a.h_table, sizeof(T)) || !aligned<VEC>(a.out, sizeof(T)) ||
      !aligned<VEC>(a.ties, sizeof(float)))
    return cudaErrorInvalidValue;
  if (op == kSum) {
    if (vals_kind == kHeads) {
      launch<T, VEC, kHeads, kSum>(a, stream);
    } else if (vals_kind == kScalar) {
      launch<T, VEC, kScalar, kSum>(a, stream);
    } else {
      launch<T, VEC, kBinary, kSum>(a, stream);
    }
  } else if (op == kMax) {
    if (vals_kind == kScalar) {
      launch<T, VEC, kScalar, kMax>(a, stream);
    } else {
      launch<T, VEC, kBinary, kMax>(a, stream);
    }
  } else {
    if (vals_kind == kScalar) {
      launch<T, VEC, kScalar, kMin>(a, stream);
    } else {
      launch<T, VEC, kBinary, kMin>(a, stream);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Args& a, int vec, int op, cudaStream_t stream) {
  // heads: 0 for a binary matrix, else the values a edge (per-head values,
  // heads > 1, only with sum, and H must divide K).  The pointers of an
  // empty block may be null (PyTorch gives null for an empty tensor), so
  // the kind of values is an argument, not read from them.  Max/min need
  // ties, sum none.
  if (a.m < 1 || a.K < 1 || a.heads < 0 ||
      (a.heads > 0 && a.K % a.heads != 0) || op < kSum || op > kMin ||
      (op != kSum && a.heads > 1) ||
      (a.h_indptr != nullptr && a.h_table == nullptr) ||
      ((op == kSum) != (a.ties == nullptr)))
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

// m >= 1 output rows, K >= 1 (the caller returns early otherwise); op 0 sum,
// 1 max, 2 min; heads 0 for a binary matrix (d_vals and h_vals unread), else
// the f32 values a edge, (nnz, heads) row-major in both blocks.  The halo
// block (h_indptr, h_indices, h_vals, h_table) may be left out with a null
// h_indptr.  ties is the (m, K) f32 tie count for max/min and null for sum.
extern "C" int gespmm_halo_spmm_f32(int m, int K, int vec, int op, int heads,
                                    const int* d_indptr, const int* d_indices,
                                    const float* d_vals, const float* d_table,
                                    const int* h_indptr, const int* h_indices,
                                    const float* h_vals, const float* h_table,
                                    float* out, float* ties, void* stream) {
  const Args a{m, K, heads, d_indptr, d_indices, d_vals, d_table, h_indptr,
               h_indices, h_vals, h_table, out, ties};
  return (int)run<float>(a, vec, op, (cudaStream_t)stream);
}

extern "C" int gespmm_halo_spmm_bf16(int m, int K, int vec, int op, int heads,
                                     const int* d_indptr, const int* d_indices,
                                     const float* d_vals, const void* d_table,
                                     const int* h_indptr, const int* h_indices,
                                     const float* h_vals, const void* h_table,
                                     void* out, float* ties, void* stream) {
  const Args a{m, K, heads, d_indptr, d_indices, d_vals, d_table, h_indptr,
               h_indices, h_vals, h_table, out, ties};
  return (int)run<__nv_bfloat16>(a, vec, op, (cudaStream_t)stream);
}

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
