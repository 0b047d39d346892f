// What the split attention walks share (gat_fused.cu, dot_attention.cu,
// edge_reduce.cu): the work list of a row split, the launch of one walker an
// item, and the softmax carry that merges a long row's segment states.
//
// The work items of one launch are the S segments of the long rows first
// (sparse/partition.py::build_row_split: L consecutive edges each), then
// every row.  A row of at most L edges is walked whole by its own walker and
// written out; a longer row is skipped there, its segments write partial
// states to their slots of a scratch buffer, and a carry pass, one warp per
// long row, merges the slots in segment order.  Every output element is
// written once, without atomics, so a call is bitwise repeatable.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "carry.cuh"

namespace gespmm {

// gespmm_tpu/kernels/gat_fused.py's _EXP_FLOOR and _DENOM_EPS.
constexpr float kExpFloor = -80.f;
constexpr float kDenomEps = 1e-20f;

// The edges [s, t) of work item `item`: segment item of a long row, or row
// item - S.  False for a long row, which its segments and the carry write.
struct Item {
  int row, s, t;
};

__device__ __forceinline__ bool item_edges(int item, int S, int L,
                                           const int* __restrict__ indptr,
                                           const int* __restrict__ seg_row,
                                           const int* __restrict__ seg_start,
                                           Item& it) {
  if (item < S) {
    it.row = seg_row[item];
    it.s = seg_start[item];
    it.t = min(it.s + L, indptr[it.row + 1]);
    return true;
  }
  it.row = item - S;
  it.s = indptr[it.row];
  it.t = indptr[it.row + 1];
  return S == 0 || it.t - it.s <= L;
}

// The split of one launch: segment length, segments, long rows and the
// host-built lists (partition.py::RowSplit).
struct Split {
  int L, S, J;
  const int *seg_row, *seg_start, *long_rows, *seg_ptr;
};

inline bool bad_split(const Split& sp) {
  return sp.L < 1 || sp.S < 0 || sp.J < 0 || (sp.S > 0) != (sp.J > 0);
}

// One walker of sw lanes per item over a grid-stride loop.
inline dim3 item_grid(int items, int sw) {
  const int per_block = kThreads / sw;
  const unsigned blocks = (unsigned)((items + per_block - 1) / per_block);
  return dim3(blocks < kMaxBlocksX ? blocks : kMaxBlocksX);
}

// The softmax carry: one warp per long row merges its segments' (m, zsum,
// acc) in segment order and writes out, den and (exact) mx: M = max m_i,
// den = max(sum zsum_i e^(m_i - M), 1e-20), out = sum acc_i e^(m_i - M) / den,
// per head of dh columns (H = 1, dh = K for dot attention).  A long row has
// edges, so M is finite; in the bound mode every factor is 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
softmax_carry_kernel(int J, int K, int H, int dh, int exact,
                     const int* __restrict__ long_rows,
                     const int* __restrict__ seg_ptr,
                     const float* __restrict__ pm,
                     const float* __restrict__ pz,
                     const float* __restrict__ pacc, T* __restrict__ out,
                     float* __restrict__ mx, float* __restrict__ den) {
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;
  if (k >= K) return;  // no shuffles below: idle lanes may leave
  const int hd = k / dh;
  const int stride = gridDim.x * kWarps;
  for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < J; j += stride) {
    const int s0 = seg_ptr[j], s1 = seg_ptr[j + 1];
    float M = 0.f;
    if (exact) {
      M = -CUDART_INF_F;
      for (int s = s0; s < s1; ++s) M = fmaxf(M, pm[(int64_t)s * H + hd]);
    }
    float zsum = 0.f, acc[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
    for (int s = s0; s < s1; ++s) {
      const float f = exact ? expf(pm[(int64_t)s * H + hd] - M) : 1.f;
      zsum = fmaf(pz[(int64_t)s * H + hd], f, zsum);
      const F p = *reinterpret_cast<const F*>(pacc + (int64_t)s * K + k);
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = fmaf(p.v[t], f, acc[t]);
    }
    const int64_t row = long_rows[j];
    const float d = fmaxf(zsum, kDenomEps);
    Pack<T, VEC> o;
#pragma unroll
    for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[t] / d);
    *reinterpret_cast<Pack<T, VEC>*>(out + row * K + k) = o;
    if (k % dh == 0) {
      den[row * H + hd] = d;
      if (exact) mx[row * H + hd] = M;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_softmax_carry(int J, int K, int H, int exact,
                                 const int* long_rows, const int* seg_ptr,
                                 const float* pm, const float* pz,
                                 const float* pacc, T* out, float* mx,
                                 float* den, cudaStream_t stream) {
  softmax_carry_kernel<T, VEC><<<warp_grid(J, K, VEC), kThreads, 0, stream>>>(
      J, K, H, K / H, exact, long_rows, seg_ptr, pm, pz, pacc, out, mx, den);
  return cudaGetLastError();
}

}  // namespace gespmm
