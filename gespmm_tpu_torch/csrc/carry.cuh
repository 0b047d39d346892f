// The carry pass of the chunked and split SpMM kernels (spmm_chunk.cu,
// spmm_grouped.cu, spmm_csr.cu, halo_spmm.cu, spmm_minmax.cu, gat_fused.cu)
// and the helpers they share: the launch shape, type helpers, the walker and
// its batched edge walk.
//
// Both kernels walk a work list of chunks cut from the CSR edges
// (gespmm_tpu_torch/sparse/partition.py): a row cut by a chunk boundary leaves
// one f32 partial sum per chunk in its slot of a scratch buffer, and the carry
// pass, one warp per cut row, adds the row's slots in chunk order and writes
// the sum to out.  Every output element is written once, without atomics, so
// the result is bitwise repeatable.  The plan's row lists (_row_lists) give
// both kernels the same slots, so one carry serves both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "minmax.cuh"

namespace gespmm {

// The warp-per-item launch shape: 8 warps a block, a grid-stride loop over
// the items past kMaxBlocksX blocks.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kMaxBlocksX = 65535;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A walker: SW consecutive lanes of a warp (SW = 4, 8, 16 or 32), with
// shuffles over its own lanes only, so that the walkers of one warp may
// take different trip counts.
template <int SW>
struct Sub {
  int lane;
  unsigned mask;
  __device__ Sub()
      : lane(threadIdx.x & (SW - 1)),
        mask(SW == 32 ? 0xffffffffu
                      : ((1u << (SW & 31)) - 1u) << (threadIdx.x & 31 & ~(SW - 1))) {}
  template <typename V>
  __device__ V get(V x, int j) const { return __shfl_sync(mask, x, j, SW); }
  __device__ float down(float x, int d) const {
    return __shfl_down_sync(mask, x, d, SW);
  }
  __device__ float max(float x) const {
#pragma unroll
    for (int s = SW / 2; s > 0; s >>= 1)
      x = fmaxf(x, __shfl_xor_sync(mask, x, s, SW));
    return x;
  }
  // The walker's total, in every lane, by a fixed butterfly.
  __device__ float sum(float x) const {
#pragma unroll
    for (int s = SW / 2; s > 0; s >>= 1) x += __shfl_xor_sync(mask, x, s, SW);
    return x;
  }
  __device__ void sync() const { __syncwarp(mask); }
};

// Walks the edges [s, t) of one item with the walker w, its lanes on the VEC
// columns from kk (column 0 for a lane past K, whose result the caller
// drops), calling fold(value, row) for each edge's gathered B row in edge
// order (value 1.0 without vals); fold is a functor whose operator() is
// __forceinline__, so that its running state stays in registers.
// Walker-uniform down to the shuffles: all SW lanes take part.  Each round
// loads the (index, value) pairs of SW edges, one a lane; the B rows of
// BATCH edges are gathered before any is folded, with no branch around a
// gather (past the round's end its last edge is loaded again and not
// folded), so that a walker keeps BATCH gathers in flight: an `if (active)`
// load in an unrolled one-edge loop compiles to a branch around each gather,
// one in flight (halo_spmm.cu, PERF.md).  With TAIL < BATCH a round's edges
// go in whole batches of BATCH and the rest in batches of TAIL, so that a
// round's end loads fewer rows past it (the chunk kernel's whole-warp
// walker).  Used by the chunk kernel (spmm_chunk.cu) and the max/min forward
// (spmm_minmax.cu).
template <typename T, int VEC, int SW, int N, bool HAS_VALS, typename Fold>
__device__ __forceinline__ void gather_fold(const Sub<SW>& w, int u0,
                                            int n_here, int c, float v,
                                            const T* __restrict__ col, int K,
                                            Fold& fold) {
  using P = Pack<T, VEC>;
  P p[N];
  float vj[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int j = min(u0 + u, n_here - 1);  // past the end: the last edge
    vj[u] = HAS_VALS ? w.get(v, j) : 1.f;
    p[u] = *reinterpret_cast<const P*>(col + (int64_t)w.get(c, j) * K);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (u0 + u < n_here) fold(vj[u], p[u]);  // walker-uniform
  }
}

template <typename T, int VEC, int SW, int BATCH, bool HAS_VALS,
          int TAIL = BATCH, typename Fold>
__device__ __forceinline__ void walk_edges(const Sub<SW>& w, int s, int t,
                                           int K, int kk,
                                           const int* __restrict__ indices,
                                           const float* __restrict__ vals,
                                           const T* __restrict__ B,
                                           Fold& fold) {
  const T* __restrict__ col = B + kk;
  for (int base = s; base < t; base += SW) {
    const int e = base + w.lane;
    const bool live = e < t;
    const int c = live ? __ldg(indices + e) : 0;
    const float v = HAS_VALS && live ? __ldg(vals + e) : 1.f;
    const int n_here = min(SW, t - base);
    int u0 = 0;
    if constexpr (TAIL < BATCH) {
      for (; u0 + BATCH <= n_here; u0 += BATCH)
        gather_fold<T, VEC, SW, BATCH, HAS_VALS>(w, u0, n_here, c, v, col, K,
                                                 fold);
    }
    for (; u0 < n_here; u0 += TAIL)
      gather_fold<T, VEC, SW, TAIL, HAS_VALS>(w, u0, n_here, c, v, col, K,
                                              fold);
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls fn(Int<VEC>, Int<SW>) for VEC in {1, 2, 4} and SW in {4, 8, 16, 32}:
// the host side of the walker kernels, from the (VEC, SW) the wrapper picks
// (kernels/spmm_csr.py::walk_shape).
template <int VEC, typename Fn>
cudaError_t dispatch_sw(int sw, Fn&& fn) {
  switch (sw) {
    case 32:
      return fn(Int<VEC>(), Int<32>());
    case 16:
      return fn(Int<VEC>(), Int<16>());
    case 8:
      return fn(Int<VEC>(), Int<8>());
    case 4:
      return fn(Int<VEC>(), Int<4>());
  }
  return cudaErrorInvalidValue;
}

template <typename Fn>
cudaError_t dispatch(int vec, int sw, Fn&& fn) {
  switch (vec) {
    case 4:
      return dispatch_sw<4>(sw, fn);
    case 2:
      return dispatch_sw<2>(sw, fn);
    case 1:
      return dispatch_sw<1>(sw, fn);
  }
  return cudaErrorInvalidValue;
}

// One warp per item, its lanes on VEC consecutive columns of a 32*VEC-wide K
// slab; the second grid dimension walks the slabs.
inline dim3 warp_grid(int items, int K, int vec) {
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  return dim3(blocks < kMaxBlocksX ? blocks : kMaxBlocksX,
              (unsigned)((K + 32 * vec - 1) / (32 * vec)));
}

// The carry: one warp per cut row, its partials added in chunk order.  The
// lists may be a slice of longer ones (one launch over some of the shards
// of halo_spmm.cu): cut row j writes out row cut_rows[j] - row0 from the
// partial slots cut_ptr[j] - slot0 onwards.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_carry_kernel(int J, int K, int row0, int slot0,
                  const int* __restrict__ cut_rows,
                  const int* __restrict__ cut_ptr,
                  const float* __restrict__ partial, T* __restrict__ out) {
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;
  if (k >= K) return;  // no shuffles below: idle lanes may leave
  const int stride = gridDim.x * kWarps;
  for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < J; j += stride) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    const int end = cut_ptr[j + 1] - slot0;
    for (int slot = cut_ptr[j] - slot0; slot < end; ++slot) {
      const F p = *reinterpret_cast<const F*>(partial + (int64_t)slot * K + k);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += p.v[i];
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i]);
    *reinterpret_cast<Pack<T, VEC>*>(
        out + (int64_t)(cut_rows[j] - row0) * K + k) = o;
  }
}

// Launches the carry over J >= 1 cut rows on the stream; partial is the
// (cut_ptr[J] - slot0, K) f32 scratch buffer, aligned to VEC floats.
template <typename T, int VEC>
cudaError_t launch_carry(int J, int K, const int* cut_rows,
                         const int* cut_ptr, const float* partial, T* out,
                         cudaStream_t stream, int row0 = 0, int slot0 = 0) {
  spmm_carry_kernel<T, VEC><<<warp_grid(J, K, VEC), kThreads, 0, stream>>>(
      J, K, row0, slot0, cut_rows, cut_ptr, partial, out);
  return cudaGetLastError();
}

// The pair carry of a split max/min row: one warp per cut row folds its
// segments' (extremum, count) pairs in segment order (minmax_fold_pair) and
// writes out and the tie count.  A cut row has edges, so nothing is masked.
template <typename T, int VEC, bool IS_MAX>
__global__ void __launch_bounds__(kThreads)
minmax_carry_kernel(int J, int K, int row0, int slot0,
                    const int* __restrict__ cut_rows,
                    const int* __restrict__ cut_ptr,
                    const float* __restrict__ best,
                    const float* __restrict__ count, T* __restrict__ out,
                    float* __restrict__ ties) {
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;
  if (k >= K) return;
  const int stride = gridDim.x * kWarps;
  for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < J; j += stride) {
    float b[VEC], n[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      b[i] = minmax_identity<IS_MAX>();
      n[i] = 0.f;
    }
    const int end = cut_ptr[j + 1] - slot0;
    for (int slot = cut_ptr[j] - slot0; slot < end; ++slot) {
      const int64_t at = (int64_t)slot * K + k;
      const F x = *reinterpret_cast<const F*>(best + at);
      const F c = *reinterpret_cast<const F*>(count + at);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        minmax_fold_pair<IS_MAX>(x.v[i], c.v[i], b[i], n[i]);
    }
    Pack<T, VEC> o;
    F t;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      o.v[i] = from_f32<T>(b[i]);
      t.v[i] = n[i];
    }
    const int64_t at = (int64_t)(cut_rows[j] - row0) * K + k;
    *reinterpret_cast<Pack<T, VEC>*>(out + at) = o;
    *reinterpret_cast<F*>(ties + at) = t;
  }
}

template <typename T, int VEC, bool IS_MAX>
cudaError_t launch_minmax_carry(int J, int K, const int* cut_rows,
                                const int* cut_ptr, const float* best,
                                const float* count, T* out, float* ties,
                                cudaStream_t stream, int row0, int slot0) {
  minmax_carry_kernel<T, VEC, IS_MAX>
      <<<warp_grid(J, K, VEC), kThreads, 0, stream>>>(
          J, K, row0, slot0, cut_rows, cut_ptr, best, count, out, ties);
  return cudaGetLastError();
}

}  // namespace gespmm
