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
//   * one warp per row, over a grid-stride loop; the lanes walk the row's
//     edges, lane i taking edges start + i, start + i + 32, ...;
//   * a lane keeps KC running values (KC columns at a time, a loop over
//     column chunks for K > KC) in f32 registers;
//   * the 32 lanes' values are combined by a fixed xor-shuffle tree, so the
//     result is the same on every run;
//   * each output element is written once, by the lane that owns it.
// Not here yet: several short rows per warp (a degree-5 row keeps 5 of 32
// lanes busy) and an nnz-balanced split of hub rows.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows in flight per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kMaxBlocks = 65535;  // a grid-stride loop covers the rest
constexpr unsigned kFull = 0xffffffffu;
constexpr int KC = 4;  // columns a lane carries at once

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

template <typename T, bool IS_MAX>
__global__ void __launch_bounds__(kThreads)
edge_reduce_kernel(int m, int K, const int* __restrict__ indptr,
                   const T* __restrict__ vals, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const float init = IS_MAX ? -CUDART_INF_F : 0.f;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < m;
       row += stride) {
    const int start = indptr[row];
    const int end = indptr[row + 1];
    for (int k0 = 0; k0 < K; k0 += KC) {
      float acc[KC];
#pragma unroll
      for (int t = 0; t < KC; ++t) acc[t] = init;
      for (int e = start + lane; e < end; e += 32) {
        const T* v = vals + (int64_t)e * K + k0;
#pragma unroll
        for (int t = 0; t < KC; ++t) {
          if (k0 + t < K) {
            const float x = to_f32(__ldg(v + t));
            acc[t] = IS_MAX ? fmaxf(acc[t], x) : acc[t] + x;
          }
        }
      }
      // The same butterfly on every lane: all 32 end with the warp's value.
#pragma unroll
      for (int t = 0; t < KC; ++t) {
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
          const float o = __shfl_xor_sync(kFull, acc[t], s);
          acc[t] = IS_MAX ? fmaxf(acc[t], o) : acc[t] + o;
        }
      }
      float mine = acc[0];
#pragma unroll
      for (int t = 1; t < KC; ++t) mine = lane == t ? acc[t] : mine;
      if (lane < KC && k0 + lane < K) {
        if (IS_MAX && !isfinite(mine)) mine = 0.f;
        out[(int64_t)row * K + k0 + lane] = from_f32<T>(mine);
      }
    }
  }
}

template <typename T>
cudaError_t launch(int m, int K, int is_max, const int* indptr, const T* vals,
                   T* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((m + kWarps - 1) / kWarps);
  const dim3 grid(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  if (is_max) {
    edge_reduce_kernel<T, true><<<grid, kThreads, 0, stream>>>(m, K, indptr,
                                                               vals, out);
  } else {
    edge_reduce_kernel<T, false><<<grid, kThreads, 0, stream>>>(m, K, indptr,
                                                                vals, out);
  }
  return cudaGetLastError();
}

}  // namespace

// m >= 1, K >= 1 (the caller returns early otherwise); vals is (nnz, K) in
// CSR order and out (m, K), both contiguous; is_max is 1 for max, 0 for sum.
extern "C" int gespmm_edge_reduce_f32(int m, int K, int is_max,
                                      const int* indptr, const float* vals,
                                      float* out, void* stream) {
  return (int)launch<float>(m, K, is_max, indptr, vals, out,
                            (cudaStream_t)stream);
}

extern "C" int gespmm_edge_reduce_bf16(int m, int K, int is_max,
                                       const int* indptr, const void* vals,
                                       void* out, void* stream) {
  return (int)launch<__nv_bfloat16>(m, K, is_max, indptr,
                                    (const __nv_bfloat16*)vals,
                                    (__nv_bfloat16*)out, (cudaStream_t)stream);
}

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
