// Fused CSR SpMM for Hopper (sm_90a):
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
// transactions and at keeping nothing but B rows on the memory bus:
//   * one warp per output row, over a grid-stride loop: the 32 lanes read one
//     B row as one contiguous transaction, each lane VEC consecutive elements
//     (16-byte loads for f32 at VEC=4);
//   * the row's (col, val) pairs are loaded 32 at a time, one per lane, in one
//     coalesced load, and broadcast with __shfl_sync (the coalesced row
//     caching of the GE-SpMM design, with registers in place of shared memory);
//   * each lane owns a VEC-wide slice of K and accumulates it in f32; when
//     K > 32 * VEC a second grid dimension walks the K slabs;
//   * each output element is written once, with no atomics, so the result is
//     deterministic.
// Not here yet: nnz-balanced splitting of hub rows (a warp walks a hub row
// serially), wgmma/TMA staging, and a bf16 contribution stream for "fast".
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows in flight per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kMaxBlocksX = 65535;  // the grid-stride loop covers the rest

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

// VEC consecutive elements, aligned so that one load/store instruction moves
// them all (ld.global.v4.f32 for float at VEC=4).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC, bool HAS_VALS>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(int m, int K, const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ vals, const T* __restrict__ B,
                T* __restrict__ out) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;  // first column of this lane
  // The host picks VEC > 1 only when K % VEC == 0, so k < K covers all VEC.
  const bool active = k < K;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < m;
       row += stride) {
    const int start = indptr[row];
    const int end = indptr[row + 1];
    float acc[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
    for (int base = start; base < end; base += 32) {
      // Everything down to the shuffles is warp-uniform: all 32 lanes take
      // part in every __shfl_sync.
      const int e = base + lane;
      int c = 0;
      float v = 0.f;
      if (e < end) {
        c = __ldg(indices + e);
        if (HAS_VALS) v = __ldg(vals + e);
      }
      const int cnt = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int cj = __shfl_sync(0xffffffffu, c, j);
        float vj = 1.f;
        if (HAS_VALS) vj = __shfl_sync(0xffffffffu, v, j);
        if (active) {
          const P p = *reinterpret_cast<const P*>(B + (int64_t)cj * K + k);
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[t] = fmaf(vj, to_f32(p.v[t]), acc[t]);
        }
      }
    }
    if (active) {
      P o;
#pragma unroll
      for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[t]);
      *reinterpret_cast<P*>(out + (int64_t)row * K + k) = o;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(int m, int K, const int* indptr, const int* indices,
                       const float* vals, const T* B, T* out,
                       cudaStream_t stream) {
  const unsigned rows_blocks = (unsigned)((m + kWarps - 1) / kWarps);
  const dim3 grid(rows_blocks < kMaxBlocksX ? rows_blocks : kMaxBlocksX,
                  (unsigned)((K + 32 * VEC - 1) / (32 * VEC)));
  if (vals != nullptr) {
    spmm_csr_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(
        m, K, indptr, indices, vals, B, out);
  } else {
    spmm_csr_kernel<T, VEC, false><<<grid, kThreads, 0, stream>>>(
        m, K, indptr, indices, nullptr, B, out);
  }
  return cudaGetLastError();
}

// Widest lane vector that divides K and keeps the loads aligned; narrow K
// stays scalar so that all 32 lanes have a column (K=32 -> one per lane).
template <typename T>
cudaError_t launch(int m, int K, const int* indptr, const int* indices,
                   const float* vals, const T* B, T* out, cudaStream_t stream) {
  const uintptr_t addr = (uintptr_t)B | (uintptr_t)out;
  if (K % 4 == 0 && K >= 128 && addr % (4 * sizeof(T)) == 0)
    return launch_vec<T, 4>(m, K, indptr, indices, vals, B, out, stream);
  if (K % 2 == 0 && K >= 64 && addr % (2 * sizeof(T)) == 0)
    return launch_vec<T, 2>(m, K, indptr, indices, vals, B, out, stream);
  return launch_vec<T, 1>(m, K, indptr, indices, vals, B, out, stream);
}

}  // namespace

// m >= 1, K >= 1 (the caller returns early otherwise); vals may be null.
extern "C" int gespmm_spmm_csr_f32(int m, int K, const int* indptr,
                                   const int* indices, const float* vals,
                                   const float* B, float* out, void* stream) {
  return (int)launch<float>(m, K, indptr, indices, vals, B, out,
                            (cudaStream_t)stream);
}

extern "C" int gespmm_spmm_csr_bf16(int m, int K, const int* indptr,
                                    const int* indices, const float* vals,
                                    const void* B, void* out, void* stream) {
  return (int)launch<__nv_bfloat16>(
      m, K, indptr, indices, vals, (const __nv_bfloat16*)B,
      (__nv_bfloat16*)out, (cudaStream_t)stream);
}

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
