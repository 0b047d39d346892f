// Max/min CSR SpMM with exact tie counts, and its backward over the CSC, for
// Hopper (sm_90a).
//
// Forward, one warp per CSR row r:
//
//     out[r, k]  = max|min_{e in row r} val_e * B[col_e, k]   (0 for an empty row)
//     ties[r, k] = #{e in row r : val_e * B[col_e, k] == that extremum}   (f32)
//
// Replaces the max/min branch of gespmm_tpu/kernels/spmm_stream.py::
// _reduce_kernel (spmm_stream.py:123-228) with want_ties, launched through
// _reduce_part (:275) by spmm_tiled(reduce="max"/"min") (:428).  The TPU has
// no per-row accumulator on its matrix unit, so it scans each chunk of the
// gathered stream with a segmented shift-scan of (value, count) pairs and
// scatters each run's last slot through a one-hot matmul.  Here a warp owns a
// row and each lane keeps a running (extremum, count) pair per column in
// registers: a strictly better contribution resets the count to 1, an equal
// one adds 1.  Nothing is scanned and nothing of the stream reaches memory.
//
// Backward, one warp per CSC column c (a row of A^T), for the table
// gt = g / max(ties, 1) that the caller folds first (spmm_stream.py:989):
//
//     w_e[k]       = [val_e * B[c, k] == out[r_e, k]] * gt[r_e, k]
//     grad_B[c, k] = sum_{e in col c} val_e * w_e[k]
//     grad_val[e]  = sum_k w_e[k] * B[c, k]            (CSC order)
//
// Replaces the weight stream of spmm_minmax_vjp_tiled (spmm_stream.py:920;
// reduced through _reduce_part at :1014; grad_val is XLA there, :1025).  The
// TPU recounted ties in a first pass (:974) unless the forward gave them; the
// forward kernel here always does.  B[c] is loaded once per column and stays
// in registers; each edge gathers two row-space tables, out and gt.
//
// The achievement test must find exactly the edges the forward chose, so
// both kernels form the contribution with minmax.cuh's minmax_contrib (one
// f32 product, __fmul_rn(val, B), or B itself for a binary matrix), the
// expression the joint diag+halo forward (halo_spmm.cu) uses too.  out is
// compared as stored (in B's dtype, cast up), as gespmm_tpu's reference VJP
// does.
//
// What bounds them: bytes.  The forward reads one K-wide B row per nonzero
// as the sum kernel does (spmm_csr.cu), with a compare and a select in
// place of an FMA.  The backward reads two rows per nonzero (out and gt,
// about 3x the forward's bytes with B's dtype at bf16).  The layout follows
// spmm_csr.cu: the row's (index, value) pairs load 32 at a time, one per
// lane, and are broadcast with __shfl_sync; each lane owns VEC consecutive
// columns (vector loads), and a second grid dimension walks K slabs of
// 32 * VEC columns.  Every output element is written once, without atomics.
// grad_val is reduced across the lanes of a slab with a fixed shuffle tree
// and across slabs by the caller in slab order, so it is deterministic too.
// Not here yet: nnz-balanced splitting of hub rows and columns.
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// K % VEC == 0 and every table aligned to VEC elements), so that it knows
// the slab count of the grad_val partials.  Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "minmax.cuh"

namespace {

// The launch shape and the type helpers are those of spmm_csr.cu; each
// source stays self-contained, as the package ships csrc/*.cu alone.
constexpr int kThreads = 256;  // 8 warps, 8 rows in flight per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kMaxBlocksX = 65535;  // a grid-stride loop covers the rest
constexpr unsigned kFull = 0xffffffffu;

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

// One warp per row over a grid-stride loop in x, one 32*VEC-wide K slab per
// grid row in y.
dim3 warp_per_row_grid(int rows, int K, int vec) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  return dim3(blocks < kMaxBlocksX ? blocks : kMaxBlocksX,
              (unsigned)((K + 32 * vec - 1) / (32 * vec)));
}

template <typename T, int VEC, bool HAS_VALS, bool IS_MAX>
__global__ void __launch_bounds__(kThreads)
spmm_minmax_kernel(int m, int K, const int* __restrict__ indptr,
                   const int* __restrict__ indices,
                   const float* __restrict__ vals, const T* __restrict__ B,
                   T* __restrict__ out, float* __restrict__ ties) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;  // first column of this lane
  const bool active = k < K;  // K % VEC == 0, so k < K covers all VEC
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < m;
       row += stride) {
    const int start = indptr[row];
    const int end = indptr[row + 1];
    float best[VEC];
    int count[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      best[t] = gespmm::minmax_identity<IS_MAX>();
      count[t] = 0;
    }
    for (int base = start; base < end; base += 32) {
      // Warp-uniform down to the shuffles: all 32 lanes take part.
      const int e = base + lane;
      int c = 0;
      float v = 0.f;
      if (e < end) {
        c = __ldg(indices + e);
        if (HAS_VALS) v = __ldg(vals + e);
      }
      const int n_here = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < n_here; ++j) {
        const int cj = __shfl_sync(kFull, c, j);
        float vj = 1.f;
        if (HAS_VALS) vj = __shfl_sync(kFull, v, j);
        if (active) {
          const P p = *reinterpret_cast<const P*>(B + (int64_t)cj * K + k);
#pragma unroll
          for (int t = 0; t < VEC; ++t) {
            gespmm::minmax_fold<IS_MAX>(
                gespmm::minmax_contrib<HAS_VALS>(vj, to_f32(p.v[t])), best[t],
                count[t]);
          }
        }
      }
    }
    if (active) {
      const bool empty = end == start;
      P o;
      F n;
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        o.v[t] = from_f32<T>(empty ? 0.f : best[t]);
        n.v[t] = (float)count[t];  // 0 for an empty row
      }
      *reinterpret_cast<P*>(out + (int64_t)row * K + k) = o;
      *reinterpret_cast<F*>(ties + (int64_t)row * K + k) = n;
    }
  }
}

template <typename T, int VEC, bool HAS_VALS, bool WANT_VALS>
__global__ void __launch_bounds__(kThreads)
spmm_minmax_vjp_kernel(int n, int K, int nnz, const int* __restrict__ colptr,
                       const int* __restrict__ rows,
                       const float* __restrict__ vals,
                       const T* __restrict__ B, const T* __restrict__ out,
                       const float* __restrict__ gt, T* __restrict__ grad_B,
                       float* __restrict__ grad_vals) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;
  const bool active = k < K;
  const int stride = gridDim.x * kWarps;
  // This slab's row of the (slabs, nnz) grad_val partials.
  float* const gv = WANT_VALS ? grad_vals + (int64_t)blockIdx.y * nnz : nullptr;
  for (int col = blockIdx.x * kWarps + (threadIdx.x >> 5); col < n;
       col += stride) {
    const int start = colptr[col];
    const int end = colptr[col + 1];
    float b[VEC] = {};
    float acc[VEC] = {};
    if (active) {
      const P p = *reinterpret_cast<const P*>(B + (int64_t)col * K + k);
#pragma unroll
      for (int t = 0; t < VEC; ++t) b[t] = to_f32(p.v[t]);
    }
    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      int r = 0;
      float v = 0.f;
      if (e < end) {
        r = __ldg(rows + e);
        if (HAS_VALS) v = __ldg(vals + e);
      }
      const int n_here = min(32, end - base);
#pragma unroll 2
      for (int j = 0; j < n_here; ++j) {
        const int rj = __shfl_sync(kFull, r, j);
        float vj = 1.f;
        if (HAS_VALS) vj = __shfl_sync(kFull, v, j);
        float part = 0.f;
        if (active) {
          const int64_t off = (int64_t)rj * K + k;
          const P o = *reinterpret_cast<const P*>(out + off);
          const F g = *reinterpret_cast<const F*>(gt + off);
#pragma unroll
          for (int t = 0; t < VEC; ++t) {
            const float x = gespmm::minmax_contrib<HAS_VALS>(vj, b[t]);
            const float w = x == to_f32(o.v[t]) ? g.v[t] : 0.f;
            acc[t] = HAS_VALS ? fmaf(w, vj, acc[t]) : acc[t] + w;
            if (WANT_VALS) part = fmaf(w, b[t], part);
          }
        }
        if (WANT_VALS) {
#pragma unroll
          for (int s = 16; s > 0; s >>= 1) part += __shfl_xor_sync(kFull, part, s);
          if (lane == 0) gv[base + j] = part;
        }
      }
    }
    if (active) {
      P o;
#pragma unroll
      for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[t]);
      *reinterpret_cast<P*>(grad_B + (int64_t)col * K + k) = o;
    }
  }
}

template <int VEC>
bool aligned(const void* p, size_t item) {
  return (uintptr_t)p % (VEC * item) == 0;
}

template <typename T, int VEC, bool HAS_VALS>
void launch_fwd(bool is_max, dim3 grid, cudaStream_t stream, int m, int K,
                const int* indptr, const int* indices, const float* vals,
                const T* B, T* out, float* ties) {
  if (is_max) {
    spmm_minmax_kernel<T, VEC, HAS_VALS, true><<<grid, kThreads, 0, stream>>>(
        m, K, indptr, indices, vals, B, out, ties);
  } else {
    spmm_minmax_kernel<T, VEC, HAS_VALS, false><<<grid, kThreads, 0, stream>>>(
        m, K, indptr, indices, vals, B, out, ties);
  }
}

template <typename T, int VEC>
cudaError_t forward_vec(int m, int K, int is_max, const int* indptr,
                        const int* indices, const float* vals, const T* B,
                        T* out, float* ties, cudaStream_t stream) {
  if (K % VEC != 0 || !aligned<VEC>(B, sizeof(T)) ||
      !aligned<VEC>(out, sizeof(T)) || !aligned<VEC>(ties, sizeof(float)))
    return cudaErrorInvalidValue;
  const dim3 grid = warp_per_row_grid(m, K, VEC);
  if (vals != nullptr) {
    launch_fwd<T, VEC, true>(is_max, grid, stream, m, K, indptr, indices, vals,
                             B, out, ties);
  } else {
    launch_fwd<T, VEC, false>(is_max, grid, stream, m, K, indptr, indices,
                              nullptr, B, out, ties);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(int m, int K, int vec, int is_max, const int* indptr,
                    const int* indices, const float* vals, const T* B, T* out,
                    float* ties, cudaStream_t stream) {
  switch (vec) {
    case 4:
      return forward_vec<T, 4>(m, K, is_max, indptr, indices, vals, B, out,
                               ties, stream);
    case 2:
      return forward_vec<T, 2>(m, K, is_max, indptr, indices, vals, B, out,
                               ties, stream);
    case 1:
      return forward_vec<T, 1>(m, K, is_max, indptr, indices, vals, B, out,
                               ties, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int VEC>
cudaError_t backward_vec(int n, int K, int nnz, const int* colptr,
                         const int* rows, const float* vals, const T* B,
                         const T* out, const float* gt, T* grad_B,
                         float* grad_vals, cudaStream_t stream) {
  if (K % VEC != 0 || !aligned<VEC>(B, sizeof(T)) ||
      !aligned<VEC>(out, sizeof(T)) || !aligned<VEC>(grad_B, sizeof(T)) ||
      !aligned<VEC>(gt, sizeof(float)) ||
      (grad_vals != nullptr && vals == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid = warp_per_row_grid(n, K, VEC);
  if (grad_vals != nullptr) {
    spmm_minmax_vjp_kernel<T, VEC, true, true><<<grid, kThreads, 0, stream>>>(
        n, K, nnz, colptr, rows, vals, B, out, gt, grad_B, grad_vals);
  } else if (vals != nullptr) {
    spmm_minmax_vjp_kernel<T, VEC, true, false><<<grid, kThreads, 0, stream>>>(
        n, K, nnz, colptr, rows, vals, B, out, gt, grad_B, nullptr);
  } else {
    spmm_minmax_vjp_kernel<T, VEC, false, false><<<grid, kThreads, 0, stream>>>(
        n, K, nnz, colptr, rows, nullptr, B, out, gt, grad_B, nullptr);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(int n, int K, int nnz, int vec, const int* colptr,
                     const int* rows, const float* vals, const T* B,
                     const T* out, const float* gt, T* grad_B,
                     float* grad_vals, cudaStream_t stream) {
  switch (vec) {
    case 4:
      return backward_vec<T, 4>(n, K, nnz, colptr, rows, vals, B, out, gt,
                                grad_B, grad_vals, stream);
    case 2:
      return backward_vec<T, 2>(n, K, nnz, colptr, rows, vals, B, out, gt,
                                grad_B, grad_vals, stream);
    case 1:
      return backward_vec<T, 1>(n, K, nnz, colptr, rows, vals, B, out, gt,
                                grad_B, grad_vals, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Forward: m >= 1, K >= 1, nnz >= 1 (the caller returns early otherwise);
// vals may be null (a binary matrix); is_max is 1 for max, 0 for min.
extern "C" int gespmm_spmm_minmax_f32(int m, int K, int vec, int is_max,
                                      const int* indptr, const int* indices,
                                      const float* vals, const float* B,
                                      float* out, float* ties, void* stream) {
  return (int)forward<float>(m, K, vec, is_max, indptr, indices, vals, B, out,
                             ties, (cudaStream_t)stream);
}

extern "C" int gespmm_spmm_minmax_bf16(int m, int K, int vec, int is_max,
                                       const int* indptr, const int* indices,
                                       const float* vals, const void* B,
                                       void* out, float* ties, void* stream) {
  return (int)forward<__nv_bfloat16>(
      m, K, vec, is_max, indptr, indices, vals, (const __nv_bfloat16*)B,
      (__nv_bfloat16*)out, ties, (cudaStream_t)stream);
}

// Backward over the CSC (colptr, rows, vals in CSC order): n >= 1, K >= 1,
// nnz >= 1.  grad_vals, if not null, is a (ceil(K / (32 vec)), nnz) f32
// buffer of per-slab partials that the caller sums over slabs; it needs vals.
extern "C" int gespmm_spmm_minmax_vjp_f32(int n, int K, int nnz, int vec,
                                          const int* colptr, const int* rows,
                                          const float* vals, const float* B,
                                          const float* out, const float* gt,
                                          float* grad_B, float* grad_vals,
                                          void* stream) {
  return (int)backward<float>(n, K, nnz, vec, colptr, rows, vals, B, out, gt,
                              grad_B, grad_vals, (cudaStream_t)stream);
}

extern "C" int gespmm_spmm_minmax_vjp_bf16(int n, int K, int nnz, int vec,
                                           const int* colptr, const int* rows,
                                           const float* vals, const void* B,
                                           const void* out, const float* gt,
                                           void* grad_B, float* grad_vals,
                                           void* stream) {
  return (int)backward<__nv_bfloat16>(
      n, K, nnz, vec, colptr, rows, vals, (const __nv_bfloat16*)B,
      (const __nv_bfloat16*)out, gt, (__nv_bfloat16*)grad_B, grad_vals,
      (cudaStream_t)stream);
}

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
