// Fused dot-product graph attention for Hopper (sm_90a): forward over the
// CSR, backward over the CSR (to D1) and over the CSC (to D2 and to B).  With
// D1 (m, Ka), D2 (n, Ka), B (n, K) and act = identity or leaky(., slope):
//
//   pre_e = D1[r] . D2[c],   l_e = act(pre_e)
//   mx[r]  = max_{e in row r} l_e   (0 for an empty row)
//   z_e    = exp(max(l_e - mx[r], -80))
//   den[r] = max(sum_{e in row r} z_e, 1e-20)
//   out[r] = sum_{e in row r} z_e * B[c] / den[r]
//
// and, for the cotangent g of out, with s[r] = <g[r], out[r]> (one torch op
// before the launch, from the stored out):
//
//   alpha_e = z_e / den[r],  u_e = g[r] . B[c]
//   dpre_e  = alpha_e * (u_e - s[r]) * act'(pre_e)
//   grad_D1[r] = sum_{e in row r} dpre_e * D2[c]
//   grad_D2[c] = sum_{e in col c} dpre_e * D1[r]
//   grad_B[c]  = sum_{e in col c} alpha_e * g[r]
//
// Replaces gespmm_tpu/kernels/gat_fused.py::_dot_forward (gat_fused.py:317)
// and _dot_bwd (:382), which on the TPU ran as four _reduce_part stream passes
// (spmm_stream.py:275): a K=1 max pass and a (K+1)-wide aggregate forward,
// then a Ka-wide pass over the plan (:401-428) and a (K+Ka)-wide pass over
// the transposed plan (:430-463) backward, each fed by XLA gathers of
// combined node tables into slot order and writing its per-slot stream to
// device memory in between.  Here each direction is one kernel, and every
// per-edge quantity (pre, z, alpha, u, dpre) lives in registers only.
//
// What bounds them: bytes and latency.  Per edge the forward reads one
// Ka-wide row of D2 and one K-wide row of B for about 2(Ka + K) flops and one
// exp; the backward reads the same rows again per direction, plus a K-wide
// row of g: far below the card's ridge point.  The design:
//   * forward, one warp per CSR row, as one pass with an online softmax: the
//     row's edges go 32 at a time, one per lane; a lane computes its edge's
//     logit (the Ka-wide dot, serially), the warp takes the batch max with a
//     fixed xor-shuffle tree, rescales its running sums by exp(old max - new
//     max), and then aggregates the batch with the lanes over columns (VEC
//     consecutive each, vector loads of B), each edge's column id and weight
//     broadcast with __shfl_sync.  Each logit is computed once and each B row
//     read once, where the two-pass shape of gat_fused.cu walks every row
//     twice.  mx is the exact row max of act(pre); for a row of at most 32
//     edges z is exp(max(l - mx, -80)) exactly, for a longer one the
//     product of the rescalings (equal up to rounding, and to the floor,
//     which only changes weights below 1.8e-35 against a denominator >= 1);
//   * backward over the CSR, one warp per row: each lane recomputes pre,
//     alpha and the K-wide dot u for its own edge serially (a lane owns whole
//     edges, so no cross-lane sum is needed for a dot of any width); then the
//     lanes go over Ka columns and each edge's dpre and column id are
//     broadcast;
//   * backward over the CSC, one warp per column: as the CSR backward, with
//     alpha recomputed from the row-side tables mx and den at the edge's row;
//     the second grid dimension walks the K slabs of grad_B (alpha * g rows;
//     u is not needed there) and then the Ka slabs of grad_D2;
//   * the three kernels compute pre with the same serial dot in the same
//     order, so they agree on it bitwise; every output element is written
//     once, without atomics, so each kernel is bitwise repeatable;
//   * expf, not __expf (the build does not use --use_fast_math), so the
//     float64 comparisons keep their margins.
// Not here yet: several short rows per warp, an nnz-balanced split of hub
// rows and columns (the chunk list of spmm_chunk.cu), and tensor-core dots.
//
// Plain C interface, loaded with ctypes.  The caller picks each VEC (1, 2 or
// 4; the width % VEC == 0 and every table of that width aligned to VEC
// elements) and vec4 (Ka % 4 == 0 and D1, D2 aligned to 4 floats).  Each
// entry point launches on the given stream, does not synchronise, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// The launch shape and the type helpers are those of gat_fused.cu; each
// source stays self-contained, as the package ships csrc/*.cu alone.
constexpr int kThreads = 256;  // 8 warps, 8 rows in flight per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kMaxBlocksX = 65535;  // a grid-stride loop covers the rest
constexpr unsigned kFull = 0xffffffffu;
// gespmm_tpu/kernels/gat_fused.py's _EXP_FLOOR and _DENOM_EPS.
constexpr float kExpFloor = -80.f;
constexpr float kDenomEps = 1e-20f;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(kFull, x, s);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, s));
  return x;
}

__device__ __forceinline__ float act(float x, int leaky, float slope) {
  return (leaky && x < 0.f) ? slope * x : x;
}

__device__ __forceinline__ float dact(float x, int leaky, float slope) {
  return (leaky && x < 0.f) ? slope : 1.f;
}

// pre = a . b over Ka floats, serially in index order (the same sum in all
// three kernels), with 16-byte loads when vec4.
__device__ __forceinline__ float row_dot(const float* __restrict__ a,
                                         const float* __restrict__ b, int Ka,
                                         int vec4) {
  float acc = 0.f;
  if (vec4) {
    for (int i = 0; i < Ka; i += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(a + i));
      const float4 y = __ldg(reinterpret_cast<const float4*>(b + i));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  } else {
    for (int i = 0; i < Ka; ++i) acc = fmaf(__ldg(a + i), __ldg(b + i), acc);
  }
  return acc;
}

// u = g_row . b_row over K, serially.
template <typename T>
__device__ __forceinline__ float g_dot(const float* __restrict__ g_row,
                                       const T* __restrict__ b_row, int K) {
  float u = 0.f;
  for (int i = 0; i < K; ++i) u = fmaf(__ldg(g_row + i), to_f32(b_row[i]), u);
  return u;
}

// alpha = z / den from the row-side tables.
__device__ __forceinline__ float attention(float pre, int leaky, float slope,
                                           float mx, float den) {
  return expf(fmaxf(act(pre, leaky, slope) - mx, kExpFloor)) /
         fmaxf(den, kDenomEps);
}

dim3 warp_per_item_grid(int items, int slabs) {
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  return dim3(blocks < kMaxBlocksX ? blocks : kMaxBlocksX, (unsigned)slabs);
}

int slabs_of(int width, int vec) { return (width + 32 * vec - 1) / (32 * vec); }

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dot_fwd_kernel(int m, int K, int Ka, int leaky, float slope, int vec4,
               const int* __restrict__ indptr, const int* __restrict__ indices,
               const float* __restrict__ D1, const float* __restrict__ D2,
               const T* __restrict__ B, T* __restrict__ out,
               float* __restrict__ mx, float* __restrict__ den) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;
  const bool active = k < K;  // K % VEC == 0, so k < K covers all VEC
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < m;
       row += stride) {
    const int start = indptr[row];
    const int end = indptr[row + 1];
    const float* d1 = D1 + (int64_t)row * Ka;
    float run_max = -CUDART_INF_F, zsum = 0.f, acc[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
    for (int base = start; base < end; base += 32) {
      // Warp-uniform down to the shuffles: all 32 lanes take part.
      const int e = base + lane;
      const bool valid = e < end;
      const int c = valid ? __ldg(indices + e) : 0;
      const float l =
          valid ? act(row_dot(d1, D2 + (int64_t)c * Ka, Ka, vec4), leaky, slope)
                : -CUDART_INF_F;
      const float new_max = fmaxf(run_max, warp_max(l));
      const float scale = expf(run_max - new_max);  // 0 on the first batch
      const float z = valid ? expf(fmaxf(l - new_max, kExpFloor)) : 0.f;
      zsum = fmaf(zsum, scale, warp_sum(z));
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] *= scale;
      run_max = new_max;
      const int n_here = min(32, end - base);
#pragma unroll 2
      for (int j = 0; j < n_here; ++j) {
        const int cj = __shfl_sync(kFull, c, j);
        const float zj = __shfl_sync(kFull, z, j);
        if (active) {
          const P p = *reinterpret_cast<const P*>(B + (int64_t)cj * K + k);
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[t] = fmaf(zj, to_f32(p.v[t]), acc[t]);
        }
      }
    }
    const float d = fmaxf(zsum, kDenomEps);
    if (active) {
      P o;
#pragma unroll
      for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[t] / d);
      *reinterpret_cast<P*>(out + (int64_t)row * K + k) = o;
    }
    if (blockIdx.y == 0 && lane == 0) {
      mx[row] = isfinite(run_max) ? run_max : 0.f;  // an empty row: 0
      den[row] = d;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dot_bwd_rows_kernel(int m, int K, int Ka, int leaky, float slope, int vec4,
                    const int* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const float* __restrict__ D1, const float* __restrict__ D2,
                    const T* __restrict__ B, const float* __restrict__ g,
                    const float* __restrict__ mx, const float* __restrict__ den,
                    const float* __restrict__ srow,
                    float* __restrict__ grad_D1) {
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const int ka = (blockIdx.y * 32 + lane) * VEC;  // this lane's Ka columns
  const bool active = ka < Ka;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < m;
       row += stride) {
    const int start = indptr[row];
    const int end = indptr[row + 1];
    const float* d1 = D1 + (int64_t)row * Ka;
    const float* g_row = g + (int64_t)row * K;
    const float mh = mx[row], dn = den[row], s = srow[row];
    float acc[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      int c = 0;
      float dpre = 0.f;
      if (e < end) {  // this lane's edge
        c = __ldg(indices + e);
        const float pre = row_dot(d1, D2 + (int64_t)c * Ka, Ka, vec4);
        const float u = g_dot(g_row, B + (int64_t)c * K, K);
        dpre = attention(pre, leaky, slope, mh, dn) * (u - s) *
               dact(pre, leaky, slope);
      }
      const int n_here = min(32, end - base);
#pragma unroll 2
      for (int j = 0; j < n_here; ++j) {
        const int cj = __shfl_sync(kFull, c, j);
        const float dj = __shfl_sync(kFull, dpre, j);
        if (active) {
          const F p = *reinterpret_cast<const F*>(D2 + (int64_t)cj * Ka + ka);
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[t] = fmaf(dj, p.v[t], acc[t]);
        }
      }
    }
    if (active) {
      F o;
#pragma unroll
      for (int t = 0; t < VEC; ++t) o.v[t] = acc[t];
      *reinterpret_cast<F*>(grad_D1 + (int64_t)row * Ka + ka) = o;
    }
  }
}

// Grid rows 0 .. b_slabs-1 write K slabs of grad_B (VB columns a lane), the
// rest Ka slabs of grad_D2 (VD columns a lane).
template <typename T, int VB, int VD>
__global__ void __launch_bounds__(kThreads)
dot_bwd_cols_kernel(int n, int K, int Ka, int b_slabs, int leaky, float slope,
                    int vec4, const int* __restrict__ colptr,
                    const int* __restrict__ rows,
                    const float* __restrict__ D1, const float* __restrict__ D2,
                    const T* __restrict__ B, const float* __restrict__ g,
                    const float* __restrict__ mx, const float* __restrict__ den,
                    const float* __restrict__ srow, T* __restrict__ grad_B,
                    float* __restrict__ grad_D2) {
  const int lane = threadIdx.x & 31;
  const bool to_B = (int)blockIdx.y < b_slabs;  // block-uniform
  const int kk = to_B ? (blockIdx.y * 32 + lane) * VB
                      : ((blockIdx.y - b_slabs) * 32 + lane) * VD;
  const bool active = kk < (to_B ? K : Ka);
  const int stride = gridDim.x * kWarps;
  for (int col = blockIdx.x * kWarps + (threadIdx.x >> 5); col < n;
       col += stride) {
    const int start = colptr[col];
    const int end = colptr[col + 1];
    const float* d2 = D2 + (int64_t)col * Ka;
    const T* b_col = B + (int64_t)col * K;
    float acc_b[VB], acc_d[VD];
#pragma unroll
    for (int t = 0; t < VB; ++t) acc_b[t] = 0.f;
#pragma unroll
    for (int t = 0; t < VD; ++t) acc_d[t] = 0.f;
    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      int r = 0;
      float w = 0.f;  // alpha for grad_B, dpre for grad_D2
      if (e < end) {  // this lane's edge
        r = __ldg(rows + e);
        const float pre = row_dot(D1 + (int64_t)r * Ka, d2, Ka, vec4);
        const float alpha =
            attention(pre, leaky, slope, __ldg(mx + r), __ldg(den + r));
        if (to_B) {
          w = alpha;
        } else {
          const float u = g_dot(g + (int64_t)r * K, b_col, K);
          w = alpha * (u - __ldg(srow + r)) * dact(pre, leaky, slope);
        }
      }
      const int n_here = min(32, end - base);
#pragma unroll 2
      for (int j = 0; j < n_here; ++j) {
        const int rj = __shfl_sync(kFull, r, j);
        const float wj = __shfl_sync(kFull, w, j);
        if (!active) continue;
        if (to_B) {
          const Pack<float, VB> p = *reinterpret_cast<const Pack<float, VB>*>(
              g + (int64_t)rj * K + kk);
#pragma unroll
          for (int t = 0; t < VB; ++t) acc_b[t] = fmaf(wj, p.v[t], acc_b[t]);
        } else {
          const Pack<float, VD> p = *reinterpret_cast<const Pack<float, VD>*>(
              D1 + (int64_t)rj * Ka + kk);
#pragma unroll
          for (int t = 0; t < VD; ++t) acc_d[t] = fmaf(wj, p.v[t], acc_d[t]);
        }
      }
    }
    if (!active) continue;
    if (to_B) {
      Pack<T, VB> o;
#pragma unroll
      for (int t = 0; t < VB; ++t) o.v[t] = from_f32<T>(acc_b[t]);
      *reinterpret_cast<Pack<T, VB>*>(grad_B + (int64_t)col * K + kk) = o;
    } else {
      Pack<float, VD> o;
#pragma unroll
      for (int t = 0; t < VD; ++t) o.v[t] = acc_d[t];
      *reinterpret_cast<Pack<float, VD>*>(grad_D2 + (int64_t)col * Ka + kk) = o;
    }
  }
}

template <int VEC>
bool aligned(const void* p, size_t item) {
  return (uintptr_t)p % (VEC * item) == 0;
}

bool bad_dot(int Ka, int vec4, const float* D1, const float* D2) {
  return Ka < 1 || (vec4 && (Ka % 4 != 0 || !aligned<4>(D1, sizeof(float)) ||
                             !aligned<4>(D2, sizeof(float))));
}

template <typename T, int VEC>
cudaError_t forward_vec(int m, int K, int Ka, int leaky, float slope, int vec4,
                        const int* indptr, const int* indices, const float* D1,
                        const float* D2, const T* B, T* out, float* mx,
                        float* den, cudaStream_t stream) {
  if (K < 1 || K % VEC != 0 || bad_dot(Ka, vec4, D1, D2) ||
      !aligned<VEC>(B, sizeof(T)) || !aligned<VEC>(out, sizeof(T)))
    return cudaErrorInvalidValue;
  dot_fwd_kernel<T, VEC>
      <<<warp_per_item_grid(m, slabs_of(K, VEC)), kThreads, 0, stream>>>(
          m, K, Ka, leaky, slope, vec4, indptr, indices, D1, D2, B, out, mx,
          den);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t backward_rows_vec(int m, int K, int Ka, int leaky, float slope,
                              int vec4, const int* indptr, const int* indices,
                              const float* D1, const float* D2, const T* B,
                              const float* g, const float* mx,
                              const float* den, const float* srow,
                              float* grad_D1, cudaStream_t stream) {
  if (K < 1 || Ka % VEC != 0 || bad_dot(Ka, vec4, D1, D2) ||
      !aligned<VEC>(D2, sizeof(float)) || !aligned<VEC>(grad_D1, sizeof(float)))
    return cudaErrorInvalidValue;
  dot_bwd_rows_kernel<T, VEC>
      <<<warp_per_item_grid(m, slabs_of(Ka, VEC)), kThreads, 0, stream>>>(
          m, K, Ka, leaky, slope, vec4, indptr, indices, D1, D2, B, g, mx, den,
          srow, grad_D1);
  return cudaGetLastError();
}

template <typename T, int VB, int VD>
cudaError_t backward_cols_vec(int n, int K, int Ka, int leaky, float slope,
                              int vec4, const int* colptr, const int* rows,
                              const float* D1, const float* D2, const T* B,
                              const float* g, const float* mx,
                              const float* den, const float* srow, T* grad_B,
                              float* grad_D2, cudaStream_t stream) {
  if (K < 1 || K % VB != 0 || Ka % VD != 0 || bad_dot(Ka, vec4, D1, D2) ||
      !aligned<VB>(g, sizeof(float)) || !aligned<VB>(grad_B, sizeof(T)) ||
      !aligned<VD>(D1, sizeof(float)) || !aligned<VD>(grad_D2, sizeof(float)))
    return cudaErrorInvalidValue;
  const int b_slabs = slabs_of(K, VB);
  dot_bwd_cols_kernel<T, VB, VD><<<
      warp_per_item_grid(n, b_slabs + slabs_of(Ka, VD)), kThreads, 0, stream>>>(
      n, K, Ka, b_slabs, leaky, slope, vec4, colptr, rows, D1, D2, B, g, mx,
      den, srow, grad_B, grad_D2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(int m, int K, int Ka, int vec, int leaky, float slope,
                    int vec4, const int* indptr, const int* indices,
                    const float* D1, const float* D2, const T* B, T* out,
                    float* mx, float* den, cudaStream_t stream) {
  switch (vec) {
    case 4:
      return forward_vec<T, 4>(m, K, Ka, leaky, slope, vec4, indptr, indices,
                               D1, D2, B, out, mx, den, stream);
    case 2:
      return forward_vec<T, 2>(m, K, Ka, leaky, slope, vec4, indptr, indices,
                               D1, D2, B, out, mx, den, stream);
    case 1:
      return forward_vec<T, 1>(m, K, Ka, leaky, slope, vec4, indptr, indices,
                               D1, D2, B, out, mx, den, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t backward_rows(int m, int K, int Ka, int vec, int leaky,
                          float slope, int vec4, const int* indptr,
                          const int* indices, const float* D1, const float* D2,
                          const T* B, const float* g, const float* mx,
                          const float* den, const float* srow, float* grad_D1,
                          cudaStream_t stream) {
  switch (vec) {
    case 4:
      return backward_rows_vec<T, 4>(m, K, Ka, leaky, slope, vec4, indptr,
                                     indices, D1, D2, B, g, mx, den, srow,
                                     grad_D1, stream);
    case 2:
      return backward_rows_vec<T, 2>(m, K, Ka, leaky, slope, vec4, indptr,
                                     indices, D1, D2, B, g, mx, den, srow,
                                     grad_D1, stream);
    case 1:
      return backward_rows_vec<T, 1>(m, K, Ka, leaky, slope, vec4, indptr,
                                     indices, D1, D2, B, g, mx, den, srow,
                                     grad_D1, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int VB>
cudaError_t backward_cols_vb(int n, int K, int Ka, int vd, int leaky,
                             float slope, int vec4, const int* colptr,
                             const int* rows, const float* D1,
                             const float* D2, const T* B, const float* g,
                             const float* mx, const float* den,
                             const float* srow, T* grad_B, float* grad_D2,
                             cudaStream_t stream) {
  switch (vd) {
    case 4:
      return backward_cols_vec<T, VB, 4>(n, K, Ka, leaky, slope, vec4, colptr,
                                         rows, D1, D2, B, g, mx, den, srow,
                                         grad_B, grad_D2, stream);
    case 2:
      return backward_cols_vec<T, VB, 2>(n, K, Ka, leaky, slope, vec4, colptr,
                                         rows, D1, D2, B, g, mx, den, srow,
                                         grad_B, grad_D2, stream);
    case 1:
      return backward_cols_vec<T, VB, 1>(n, K, Ka, leaky, slope, vec4, colptr,
                                         rows, D1, D2, B, g, mx, den, srow,
                                         grad_B, grad_D2, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t backward_cols(int n, int K, int Ka, int vb, int vd, int leaky,
                          float slope, int vec4, const int* colptr,
                          const int* rows, const float* D1, const float* D2,
                          const T* B, const float* g, const float* mx,
                          const float* den, const float* srow, T* grad_B,
                          float* grad_D2, cudaStream_t stream) {
  switch (vb) {
    case 4:
      return backward_cols_vb<T, 4>(n, K, Ka, vd, leaky, slope, vec4, colptr,
                                    rows, D1, D2, B, g, mx, den, srow, grad_B,
                                    grad_D2, stream);
    case 2:
      return backward_cols_vb<T, 2>(n, K, Ka, vd, leaky, slope, vec4, colptr,
                                    rows, D1, D2, B, g, mx, den, srow, grad_B,
                                    grad_D2, stream);
    case 1:
      return backward_cols_vb<T, 1>(n, K, Ka, vd, leaky, slope, vec4, colptr,
                                    rows, D1, D2, B, g, mx, den, srow, grad_B,
                                    grad_D2, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Forward over the CSR (indptr, indices): m >= 1, K >= 1, Ka >= 1, nnz >= 1
// (the caller returns early otherwise).  D1 (m, Ka), D2 (n, Ka), mx and den
// (m,) are f32; B (n, K) and out (m, K) are of one type.  leaky = 0 is the
// identity act (slope unused).
extern "C" int gespmm_dot_fwd_f32(int m, int K, int Ka, int vec, int leaky,
                                  float slope, int vec4, const int* indptr,
                                  const int* indices, const float* D1,
                                  const float* D2, const float* B, float* out,
                                  float* mx, float* den, void* stream) {
  return (int)forward<float>(m, K, Ka, vec, leaky, slope, vec4, indptr,
                             indices, D1, D2, B, out, mx, den,
                             (cudaStream_t)stream);
}

extern "C" int gespmm_dot_fwd_bf16(int m, int K, int Ka, int vec, int leaky,
                                   float slope, int vec4, const int* indptr,
                                   const int* indices, const float* D1,
                                   const float* D2, const void* B, void* out,
                                   float* mx, float* den, void* stream) {
  return (int)forward<__nv_bfloat16>(
      m, K, Ka, vec, leaky, slope, vec4, indptr, indices, D1, D2,
      (const __nv_bfloat16*)B, (__nv_bfloat16*)out, mx, den,
      (cudaStream_t)stream);
}

// Backward over the CSR: grad_D1 (m, Ka) f32.  g (m, K), mx, den and srow
// (m,) are f32; B (n, K) is f32 or bf16.  vec is the Ka lane vector.
extern "C" int gespmm_dot_bwd_rows_f32(int m, int K, int Ka, int vec,
                                       int leaky, float slope, int vec4,
                                       const int* indptr, const int* indices,
                                       const float* D1, const float* D2,
                                       const float* B, const float* g,
                                       const float* mx, const float* den,
                                       const float* srow, float* grad_D1,
                                       void* stream) {
  return (int)backward_rows<float>(m, K, Ka, vec, leaky, slope, vec4, indptr,
                                   indices, D1, D2, B, g, mx, den, srow,
                                   grad_D1, (cudaStream_t)stream);
}

extern "C" int gespmm_dot_bwd_rows_bf16(int m, int K, int Ka, int vec,
                                        int leaky, float slope, int vec4,
                                        const int* indptr, const int* indices,
                                        const float* D1, const float* D2,
                                        const void* B, const float* g,
                                        const float* mx, const float* den,
                                        const float* srow, float* grad_D1,
                                        void* stream) {
  return (int)backward_rows<__nv_bfloat16>(
      m, K, Ka, vec, leaky, slope, vec4, indptr, indices, D1, D2,
      (const __nv_bfloat16*)B, g, mx, den, srow, grad_D1, (cudaStream_t)stream);
}

// Backward over the CSC (colptr, rows): n >= 1 columns; grad_B (n, K) in B's
// type and grad_D2 (n, Ka) f32; vb and vd are the K and Ka lane vectors.  The
// row-side tables are those of the backward over the CSR.
extern "C" int gespmm_dot_bwd_cols_f32(int n, int K, int Ka, int vb, int vd,
                                       int leaky, float slope, int vec4,
                                       const int* colptr, const int* rows,
                                       const float* D1, const float* D2,
                                       const float* B, const float* g,
                                       const float* mx, const float* den,
                                       const float* srow, float* grad_B,
                                       float* grad_D2, void* stream) {
  return (int)backward_cols<float>(n, K, Ka, vb, vd, leaky, slope, vec4,
                                   colptr, rows, D1, D2, B, g, mx, den, srow,
                                   grad_B, grad_D2, (cudaStream_t)stream);
}

extern "C" int gespmm_dot_bwd_cols_bf16(int n, int K, int Ka, int vb, int vd,
                                        int leaky, float slope, int vec4,
                                        const int* colptr, const int* rows,
                                        const float* D1, const float* D2,
                                        const void* B, const float* g,
                                        const float* mx, const float* den,
                                        const float* srow, void* grad_B,
                                        float* grad_D2, void* stream) {
  return (int)backward_cols<__nv_bfloat16>(
      n, K, Ka, vb, vd, leaky, slope, vec4, colptr, rows, D1, D2,
      (const __nv_bfloat16*)B, g, mx, den, srow, (__nv_bfloat16*)grad_B,
      grad_D2, (cudaStream_t)stream);
}

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
