// Fused GATv1 attention for Hopper (sm_90a): forward over the CSR, backward
// over the CSR (to the source scores) and over the CSC (to B and to the
// destination scores).  Per head h of H, with B (n, K = H*dh) in head blocks:
//
//   pre_e = src[r, h] + dst[c, h],   l_e = leaky(pre_e)
//   mx[r, h]  = max_{e in row r} l_e   (0 for an empty row), or handed in
//   z_e       = exp(max(l_e - mx[r, h], -80))
//   den[r, h] = max(sum_{e in row r} z_e, 1e-20)
//   out[r, h-block] = sum_{e in row r} z_e * B[c, h-block] / den[r, h]
//
// and, for the cotangent g of out, with s[r, h] = <g[r], out[r]> over the
// head block (one torch op before the launch, from the stored out):
//
//   alpha_e = z_e / den[r, h],  u_e = <g[r], B[c]> over the head block
//   dpre_e  = alpha_e * (u_e - s[r, h]) * leaky'(pre_e)
//   grad_src[r, h] = sum_{e in row r} dpre_e
//   grad_dst[c, h] = sum_{e in col c} dpre_e
//   grad_B[c, h-block] = sum_{e in col c} alpha_e * g[r, h-block]
//
// Replaces gespmm_tpu/kernels/gat_fused.py::_forward (gat_fused.py:103) and
// _gat_bwd (:200), which on the TPU ran as four _reduce_part stream passes
// (spmm_stream.py:275): a K=H max pass and a (K+H)-wide aggregate forward,
// then a K=H pass over the plan and a (K+H)-wide pass over the transposed
// plan backward, each fed by XLA gathers of the node tables into slot order
// and writing its per-slot stream to device memory in between.  Here each
// direction is one kernel; every per-edge quantity (pre, z, alpha, u, dpre)
// is recomputed in registers from the node tables and never stored.
//
// What bounds them: bytes and latency.  Per edge the forward reads one
// K-wide row of B, the backward one K-wide row of B or g per direction, plus
// H-wide rows of the score tables, for O(K) flops and H exps: far below the
// card's ridge point.  The design:
//   * forward, one warp per CSR row (as spmm_csr.cu): a max pass per head
//     with the lanes over the row's edges and a fixed xor-shuffle tree
//     (skipped when the bound mode hands mx in); then one aggregate pass with
//     the lanes over columns (VEC consecutive each, vector loads of B), the
//     row's column ids loaded 32 at a time and broadcast with __shfl_sync;
//     each lane keeps its columns' sums and its heads' denominators in f32
//     registers, so the denominator costs no extra pass or column;
//   * backward over the CSR, one warp per row: g[r] is read through the
//     cache by every lane, the lanes walk the row's edges, each recomputes
//     pre, alpha and the head-block dot u for its edge serially, and dpre is
//     reduced by a fixed shuffle tree.  A lane owns whole edges, so a head
//     block of any width (dh = 3, or one that straddles two lanes' vectors)
//     needs no cross-lane segmented sum;
//   * backward over the CSC, one warp per column: grad_dst as the CSR
//     backward does (lanes over the column's edges), then grad_B with the
//     lanes over columns and each edge's row id broadcast, alpha recomputed
//     from the row-side tables src, mx and den gathered at the edge's row;
//   * every output element is written once, without atomics, so both
//     directions are bitwise repeatable; a second grid dimension walks K
//     slabs of 32*VEC columns, and a head's mx, den and grad_dst are written
//     by the slab that holds the head's first column;
//   * expf, not __expf (the build does not use --use_fast_math), so the
//     float64 comparisons keep their margins.
// Not here yet: several short rows per warp (degree-5 rows leave most lanes
// of the max pass and of the backward idle), an nnz-balanced split of hub
// rows and columns, and a vectorised head-block dot.
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// K % VEC == 0 and every K-wide table aligned to VEC elements).  Each entry
// point launches on the given stream, does not synchronise, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// The launch shape and the type helpers are those of spmm_csr.cu; each
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

// VEC consecutive elements, aligned so that one load/store instruction moves
// them all (ld.global.v4.f32 for float at VEC=4).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

__device__ __forceinline__ float dleaky(float x, float slope) {
  return x >= 0.f ? 1.f : slope;
}

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

// z_e / den: the attention weight of one (edge, head), from the row-side
// tables at the edge's row (index rh = r*H + h) and the pre-activation.
__device__ __forceinline__ float attention(float pre, float slope, float mx,
                                           float den) {
  return expf(fmaxf(leaky(pre, slope) - mx, kExpFloor)) / fmaxf(den, kDenomEps);
}

// dpre of one (edge, head) for a lane that owns the edge: the head-block dot
// u = <g_row, B_col> is taken serially over the dh columns.
template <typename T>
__device__ __forceinline__ float edge_dpre(float pre, float slope, float mx,
                                           float den, float s,
                                           const float* __restrict__ g_row,
                                           const T* __restrict__ b_col, int dh) {
  float u = 0.f;
  for (int i = 0; i < dh; ++i) u = fmaf(__ldg(g_row + i), to_f32(b_col[i]), u);
  return attention(pre, slope, mx, den) * (u - s) * dleaky(pre, slope);
}

// One warp per row over a grid-stride loop in x, one 32*VEC-wide K slab per
// grid row in y.
dim3 warp_per_row_grid(int rows, int K, int vec) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  return dim3(blocks < kMaxBlocksX ? blocks : kMaxBlocksX,
              (unsigned)((K + 32 * vec - 1) / (32 * vec)));
}

// The K slab of this block: columns [k_begin, k_end), the heads h_lo..h_hi
// they touch, and the head of each of the lane's VEC columns (clamped for an
// idle lane, so that its table reads stay in range).
template <int VEC>
struct Slab {
  int k_begin, k, h_lo, h_hi;
  bool active;
  int hd[VEC];
  __device__ Slab(int K, int H, int dh) {
    k_begin = blockIdx.y * 32 * VEC;
    const int k_end = min(K, k_begin + 32 * VEC);
    k = k_begin + (threadIdx.x & 31) * VEC;
    active = k < K;  // K % VEC == 0, so k < K covers all VEC
    h_lo = k_begin / dh;
    h_hi = (k_end - 1) / dh;
#pragma unroll
    for (int t = 0; t < VEC; ++t) hd[t] = min((k + t) / dh, H - 1);
  }
  // Whether this slab writes head h's per-head outputs.
  __device__ bool owns(int h, int dh) const { return h * dh >= k_begin; }
};

template <typename T, int VEC, bool EXACT>
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(int m, int K, int H, int dh, float slope,
               const int* __restrict__ indptr, const int* __restrict__ indices,
               const float* __restrict__ src, const float* __restrict__ dst,
               const T* __restrict__ B, float* __restrict__ mx,
               T* __restrict__ out, float* __restrict__ den) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const Slab<VEC> sl(K, H, dh);
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < m;
       row += stride) {
    const int start = indptr[row];
    const int end = indptr[row + 1];
    const float* src_r = src + (int64_t)row * H;
    float s[VEC], shift[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      s[t] = src_r[sl.hd[t]];
      shift[t] = 0.f;
    }
    if (EXACT) {
      // Max pass, one head at a time, the lanes over the row's edges.
      for (int h = sl.h_lo; h <= sl.h_hi; ++h) {
        const float sh = src_r[h];
        float best = -CUDART_INF_F;
        for (int e = start + lane; e < end; e += 32) {
          const int c = __ldg(indices + e);
          best = fmaxf(best, leaky(sh + __ldg(dst + (int64_t)c * H + h), slope));
        }
        best = warp_max(best);
        if (!isfinite(best)) best = 0.f;  // empty row
#pragma unroll
        for (int t = 0; t < VEC; ++t) shift[t] = sl.hd[t] == h ? best : shift[t];
        if (lane == 0 && sl.owns(h, dh)) mx[(int64_t)row * H + h] = best;
      }
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) shift[t] = mx[(int64_t)row * H + sl.hd[t]];
    }
    // Aggregate pass, the lanes over columns.
    float acc[VEC], zsum[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] = zsum[t] = 0.f;
    for (int base = start; base < end; base += 32) {
      // Warp-uniform down to the shuffles: all 32 lanes take part.
      const int e = base + lane;
      const int c = e < end ? __ldg(indices + e) : 0;
      const int n_here = min(32, end - base);
#pragma unroll 2
      for (int j = 0; j < n_here; ++j) {
        const int cj = __shfl_sync(kFull, c, j);
        if (sl.active) {
          const P p = *reinterpret_cast<const P*>(B + (int64_t)cj * K + sl.k);
          const float* dst_c = dst + (int64_t)cj * H;
#pragma unroll
          for (int t = 0; t < VEC; ++t) {
            const float l = leaky(s[t] + __ldg(dst_c + sl.hd[t]), slope);
            const float z = expf(fmaxf(l - shift[t], kExpFloor));
            zsum[t] += z;
            acc[t] = fmaf(z, to_f32(p.v[t]), acc[t]);
          }
        }
      }
    }
    if (sl.active) {
      P o;
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        const float d = fmaxf(zsum[t], kDenomEps);
        o.v[t] = from_f32<T>(acc[t] / d);
        // The lane holding a head's first column writes its denominator.
        if ((sl.k + t) % dh == 0) den[(int64_t)row * H + sl.hd[t]] = d;
      }
      *reinterpret_cast<P*>(out + (int64_t)row * K + sl.k) = o;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gat_bwd_rows_kernel(int m, int K, int H, int dh, float slope,
                    const int* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const float* __restrict__ src, const float* __restrict__ dst,
                    const T* __restrict__ B, const float* __restrict__ g,
                    const float* __restrict__ mx, const float* __restrict__ den,
                    const float* __restrict__ srow,
                    float* __restrict__ grad_src) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < m;
       row += stride) {
    const int start = indptr[row];
    const int end = indptr[row + 1];
    for (int h = 0; h < H; ++h) {
      const int64_t rh = (int64_t)row * H + h;
      const float sh = src[rh], mh = mx[rh], dn = den[rh], s = srow[rh];
      const float* g_row = g + (int64_t)row * K + h * dh;
      float part = 0.f;
      for (int e = start + lane; e < end; e += 32) {
        const int c = __ldg(indices + e);
        const float pre = sh + __ldg(dst + (int64_t)c * H + h);
        part += edge_dpre(pre, slope, mh, dn, s, g_row,
                          B + (int64_t)c * K + h * dh, dh);
      }
      part = warp_sum(part);
      if (lane == 0) grad_src[rh] = part;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gat_bwd_cols_kernel(int n, int K, int H, int dh, float slope,
                    const int* __restrict__ colptr,
                    const int* __restrict__ rows,
                    const float* __restrict__ src, const float* __restrict__ dst,
                    const T* __restrict__ B, const float* __restrict__ g,
                    const float* __restrict__ mx, const float* __restrict__ den,
                    const float* __restrict__ srow, T* __restrict__ grad_B,
                    float* __restrict__ grad_dst) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  const int lane = threadIdx.x & 31;
  const Slab<VEC> sl(K, H, dh);
  const int stride = gridDim.x * kWarps;
  for (int col = blockIdx.x * kWarps + (threadIdx.x >> 5); col < n;
       col += stride) {
    const int start = colptr[col];
    const int end = colptr[col + 1];
    const float* dst_c = dst + (int64_t)col * H;
    // grad_dst of the heads this slab owns, the lanes over the column's edges.
    for (int h = sl.h_lo; h <= sl.h_hi; ++h) {
      if (!sl.owns(h, dh)) continue;
      const float dc = dst_c[h];
      const T* b_col = B + (int64_t)col * K + h * dh;
      float part = 0.f;
      for (int e = start + lane; e < end; e += 32) {
        const int r = __ldg(rows + e);
        const int64_t rh = (int64_t)r * H + h;
        part += edge_dpre(__ldg(src + rh) + dc, slope, __ldg(mx + rh),
                          __ldg(den + rh), __ldg(srow + rh),
                          g + (int64_t)r * K + h * dh, b_col, dh);
      }
      part = warp_sum(part);
      if (lane == 0) grad_dst[(int64_t)col * H + h] = part;
    }
    // grad_B[col], the lanes over columns, each edge's row id broadcast.
    float dcol[VEC], acc[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      dcol[t] = dst_c[sl.hd[t]];
      acc[t] = 0.f;
    }
    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      const int r = e < end ? __ldg(rows + e) : 0;
      const int n_here = min(32, end - base);
#pragma unroll 2
      for (int j = 0; j < n_here; ++j) {
        const int rj = __shfl_sync(kFull, r, j);
        if (sl.active) {
          const F gv = *reinterpret_cast<const F*>(g + (int64_t)rj * K + sl.k);
#pragma unroll
          for (int t = 0; t < VEC; ++t) {
            const int64_t rh = (int64_t)rj * H + sl.hd[t];
            const float alpha = attention(__ldg(src + rh) + dcol[t], slope,
                                          __ldg(mx + rh), __ldg(den + rh));
            acc[t] = fmaf(alpha, gv.v[t], acc[t]);
          }
        }
      }
    }
    if (sl.active) {
      P o;
#pragma unroll
      for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[t]);
      *reinterpret_cast<P*>(grad_B + (int64_t)col * K + sl.k) = o;
    }
  }
}

template <int VEC>
bool aligned(const void* p, size_t item) {
  return (uintptr_t)p % (VEC * item) == 0;
}

bool bad_shape(int K, int H, int vec) {
  return H < 1 || K < 1 || K % H != 0 || K % vec != 0;
}

template <typename T, int VEC>
cudaError_t forward_vec(int m, int K, int H, int exact, float slope,
                        const int* indptr, const int* indices, const float* src,
                        const float* dst, const T* B, float* mx, T* out,
                        float* den, cudaStream_t stream) {
  if (bad_shape(K, H, VEC) || !aligned<VEC>(B, sizeof(T)) ||
      !aligned<VEC>(out, sizeof(T)))
    return cudaErrorInvalidValue;
  const dim3 grid = warp_per_row_grid(m, K, VEC);
  if (exact) {
    gat_fwd_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(
        m, K, H, K / H, slope, indptr, indices, src, dst, B, mx, out, den);
  } else {
    gat_fwd_kernel<T, VEC, false><<<grid, kThreads, 0, stream>>>(
        m, K, H, K / H, slope, indptr, indices, src, dst, B, mx, out, den);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(int m, int K, int H, int vec, int exact, float slope,
                    const int* indptr, const int* indices, const float* src,
                    const float* dst, const T* B, float* mx, T* out, float* den,
                    cudaStream_t stream) {
  switch (vec) {
    case 4:
      return forward_vec<T, 4>(m, K, H, exact, slope, indptr, indices, src, dst,
                               B, mx, out, den, stream);
    case 2:
      return forward_vec<T, 2>(m, K, H, exact, slope, indptr, indices, src, dst,
                               B, mx, out, den, stream);
    case 1:
      return forward_vec<T, 1>(m, K, H, exact, slope, indptr, indices, src, dst,
                               B, mx, out, den, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t backward_rows(int m, int K, int H, float slope, const int* indptr,
                          const int* indices, const float* src,
                          const float* dst, const T* B, const float* g,
                          const float* mx, const float* den, const float* srow,
                          float* grad_src, cudaStream_t stream) {
  if (bad_shape(K, H, 1)) return cudaErrorInvalidValue;
  const dim3 grid = warp_per_row_grid(m, 1, 1);
  gat_bwd_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      m, K, H, K / H, slope, indptr, indices, src, dst, B, g, mx, den, srow,
      grad_src);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t backward_cols_vec(int n, int K, int H, float slope,
                              const int* colptr, const int* rows,
                              const float* src, const float* dst, const T* B,
                              const float* g, const float* mx, const float* den,
                              const float* srow, T* grad_B, float* grad_dst,
                              cudaStream_t stream) {
  if (bad_shape(K, H, VEC) || !aligned<VEC>(g, sizeof(float)) ||
      !aligned<VEC>(grad_B, sizeof(T)))
    return cudaErrorInvalidValue;
  const dim3 grid = warp_per_row_grid(n, K, VEC);
  gat_bwd_cols_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      n, K, H, K / H, slope, colptr, rows, src, dst, B, g, mx, den, srow,
      grad_B, grad_dst);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_cols(int n, int K, int H, int vec, float slope,
                          const int* colptr, const int* rows, const float* src,
                          const float* dst, const T* B, const float* g,
                          const float* mx, const float* den, const float* srow,
                          T* grad_B, float* grad_dst, cudaStream_t stream) {
  switch (vec) {
    case 4:
      return backward_cols_vec<T, 4>(n, K, H, slope, colptr, rows, src, dst, B,
                                     g, mx, den, srow, grad_B, grad_dst, stream);
    case 2:
      return backward_cols_vec<T, 2>(n, K, H, slope, colptr, rows, src, dst, B,
                                     g, mx, den, srow, grad_B, grad_dst, stream);
    case 1:
      return backward_cols_vec<T, 1>(n, K, H, slope, colptr, rows, src, dst, B,
                                     g, mx, den, srow, grad_B, grad_dst, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Forward over the CSR (indptr, indices): m >= 1, K >= 1, nnz >= 1 (the
// caller returns early otherwise).  src (m, H), dst (n, H), mx and den
// (m, H) are f32; B (n, K) and out (m, K) are of one type.  exact = 1 writes
// mx; exact = 0 reads it (the bound mode's shift, computed by the caller).
extern "C" int gespmm_gat_fwd_f32(int m, int K, int H, int vec, int exact,
                                  float slope, const int* indptr,
                                  const int* indices, const float* src,
                                  const float* dst, const float* B, float* mx,
                                  float* out, float* den, void* stream) {
  return (int)forward<float>(m, K, H, vec, exact, slope, indptr, indices, src,
                             dst, B, mx, out, den, (cudaStream_t)stream);
}

extern "C" int gespmm_gat_fwd_bf16(int m, int K, int H, int vec, int exact,
                                   float slope, const int* indptr,
                                   const int* indices, const float* src,
                                   const float* dst, const void* B, float* mx,
                                   void* out, float* den, void* stream) {
  return (int)forward<__nv_bfloat16>(
      m, K, H, vec, exact, slope, indptr, indices, src, dst,
      (const __nv_bfloat16*)B, mx, (__nv_bfloat16*)out, den,
      (cudaStream_t)stream);
}

// Backward over the CSR: grad_src (m, H) f32.  g (m, K), mx, den and srow
// (m, H) are f32; B (n, K) is f32 or bf16.
extern "C" int gespmm_gat_bwd_rows_f32(int m, int K, int H, float slope,
                                       const int* indptr, const int* indices,
                                       const float* src, const float* dst,
                                       const float* B, const float* g,
                                       const float* mx, const float* den,
                                       const float* srow, float* grad_src,
                                       void* stream) {
  return (int)backward_rows<float>(m, K, H, slope, indptr, indices, src, dst, B,
                                   g, mx, den, srow, grad_src,
                                   (cudaStream_t)stream);
}

extern "C" int gespmm_gat_bwd_rows_bf16(int m, int K, int H, float slope,
                                        const int* indptr, const int* indices,
                                        const float* src, const float* dst,
                                        const void* B, const float* g,
                                        const float* mx, const float* den,
                                        const float* srow, float* grad_src,
                                        void* stream) {
  return (int)backward_rows<__nv_bfloat16>(
      m, K, H, slope, indptr, indices, src, dst, (const __nv_bfloat16*)B, g, mx,
      den, srow, grad_src, (cudaStream_t)stream);
}

// Backward over the CSC (colptr, rows): n >= 1 columns; grad_B (n, K) in B's
// type and grad_dst (n, H) f32.  The row-side tables are those of the
// backward over the CSR.
extern "C" int gespmm_gat_bwd_cols_f32(int n, int K, int H, int vec,
                                       float slope, const int* colptr,
                                       const int* rows, const float* src,
                                       const float* dst, const float* B,
                                       const float* g, const float* mx,
                                       const float* den, const float* srow,
                                       float* grad_B, float* grad_dst,
                                       void* stream) {
  return (int)backward_cols<float>(n, K, H, vec, slope, colptr, rows, src, dst,
                                   B, g, mx, den, srow, grad_B, grad_dst,
                                   (cudaStream_t)stream);
}

extern "C" int gespmm_gat_bwd_cols_bf16(int n, int K, int H, int vec,
                                        float slope, const int* colptr,
                                        const int* rows, const float* src,
                                        const float* dst, const void* B,
                                        const float* g, const float* mx,
                                        const float* den, const float* srow,
                                        void* grad_B, float* grad_dst,
                                        void* stream) {
  return (int)backward_cols<__nv_bfloat16>(
      n, K, H, vec, slope, colptr, rows, src, dst, (const __nv_bfloat16*)B, g,
      mx, den, srow, (__nv_bfloat16*)grad_B, grad_dst, (cudaStream_t)stream);
}

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
