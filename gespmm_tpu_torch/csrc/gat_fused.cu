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
//   alpha_e = z_e / den[r, h],  w_e = alpha_e * leaky'(pre_e)
//   grad_src[r, h] = sum_{k in h} g[r, k] * (sum_{e in row r} w_e B[c_e, k])
//                    - s[r, h] * sum_{e in row r} w_e
//   grad_dst[c, h] = sum_{k in h} B[c, k] * (sum_{e in col c} w_e g[r_e, k])
//                    - sum_{e in col c} w_e s[r_e, h]
//   grad_B[c, h-block] = sum_{e in col c} alpha_e * g[r_e, h-block]
//
// (the per-edge form dpre_e = alpha_e (<g[r], B[c]>_h - s[r, h]) leaky'(pre_e),
// summed over a row or a column, rearranged so that no per-edge dot is taken).
//
// Replaces gespmm_tpu/kernels/gat_fused.py::_forward (gat_fused.py:103) and
// _gat_bwd (:200), which on the TPU ran as four _reduce_part stream passes
// (spmm_stream.py:275): a K=H max pass and a (K+H)-wide aggregate forward,
// then a K=H pass over the plan and a (K+H)-wide pass over the transposed
// plan backward, each fed by XLA gathers of the node tables into slot order
// and writing its per-slot stream to device memory in between.  Here each
// direction is one kernel (plus a carry pass where a row or column is long);
// every per-edge quantity (pre, z, alpha, w) is recomputed in registers from
// the node tables and never stored in device memory.
//
// What bounds them: bytes and latency.  Per edge the forward gathers one
// K-wide row of B, the backward one K-wide row of B (CSR) or g (CSC), plus
// H-wide rows of the score tables, for O(K) flops and H exps: far below the
// card's ridge point.  The design is the CSR SpMM's (spmm_csr.cu):
//   * the work items are the segments of the long rows (columns) first, then
//     every row (column).  A row of at most L edges is walked whole by its own
//     walker and written out.  A longer row is skipped there, and each of its
//     segments (L consecutive edges, from the host-built split list,
//     sparse/partition.py::build_row_split) is walked by one walker, which
//     writes a partial state to its slot of a scratch buffer; a carry pass,
//     one warp per long row, merges the partials in segment order.  No carry
//     is launched when the split has no segment (sbm-pubmed);
//   * a walker is SW = 4, 8, 16 or 32 lanes of a warp, the fewest that cover
//     K / VEC columns (kernels/gat_fused.py::walk_shape): at K = 64 a 16-lane
//     walker with 16-byte lanes (two rows a warp), at K = 3 a 4-lane one
//     (eight rows a warp), so that short rows do not leave most lanes idle;
//   * the walk goes in batches of SW edges.  Lane j owns edge j of the batch:
//     it loads the edge's index and node-table entries and computes the
//     per-(edge, head) quantities once (the logit, z, alpha, w), for the
//     heads of the lanes' K slab.  They reach the column lanes through a
//     small shared-memory table per walker ([head][edge], stride SW + 1, so
//     that neither the writes nor the column lanes' reads conflict); the
//     edge index goes by shuffle;
//   * the lanes then run over columns, VEC consecutive each (vector loads;
//     VEC divides dh, so a lane's columns lie in one head), and gather the
//     B (or g) rows of 4 edges before folding any, with idle lanes reading
//     column 0 and the batch's last edge loaded again in place of edges past
//     its end, so that 4 gathers are in flight and none sits behind a branch
//     (an `if (active)` load in an unrolled loop compiled to a branch around
//     each gather in halo_spmm.cu);
//   * forward: one pass with an online softmax.  Each batch takes its
//     maximum per head (a shuffle tree), the running maximum m grows, and the
//     column lanes rescale their sums by exp(m_old - m_new) before adding the
//     batch.  A row of at most SW edges (every row of sbm-pubmed) has its
//     exact maximum at its first batch, so z is the JAX expression exactly.
//     For a longer row, exp(max(l - m_run, -80)) * exp(m_run - M) equals
//     exp(max(l - M, -80)) except where l - M < -80, where the two differ by
//     less than e^-80 against a denominator of at least 1 (the maximal edge
//     adds exp(0) = 1).  mx is still the exact row maximum (0 for an empty
//     row) and den still max(sum z, 1e-20).  A segment writes (m, zsum[H],
//     acc[K]); the softmax carry merges them: M = max m_i, den = sum
//     zsum_i e^(m_i - M), acc likewise, and writes out, mx and den.  In the
//     bound mode the shift is handed in, nothing is rescaled, and the same
//     carry adds (zsum, acc) with factor 1;
//   * backward over the CSR: the column lanes accumulate acc_k += w B[c, k]
//     and wsum += w; after the walk one head-segmented reduction of
//     g[r, k] * acc_k over the lanes gives grad_src.  A segment writes its
//     H-wide partial grad_src, which carry.cuh's sum carry adds;
//   * backward over the CSC: one walk gathers g[r] once per edge, K wide,
//     and accumulates accB_k += alpha g[r, k], accD_k += w g[r, k] and
//     sw += w s[r, h]; grad_B = accB, grad_dst = sum_{k in h} B[c, k] accD_k
//     - sw.  A segment writes a K-wide grad_B and an H-wide grad_dst partial,
//     each added by the sum carry;
//   * a head comes out whole when it straddles lanes or K slabs: the lanes'
//     per-column terms are summed by a suffix sum over the lanes of each
//     head's run (a fixed shuffle order), and a walker loops over the K slabs
//     of SW*VEC columns itself, carrying the partial of a head that continues
//     into the next slab;
//   * every output element is written once, without atomics, so two calls
//     agree bit for bit;
//   * expf, not __expf (the build does not use --use_fast_math), so the
//     float64 comparisons keep their margins.
// Not here yet: a multi-head edge step (the loop over the slab's heads runs
// a shuffle tree, an exp and, backward, four row-side gathers per head, so 8
// heads take 1.4-3.6x one head's time at the same K: PERF.md, section 6); the
// edge quantities of a batch kept for all K slabs (K > SW*VEC re-walks the
// edges per slab); the edges of several short rows in one batch (a row of
// about 5 edges leaves most of a walker's edge lanes idle).
//
// The walker's chain of dependent loads (indptr, indices, dst, B) sets a
// short row's time, so the first B rows of a batch are gathered before its
// edge math and overlap the dst gathers.
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// dh % VEC == 0 and every K-wide table aligned to VEC elements) and SW (4, 8,
// 16 or 32).  Each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

using gespmm::dispatch;  // (VEC, SW) -> the instantiation
using gespmm::from_f32;
using gespmm::item_edges;  // the split's work items (attention.cuh)
using gespmm::item_grid;
using gespmm::Item;
using gespmm::kDenomEps;
using gespmm::kExpFloor;
using gespmm::kThreads;
using gespmm::Pack;
using gespmm::Split;
using gespmm::Sub;  // a walker of SW lanes
using gespmm::to_f32;

constexpr int kBatch = 4;  // table rows gathered before they are folded

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

__device__ __forceinline__ float dleaky(float x, float slope) {
  return x >= 0.f ? 1.f : slope;
}

// z_e / den: the attention weight of one (edge, head).
__device__ __forceinline__ float attention(float pre, float slope, float mx,
                                           float den) {
  return expf(fmaxf(leaky(pre, slope) - mx, kExpFloor)) / fmaxf(den, kDenomEps);
}


// The lane's place in K slab `slab` of SW*VEC columns: its first column k,
// the heads h_lo .. h_lo + nh - 1 of the slab, its own head hd (h_lo for a
// lane past K, which reads column 0 and drops its result), and the end of
// its head's run of columns in the slab.
template <int SW, int VEC>
struct Cols {
  int k_begin, k_end, k, kk, h_lo, nh, hd, hh, run_end;
  bool active;
  __device__ Cols(int slab, int K, int dh, int lane) {
    k_begin = slab * SW * VEC;
    k_end = min(K, k_begin + SW * VEC);
    k = k_begin + lane * VEC;
    active = k < K;
    kk = active ? k : 0;
    h_lo = k_begin / dh;
    nh = (k_end - 1) / dh - h_lo + 1;
    hd = active ? k / dh : h_lo;
    hh = hd - h_lo;
    run_end = min(k_end, (hd + 1) * dh);
  }
};

// The sum of x over the lanes of this lane's head run from this lane on (a
// suffix sum in a fixed order): the run's first lane gets the run's total.
template <int SW, int VEC>
__device__ __forceinline__ float head_sum(const Sub<SW>& w,
                                          const Cols<SW, VEC>& cl, float x) {
#pragma unroll
  for (int d = 1; d < SW; d <<= 1) {
    const float y = w.down(x, d);
    if (cl.active && cl.k + d * VEC < cl.run_end) x += y;
  }
  return x;
}

// After head_sum: adds the partial carried in from the previous slab (the
// head that continues into this one, whose run starts at lane 0), moves the
// partial of the slab's last head into `carry` if that head continues into
// the next slab, and returns whether this lane writes its head's total (the
// first lane of a head that ends in this slab).
template <int SW, int VEC>
__device__ __forceinline__ bool head_total(const Sub<SW>& w,
                                           const Cols<SW, VEC>& cl, int dh,
                                           float& x, float& carry) {
  if (w.lane == 0) x += carry;
  const int h_hi = cl.h_lo + cl.nh - 1;
  const float last = w.get(x, max(h_hi * dh - cl.k_begin, 0) / VEC);
  carry = (h_hi + 1) * dh > cl.k_end ? last : 0.f;
  return cl.active && (w.lane == 0 || cl.k % dh == 0) &&
         (cl.hd + 1) * dh <= cl.k_end;
}

template <typename T, int VEC, int SW>
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(int m, int S, int K, int H, int dh, int L, int nh_max,
               int exact, float slope, const int* __restrict__ indptr,
               const int* __restrict__ indices,
               const int* __restrict__ seg_row,
               const int* __restrict__ seg_start,
               const float* __restrict__ src, const float* __restrict__ dst,
               const T* __restrict__ B, float* __restrict__ mx,
               T* __restrict__ out, float* __restrict__ den,
               float* __restrict__ pm, float* __restrict__ pz,
               float* __restrict__ pacc) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  constexpr int kStride = SW + 1;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  extern __shared__ float smem[];
  float* zb = smem + (threadIdx.x / SW) * nh_max * kStride;  // [head][edge]
  const int nslab = (K + SW * VEC - 1) / (SW * VEC);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + m;
       item += gridDim.x * kPerBlock) {
    Item it;
    if (!item_edges(item, S, L, indptr, seg_row, seg_start, it)) continue;
    const int64_t rH = (int64_t)it.row * H;
    for (int slab = 0; slab < nslab; ++slab) {
      const Cols<SW, VEC> cl(slab, K, dh, w.lane);
      // Lane hh < nh keeps head h_lo + hh's shift and its batch rescale.
      float m_run = -CUDART_INF_F, scale = 1.f;
      if (!exact && w.lane < cl.nh) m_run = mx[rH + cl.h_lo + w.lane];
      float acc[VEC], zsum = 0.f;
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
      for (int base = it.s; base < it.t; base += SW) {
        // Warp-uniform down to the shuffles: every lane of the walker takes
        // part; a lane past the batch takes edge index 0 and weight 0.
        const int e = base + w.lane;
        const bool live = e < it.t;
        const int c = live ? __ldg(indices + e) : 0;
        const int n_here = min(SW, it.t - base);
        // The first B rows are gathered before the edge math, so that their
        // loads overlap the dst gathers.
        auto gather = [&](P (&p)[kBatch], int u0) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int cj = w.get(c, min(u0 + u, n_here - 1));
            p[u] = *reinterpret_cast<const P*>(B + (int64_t)cj * K + cl.kk);
          }
        };
        P p[kBatch];
        gather(p, 0);
        for (int hh = 0; hh < cl.nh; ++hh) {
          const int h = cl.h_lo + hh;
          const float l = leaky(
              __ldg(src + rH + h) + __ldg(dst + (int64_t)c * H + h), slope);
          const float m_old = w.get(m_run, hh);
          const float m_new =
              exact ? fmaxf(m_old, w.max(live ? l : -CUDART_INF_F)) : m_old;
          zb[hh * kStride + w.lane] =
              live ? expf(fmaxf(l - m_new, kExpFloor)) : 0.f;
          if (w.lane == hh) {
            scale = m_old == m_new ? 1.f : expf(m_old - m_new);
            m_run = m_new;
          }
        }
        w.sync();
        if (exact) {
          const float sc = w.get(scale, cl.hh);
          zsum *= sc;
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[t] *= sc;
        }
        for (int u0 = 0;;) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u0 + u < n_here) {
              const float z = zb[cl.hh * kStride + u0 + u];
              zsum += z;
#pragma unroll
              for (int t = 0; t < VEC; ++t)
                acc[t] = fmaf(z, to_f32(p[u].v[t]), acc[t]);
            }
          }
          u0 += kBatch;
          if (u0 >= n_here) break;
          gather(p, u0);
        }
        w.sync();  // the next batch overwrites zb
      }
      const float m_h = w.get(m_run, cl.hh);
      if (!cl.active) continue;
      const bool first = cl.k % dh == 0;  // holds its head's first column
      if (item < S) {
        F o;
#pragma unroll
        for (int t = 0; t < VEC; ++t) o.v[t] = acc[t];
        *reinterpret_cast<F*>(pacc + (int64_t)item * K + cl.k) = o;
        if (first) {
          pm[(int64_t)item * H + cl.hd] = m_h;
          pz[(int64_t)item * H + cl.hd] = zsum;
        }
      } else {
        const float d = fmaxf(zsum, kDenomEps);
        P o;
#pragma unroll
        for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[t] / d);
        *reinterpret_cast<P*>(out + (int64_t)it.row * K + cl.k) = o;
        if (first) {
          den[rH + cl.hd] = d;
          if (exact) mx[rH + cl.hd] = isfinite(m_h) ? m_h : 0.f;
        }
      }
    }
  }
}

template <typename T, int VEC, int SW>
__global__ void __launch_bounds__(kThreads)
gat_bwd_rows_kernel(int m, int S, int K, int H, int dh, int L, int nh_max,
                    float slope, const int* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const int* __restrict__ seg_row,
                    const int* __restrict__ seg_start,
                    const float* __restrict__ src,
                    const float* __restrict__ dst, const T* __restrict__ B,
                    const float* __restrict__ g, const float* __restrict__ mx,
                    const float* __restrict__ den,
                    const float* __restrict__ srow,
                    float* __restrict__ grad_src, float* __restrict__ part) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  constexpr int kStride = SW + 1;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  extern __shared__ float smem[];
  float* wb = smem + (threadIdx.x / SW) * nh_max * kStride;  // [head][edge]
  const int nslab = (K + SW * VEC - 1) / (SW * VEC);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + m;
       item += gridDim.x * kPerBlock) {
    Item it;
    if (!item_edges(item, S, L, indptr, seg_row, seg_start, it)) continue;
    const int64_t rH = (int64_t)it.row * H;
    float carry = 0.f;
    for (int slab = 0; slab < nslab; ++slab) {
      const Cols<SW, VEC> cl(slab, K, dh, w.lane);
      // Lane hh < nh holds the row-side tables of head h_lo + hh.
      float s_h = 0.f, m_h = 0.f, d_h = 1.f;
      if (w.lane < cl.nh) {
        const int64_t at = rH + cl.h_lo + w.lane;
        s_h = src[at];
        m_h = mx[at];
        d_h = den[at];
      }
      float acc[VEC], wsum = 0.f;
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
      for (int base = it.s; base < it.t; base += SW) {
        const int e = base + w.lane;
        const bool live = e < it.t;
        const int c = live ? __ldg(indices + e) : 0;
        const int n_here = min(SW, it.t - base);
        auto gather = [&](P (&p)[kBatch], int u0) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int cj = w.get(c, min(u0 + u, n_here - 1));
            p[u] = *reinterpret_cast<const P*>(B + (int64_t)cj * K + cl.kk);
          }
        };
        P p[kBatch];
        gather(p, 0);
        for (int hh = 0; hh < cl.nh; ++hh) {
          const float pre =
              w.get(s_h, hh) + __ldg(dst + (int64_t)c * H + cl.h_lo + hh);
          const float a = attention(pre, slope, w.get(m_h, hh), w.get(d_h, hh));
          wb[hh * kStride + w.lane] = live ? a * dleaky(pre, slope) : 0.f;
        }
        w.sync();
        for (int u0 = 0;;) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u0 + u < n_here) {
              const float wt = wb[cl.hh * kStride + u0 + u];
              wsum += wt;
#pragma unroll
              for (int t = 0; t < VEC; ++t)
                acc[t] = fmaf(wt, to_f32(p[u].v[t]), acc[t]);
            }
          }
          u0 += kBatch;
          if (u0 >= n_here) break;
          gather(p, u0);
        }
        w.sync();
      }
      float x = 0.f;
      if (cl.active) {
        const F gv = *reinterpret_cast<const F*>(g + (int64_t)it.row * K + cl.k);
#pragma unroll
        for (int t = 0; t < VEC; ++t) x = fmaf(gv.v[t], acc[t], x);
      }
      x = head_sum(w, cl, x);
      if (head_total(w, cl, dh, x, carry)) {
        const float v = fmaf(-__ldg(srow + rH + cl.hd), wsum, x);
        if (item < S)
          part[(int64_t)item * H + cl.hd] = v;
        else
          grad_src[rH + cl.hd] = v;
      }
    }
  }
}

template <typename T, int VEC, int SW>
__global__ void __launch_bounds__(kThreads)
gat_bwd_cols_kernel(int n, int S, int K, int H, int dh, int L, int nh_max,
                    float slope, const int* __restrict__ colptr,
                    const int* __restrict__ rows,
                    const int* __restrict__ seg_row,
                    const int* __restrict__ seg_start,
                    const float* __restrict__ src,
                    const float* __restrict__ dst, const T* __restrict__ B,
                    const float* __restrict__ g, const float* __restrict__ mx,
                    const float* __restrict__ den,
                    const float* __restrict__ srow, T* __restrict__ grad_B,
                    float* __restrict__ grad_dst, float* __restrict__ part_B,
                    float* __restrict__ part_dst) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  constexpr int kStride = SW + 1;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  extern __shared__ float smem[];
  // [head][edge] tables of alpha, w and w * s[r, h].
  float* ab = smem + (threadIdx.x / SW) * 3 * nh_max * kStride;
  float* wb = ab + nh_max * kStride;
  float* qb = wb + nh_max * kStride;
  const int nslab = (K + SW * VEC - 1) / (SW * VEC);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + n;
       item += gridDim.x * kPerBlock) {
    Item it;  // it.row is the column
    if (!item_edges(item, S, L, colptr, seg_row, seg_start, it)) continue;
    const int64_t cH = (int64_t)it.row * H;
    float carry = 0.f;
    for (int slab = 0; slab < nslab; ++slab) {
      const Cols<SW, VEC> cl(slab, K, dh, w.lane);
      const float d_c = w.lane < cl.nh ? dst[cH + cl.h_lo + w.lane] : 0.f;
      float accB[VEC], accD[VEC], sw = 0.f;
#pragma unroll
      for (int t = 0; t < VEC; ++t) accB[t] = accD[t] = 0.f;
      for (int base = it.s; base < it.t; base += SW) {
        const int e = base + w.lane;
        const bool live = e < it.t;
        const int r = live ? __ldg(rows + e) : 0;
        const int n_here = min(SW, it.t - base);
        auto gather = [&](F (&gv)[kBatch], int u0) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int rj = w.get(r, min(u0 + u, n_here - 1));
            gv[u] = *reinterpret_cast<const F*>(g + (int64_t)rj * K + cl.kk);
          }
        };
        F gv[kBatch];
        gather(gv, 0);
        for (int hh = 0; hh < cl.nh; ++hh) {
          const int64_t rh = (int64_t)r * H + cl.h_lo + hh;
          const float pre = __ldg(src + rh) + w.get(d_c, hh);
          const float a = attention(pre, slope, __ldg(mx + rh), __ldg(den + rh));
          const float wv = a * dleaky(pre, slope);
          const float q = wv * __ldg(srow + rh);
          ab[hh * kStride + w.lane] = live ? a : 0.f;
          wb[hh * kStride + w.lane] = live ? wv : 0.f;
          qb[hh * kStride + w.lane] = live ? q : 0.f;
        }
        w.sync();
        for (int u0 = 0;;) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u0 + u < n_here) {
              const int at = cl.hh * kStride + u0 + u;
              const float a = ab[at], wv = wb[at];
              sw += qb[at];
#pragma unroll
              for (int t = 0; t < VEC; ++t) {
                accB[t] = fmaf(a, gv[u].v[t], accB[t]);
                accD[t] = fmaf(wv, gv[u].v[t], accD[t]);
              }
            }
          }
          u0 += kBatch;
          if (u0 >= n_here) break;
          gather(gv, u0);
        }
        w.sync();
      }
      float x = 0.f;
      if (cl.active) {
        const P b = *reinterpret_cast<const P*>(B + (int64_t)it.row * K + cl.k);
#pragma unroll
        for (int t = 0; t < VEC; ++t) x = fmaf(to_f32(b.v[t]), accD[t], x);
        if (item < S) {
          F o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = accB[t];
          *reinterpret_cast<F*>(part_B + (int64_t)item * K + cl.k) = o;
        } else {
          P o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(accB[t]);
          *reinterpret_cast<P*>(grad_B + (int64_t)it.row * K + cl.k) = o;
        }
      }
      x = head_sum(w, cl, x);
      if (head_total(w, cl, dh, x, carry)) {
        const float v = x - sw;
        if (item < S)
          part_dst[(int64_t)item * H + cl.hd] = v;
        else
          grad_dst[cH + cl.hd] = v;
      }
    }
  }
}

// --- launches --------------------------------------------------------------

// The most heads any K slab of W columns touches.
int heads_per_slab(int K, int dh, int W) {
  int most = 1;
  for (int k0 = 0; k0 < K; k0 += W) {
    const int h = (min(K, k0 + W) - 1) / dh - k0 / dh + 1;
    most = h > most ? h : most;
  }
  return most;
}

// Dynamic shared memory of `tables` [head][edge] tables a walker, opting in
// above the default 48 KiB.
template <typename Kernel>
cudaError_t shared_bytes(Kernel kernel, int sw, int tables, int nh,
                         size_t* bytes) {
  *bytes = (size_t)(kThreads / sw) * tables * nh * (sw + 1) * sizeof(float);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

bool aligned(const void* p, size_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

bool bad_args(int K, int H, int vec, const Split& sp) {
  return H < 1 || K < 1 || K % H != 0 || (K / H) % vec != 0 ||
         gespmm::bad_split(sp);
}

template <typename T>
cudaError_t forward(int m, int K, int H, int vec, int sw, int exact,
                    float slope, const Split& sp, const int* indptr,
                    const int* indices, const float* src, const float* dst,
                    const T* B, float* mx, T* out, float* den, float* pm,
                    float* pz, float* pacc, cudaStream_t stream) {
  if (bad_args(K, H, vec, sp)) return cudaErrorInvalidValue;
  const int dh = K / H;
  return dispatch(vec, sw, [&](auto V, auto W) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    if (!aligned(B, VEC * sizeof(T)) || !aligned(out, VEC * sizeof(T)) ||
        (sp.S > 0 && !aligned(pacc, VEC * sizeof(float))))
      return cudaErrorInvalidValue;
    auto kernel = gat_fwd_kernel<T, VEC, SW>;
    const int nh = heads_per_slab(K, dh, SW * VEC);
    size_t smem;
    cudaError_t err = shared_bytes(kernel, SW, 1, nh, &smem);
    if (err != cudaSuccess) return err;
    kernel<<<item_grid(sp.S + m, SW), kThreads, smem, stream>>>(
        m, sp.S, K, H, dh, sp.L, nh, exact, slope, indptr, indices,
        sp.seg_row, sp.seg_start, src, dst, B, mx, out, den, pm, pz, pacc);
    err = cudaGetLastError();
    if (err != cudaSuccess || sp.J == 0) return err;
    return gespmm::launch_softmax_carry<T, VEC>(sp.J, K, H, exact,
                                               sp.long_rows, sp.seg_ptr, pm,
                                               pz, pacc, out, mx, den, stream);
  });
}

template <typename T>
cudaError_t backward_rows(int m, int K, int H, int vec, int sw, float slope,
                          const Split& sp, const int* indptr,
                          const int* indices, const float* src,
                          const float* dst, const T* B, const float* g,
                          const float* mx, const float* den, const float* srow,
                          float* grad_src, float* part, cudaStream_t stream) {
  if (bad_args(K, H, vec, sp)) return cudaErrorInvalidValue;
  const int dh = K / H;
  return dispatch(vec, sw, [&](auto V, auto W) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    if (!aligned(B, VEC * sizeof(T)) || !aligned(g, VEC * sizeof(float)))
      return cudaErrorInvalidValue;
    auto kernel = gat_bwd_rows_kernel<T, VEC, SW>;
    const int nh = heads_per_slab(K, dh, SW * VEC);
    size_t smem;
    cudaError_t err = shared_bytes(kernel, SW, 1, nh, &smem);
    if (err != cudaSuccess) return err;
    kernel<<<item_grid(sp.S + m, SW), kThreads, smem, stream>>>(
        m, sp.S, K, H, dh, sp.L, nh, slope, indptr, indices, sp.seg_row,
        sp.seg_start, src, dst, B, g, mx, den, srow, grad_src, part);
    err = cudaGetLastError();
    if (err != cudaSuccess || sp.J == 0) return err;
    return gespmm::launch_carry<float, 1>(sp.J, H, sp.long_rows, sp.seg_ptr,
                                          part, grad_src, stream);
  });
}

template <typename T>
cudaError_t backward_cols(int n, int K, int H, int vec, int sw, float slope,
                          const Split& sp, const int* colptr, const int* rows,
                          const float* src, const float* dst, const T* B,
                          const float* g, const float* mx, const float* den,
                          const float* srow, T* grad_B, float* grad_dst,
                          float* part_B, float* part_dst, cudaStream_t stream) {
  if (bad_args(K, H, vec, sp)) return cudaErrorInvalidValue;
  const int dh = K / H;
  return dispatch(vec, sw, [&](auto V, auto W) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    if (!aligned(B, VEC * sizeof(T)) || !aligned(g, VEC * sizeof(float)) ||
        !aligned(grad_B, VEC * sizeof(T)) ||
        (sp.S > 0 && !aligned(part_B, VEC * sizeof(float))))
      return cudaErrorInvalidValue;
    auto kernel = gat_bwd_cols_kernel<T, VEC, SW>;
    const int nh = heads_per_slab(K, dh, SW * VEC);
    size_t smem;
    cudaError_t err = shared_bytes(kernel, SW, 3, nh, &smem);
    if (err != cudaSuccess) return err;
    kernel<<<item_grid(sp.S + n, SW), kThreads, smem, stream>>>(
        n, sp.S, K, H, dh, sp.L, nh, slope, colptr, rows, sp.seg_row,
        sp.seg_start, src, dst, B, g, mx, den, srow, grad_B, grad_dst, part_B,
        part_dst);
    err = cudaGetLastError();
    if (err != cudaSuccess || sp.J == 0) return err;
    err = gespmm::launch_carry<T, VEC>(sp.J, K, sp.long_rows, sp.seg_ptr,
                                       part_B, grad_B, stream);
    if (err != cudaSuccess) return err;
    return gespmm::launch_carry<float, 1>(sp.J, H, sp.long_rows, sp.seg_ptr,
                                          part_dst, grad_dst, stream);
  });
}

}  // namespace

// Every entry point takes the split of its structure: segment length L, S
// segments and J long rows (S = J = 0: no split, no carry) with the lists
// seg_row, seg_start (S), long_rows (J) and seg_ptr (J + 1), and scratch
// buffers of S rows (null when S = 0).

// Forward over the CSR (indptr, indices): m >= 1, K >= 1, nnz >= 1 (the
// caller returns early otherwise).  src (m, H), dst (n, H), mx and den
// (m, H) are f32; B (n, K) and out (m, K) are of one type.  exact = 1 writes
// mx; exact = 0 reads it (the bound mode's shift, computed by the caller).
// Scratch: pm, pz (S, H) and pacc (S, K), f32.
#define GESPMM_GAT_FWD(NAME, T)                                               \
  extern "C" int NAME(int m, int K, int H, int vec, int sw, int exact,        \
                      float slope, int L, int S, int J, const int* seg_row,   \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const int* indptr,                  \
                      const int* indices, const float* src, const float* dst, \
                      const void* B, float* mx, void* out, float* den,        \
                      float* pm, float* pz, float* pacc, void* stream) {      \
    return (int)forward<T>(m, K, H, vec, sw, exact, slope,                    \
                           Split{L, S, J, seg_row, seg_start, long_rows,      \
                                 seg_ptr},                                    \
                           indptr, indices, src, dst, (const T*)B, mx,        \
                           (T*)out, den, pm, pz, pacc, (cudaStream_t)stream); \
  }

GESPMM_GAT_FWD(gespmm_gat_fwd_f32, float)
GESPMM_GAT_FWD(gespmm_gat_fwd_bf16, __nv_bfloat16)

// Backward over the CSR: grad_src (m, H) f32.  g (m, K), mx, den and srow
// (m, H) are f32; B (n, K) is f32 or bf16.  Scratch: part (S, H), f32.
#define GESPMM_GAT_BWD_ROWS(NAME, T)                                          \
  extern "C" int NAME(int m, int K, int H, int vec, int sw, float slope,      \
                      int L, int S, int J, const int* seg_row,                \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const int* indptr,                  \
                      const int* indices, const float* src, const float* dst, \
                      const void* B, const float* g, const float* mx,         \
                      const float* den, const float* srow, float* grad_src,   \
                      float* part, void* stream) {                            \
    return (int)backward_rows<T>(                                             \
        m, K, H, vec, sw, slope,                                              \
        Split{L, S, J, seg_row, seg_start, long_rows, seg_ptr}, indptr,       \
        indices, src, dst, (const T*)B, g, mx, den, srow, grad_src, part,     \
        (cudaStream_t)stream);                                                \
  }

GESPMM_GAT_BWD_ROWS(gespmm_gat_bwd_rows_f32, float)
GESPMM_GAT_BWD_ROWS(gespmm_gat_bwd_rows_bf16, __nv_bfloat16)

// Backward over the CSC (colptr, rows): n >= 1 columns; grad_B (n, K) in B's
// type and grad_dst (n, H) f32.  The row-side tables are those of the
// backward over the CSR.  Scratch: part_B (S, K) and part_dst (S, H), f32.
#define GESPMM_GAT_BWD_COLS(NAME, T)                                          \
  extern "C" int NAME(int n, int K, int H, int vec, int sw, float slope,      \
                      int L, int S, int J, const int* seg_row,                \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const int* colptr,                  \
                      const int* rows, const float* src, const float* dst,    \
                      const void* B, const float* g, const float* mx,         \
                      const float* den, const float* srow, void* grad_B,      \
                      float* grad_dst, float* part_B, float* part_dst,        \
                      void* stream) {                                         \
    return (int)backward_cols<T>(                                             \
        n, K, H, vec, sw, slope,                                              \
        Split{L, S, J, seg_row, seg_start, long_rows, seg_ptr}, colptr, rows, \
        src, dst, (const T*)B, g, mx, den, srow, (T*)grad_B, grad_dst,        \
        part_B, part_dst, (cudaStream_t)stream);                              \
  }

GESPMM_GAT_BWD_COLS(gespmm_gat_bwd_cols_f32, float)
GESPMM_GAT_BWD_COLS(gespmm_gat_bwd_cols_bf16, __nv_bfloat16)

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
