// Fused dot-product graph attention for Hopper (sm_90a): forward over the
// CSR, backward over the CSR (to D1) and over the CSC (to D2 and to B).  With
// D1 (m, Ka), D2 (n, Ka) and B (n, K) in H head blocks (dk = Ka / H columns
// of D1 and D2, dv = K / H of B a head; H = 1 is one head over all columns),
// a scale sc (1 where none is given), act = identity or leaky(., slope), and
// per (edge, head) an edge factor m~_e (1 / keep_prob where the dropout mask
// keeps the edge, 0 where it drops it, 1 without a mask), per head h:
//
//   pre_e = sc * <D1[r], D2[c]>_h,   l_e = act(pre_e)
//   mx[r]  = max_{e in row r} l_e   (0 for an empty row)
//   z_e    = exp(max(l_e - mx[r], -80))
//   den[r] = max(sum_{e in row r} z_e, 1e-20)
//   out[r]_h = sum_{e in row r} z_e * m~_e * B[c]_h / den[r]
//
// (alpha_e = z_e / den[r] is the softmax; the dropout multiplies the weights
// after it, so den sums the undropped z) and, for the cotangent g of out,
// with s[r] = <g[r], out[r]>_h (one torch op before the launch, from the
// stored out, which already holds the dropped weights, so s is still the
// softmax backward's row term):
//
//   u_e = <g[r], B[c]>_h,   dpre_e = alpha_e * (m~_e * u_e - s[r]) * act'(pre_e)
//   grad_D1[r]_h = sum_{e in row r} sc * dpre_e * D2[c]_h
//   grad_D2[c]_h = sum_{e in col c} sc * dpre_e * D1[r]_h
//   grad_B[c]_h  = sum_{e in col c} alpha_e * m~_e * g[r]_h
//
// The single-head kernels below take H = 1 with no scale and no mask; the
// multi-head kernels (after them) take the rest.
//
// Replaces gespmm_tpu/kernels/gat_fused.py::_dot_forward (gat_fused.py:317)
// and _dot_bwd (:382), which on the TPU ran as four _reduce_part stream passes
// (spmm_stream.py:275): a K=1 max pass and a (K+1)-wide aggregate forward,
// then a Ka-wide pass over the plan (:401-428) and a (K+Ka)-wide pass over
// the transposed plan (:430-463) backward, each fed by XLA gathers of
// combined node tables into slot order and writing its per-slot stream to
// device memory in between.  Here each direction is one kernel (plus a carry
// pass where a row or column is long), and every per-edge quantity (pre, z,
// alpha, u, dpre) lives in registers only.
//
// What bounds them: bytes and latency.  Per edge the forward gathers one
// Ka-wide row of D2 and one K-wide row of B for about 2(Ka + K) flops and one
// exp; the backward over the CSR gathers the same two rows, the backward over
// the CSC one Ka-wide row of D1 and one K-wide row of g: far below the card's
// ridge point.  The design is the split walk of gat_fused.cu (row 5):
//   * the work items are the segments of the rows (columns) above L edges
//     first, then every row (column) (attention.cuh).  A row of at most L
//     edges is walked whole by its own walker and written out; a segment
//     writes a partial state to its slot of a scratch buffer, and a carry
//     pass merges a long row's slots in segment order: the softmax carry
//     forward (m, zsum, acc), carry.cuh's sum carry for grad_D1 backward and
//     two sum carries (grad_B, grad_D2) over the CSC.  No carry is launched
//     when the split has no segment (sbm-pubmed);
//   * a walker is SW = 4-32 lanes of a warp with VEC columns a lane
//     (kernels/gat_fused.py::dot_walk_shape: VEC divides K and Ka, SW*VEC
//     covers the wider of them): at Ka = K = 64 two 16-lane walkers a warp
//     with 16-byte lanes;
//   * walker-wide dots: a lane holds its VEC columns of the item's own rows
//     (D1[r], and g[r] over the CSR; D2[c] and B[c] over the CSC), gathers
//     the same columns of the other side's rows for each edge and takes a
//     partial dot, which the walker's xor-shuffle tree finishes.  So over the
//     CSR the D2 row gathered for pre is the row that grad_D1 accumulates,
//     and over the CSC one walk gives grad_D2 and grad_B with each D1 and g
//     row gathered once;
//   * each walker gathers the rows of a batch of edges (4 forward, 2
//     backward) before any is folded, with no branch around a gather: past a
//     round's end the last edge is loaded again and not folded (a load
//     behind `if (active)` in an unrolled one-edge loop compiles to a branch
//     around each gather, halo_spmm.cu's lesson);
//   * the forward is one pass with an online softmax over rounds of SW edges:
//     the round's logits first (lane j keeps edge j's), its maximum by a
//     shuffle tree, the running sums rescaled by exp(m_old - m_new), then the
//     round's B rows folded, the first batch of them gathered before the
//     logits.  A row of at most SW edges has its exact maximum in its first
//     round, so z is exp(max(l - mx, -80)) exactly; for a longer one the
//     product of the rescalings (equal up to rounding, and to the floor,
//     which only changes weights below 1.8e-35 against a denominator >= 1);
//   * the three kernels compute pre with one function (edge_dots and the
//     walker's tree, or lane_dot at VEC = 1: the same lane columns, the same
//     fma order, the same shuffles; fmaf is symmetric in its factors, so
//     holding D2 and gathering D1 gives the same bits), so the backward's
//     alpha meets the forward's mx and den bit for bit when the three
//     launches take one (VEC, SW) (kernels/gat_fused.py::dot_walk_shape picks
//     it from K, Ka and D1, D2, B for all three; a g that is not aligned to
//     that VEC is copied before the backward launches);
//   * every output element is written once, without atomics, so each kernel
//     is bitwise repeatable; expf, not __expf (no --use_fast_math), so the
//     float64 comparisons keep their margins.
// At VEC = 1 (K or Ka odd) each lane takes its own edge's dots serially
// instead (the first port's arithmetic) inside the same split walk, and over
// the CSR the D2 rows are gathered a second time to accumulate grad_D1: a
// walker-wide dot of 1-column lanes spends a shuffle tree on every edge for
// a few bytes a lane, and lost to it at (Ka, K) = (16, 3) (PERF.md, section 6).
// scripts/row6_ab.py rebuilds this source with each of these choices (the
// dots, the batch depths, the forward's register bound) changed.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>

#include "attention.cuh"

namespace {

using gespmm::dispatch;  // (VEC, SW) -> the instantiation
using gespmm::from_f32;
using gespmm::item_edges;
using gespmm::item_grid;
using gespmm::Item;
using gespmm::kDenomEps;
using gespmm::kExpFloor;
using gespmm::kThreads;
using gespmm::Pack;
using gespmm::Split;
using gespmm::Sub;
using gespmm::to_f32;

// Edges whose rows a walker gathers before it folds any, a kernel each.
constexpr int kFwdBatch = 4;
constexpr int kRowsBatch = 2;
constexpr int kColsBatch = 2;
// Blocks of kThreads an SM that the forward's registers must allow: three
// (at most 80 registers) was faster at sbm and rmat15, where a bound slowed
// the CSR backward (PERF.md, section 6).
constexpr int kFwdMinBlocks = 3;
// Lane-serial dots at VEC = 1, walker-wide dots elsewhere.
template <int VEC>
constexpr bool kLaneDots = VEC == 1;

__device__ __forceinline__ float act(float x, int leaky, float slope) {
  return (leaky && x < 0.f) ? slope * x : x;
}

__device__ __forceinline__ float dact(float x, int leaky, float slope) {
  return (leaky && x < 0.f) ? slope : 1.f;
}

// alpha = z / den from the row-side tables.
__device__ __forceinline__ float attention(float pre, int leaky, float slope,
                                           float mx, float den) {
  return expf(fmaxf(act(pre, leaky, slope) - mx, kExpFloor)) /
         fmaxf(den, kDenomEps);
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* __restrict__ p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

// The lane's first column in slab `slab` of SW*VEC columns of a table
// `width` wide (column 0 past the width, where `on` is false).
template <int VEC, int SW>
struct Col {
  int kk;
  bool on;
  __device__ Col(int slab, int width, int lane) {
    const int k = (slab * SW + lane) * VEC;
    on = k < width;
    kk = on ? k : 0;
  }
};

// p[u] += x . y[u] over the lane's VEC columns, in column order.
template <typename TA, typename TB, int VEC, int N>
__device__ __forceinline__ void add_dots(const Pack<TA, VEC>& x,
                                         const Pack<TB, VEC> (&y)[N], bool on,
                                         float (&p)[N]) {
  if (!on) return;
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int t = 0; t < VEC; ++t)
      p[u] = fmaf(to_f32(x.v[t]), to_f32(y[u].v[t]), p[u]);
}

template <typename T, int VEC, int N>
__device__ __forceinline__ void gather(const T* (&rows)[N], int kk,
                                       Pack<T, VEC> (&y)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) y[u] = load<T, VEC>(rows[u] + kk);
}

// The lane's partial of a . rows[u] from slab 0's gathered columns y0 (held
// x0) and the other slabs of the width, gathered here: the slabs in order,
// each the lane's VEC columns in order.  With the walker's tree (sums) after
// it, this is the dot of every kernel here (see the header).
template <typename TA, typename TB, int VEC, int SW, int N>
__device__ __forceinline__ void edge_dots(int lane, int width,
                                          const TA* __restrict__ a,
                                          const Pack<TA, VEC>& x0,
                                          const TB* (&rows)[N],
                                          const Pack<TB, VEC> (&y0)[N],
                                          float (&p)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) p[u] = 0.f;
  add_dots(x0, y0, Col<VEC, SW>(0, width, lane).on, p);
  const int nslab = (width + SW * VEC - 1) / (SW * VEC);
  for (int slab = 1; slab < nslab; ++slab) {
    const Col<VEC, SW> cl(slab, width, lane);
    Pack<TB, VEC> y[N];
    gather(rows, cl.kk, y);
    add_dots(load<TA, VEC>(a + cl.kk), y, cl.on, p);
  }
}

// The walker's totals of N partials, in every lane: Sub::sum's butterfly.
template <int SW, int N>
__device__ __forceinline__ void sums(const Sub<SW>& w, float (&p)[N]) {
#pragma unroll
  for (int s = SW / 2; s > 0; s >>= 1)
#pragma unroll
    for (int u = 0; u < N; ++u) p[u] += __shfl_xor_sync(w.mask, p[u], s, SW);
}

// One lane's serial dot of two rows `width` wide (the lane-dots variant).
template <typename TA, typename TB, int VEC>
__device__ __forceinline__ float lane_dot(const TA* __restrict__ a,
                                          const TB* __restrict__ b,
                                          int width) {
  float acc = 0.f;
  for (int i = 0; i < width; i += VEC) {
    const Pack<TA, VEC> x = load<TA, VEC>(a + i);
    const Pack<TB, VEC> y = load<TB, VEC>(b + i);
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc = fmaf(to_f32(x.v[t]), to_f32(y.v[t]), acc);
  }
  return acc;
}

// The row pointers of the edges u0 .. u0 + N - 1 of a round (its last edge
// in place of those past its end), from the lanes' edge indices c.
template <typename T, int SW, int N>
__device__ __forceinline__ void batch_rows(const Sub<SW>& w, int c, int u0,
                                           int n_here, const T* table,
                                           int width, const T* (&rows)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u)
    rows[u] = table + (int64_t)w.get(c, min(u0 + u, n_here - 1)) * width;
}

template <typename T, int VEC, int SW>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
dot_fwd_kernel(int m, int S, int K, int Ka, int L, int leaky, float slope,
               const int* __restrict__ indptr, const int* __restrict__ indices,
               const int* __restrict__ seg_row,
               const int* __restrict__ seg_start, const float* __restrict__ D1,
               const float* __restrict__ D2, const T* __restrict__ B,
               T* __restrict__ out, float* __restrict__ mx,
               float* __restrict__ den, float* __restrict__ pm,
               float* __restrict__ pz, float* __restrict__ pacc) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  const int nslab = (K + SW * VEC - 1) / (SW * VEC);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + m;
       item += gridDim.x * kPerBlock) {
    Item it;
    if (!item_edges(item, S, L, indptr, seg_row, seg_start, it)) continue;
    const float* __restrict__ d1 = D1 + (int64_t)it.row * Ka;
    const Col<VEC, SW> ca(0, Ka, w.lane);
    const F x0 = load<float, VEC>(d1 + ca.kk);
    for (int slab = 0; slab < nslab; ++slab) {
      const Col<VEC, SW> cl(slab, K, w.lane);
      float m_run = -CUDART_INF_F, zsum = 0.f, acc[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
      for (int base = it.s; base < it.t; base += SW) {
        // Walker-uniform down to the shuffles: all SW lanes take part.
        const int e = base + w.lane;
        const bool live = e < it.t;
        const int c = live ? __ldg(indices + e) : 0;
        const int n_here = min(SW, it.t - base);
        const T* brows[kFwdBatch];
        P p[kFwdBatch];
        batch_rows(w, c, 0, n_here, B + cl.kk, K, brows);
        gather(brows, 0, p);  // overlaps the logits' gathers
        // The round's logits: lane j keeps edge j's.
        float pre = 0.f;
        if constexpr (kLaneDots<VEC>) {
          pre = lane_dot<float, float, VEC>(d1, D2 + (int64_t)c * Ka, Ka);
        } else {
          for (int u0 = 0; u0 < n_here; u0 += kFwdBatch) {
            const float* drows[kFwdBatch];
            F y[kFwdBatch];
            float q[kFwdBatch];
            batch_rows(w, c, u0, n_here, D2, Ka, drows);
            gather(drows, ca.kk, y);
            edge_dots<float, float, VEC, SW>(w.lane, Ka, d1, x0, drows, y, q);
            sums(w, q);
#pragma unroll
            for (int u = 0; u < kFwdBatch; ++u)
              if (w.lane == u0 + u) pre = q[u];
          }
        }
        const float l = live ? act(pre, leaky, slope) : -CUDART_INF_F;
        const float m_new = fmaxf(m_run, w.max(l));
        const float sc = m_run == m_new ? 1.f : expf(m_run - m_new);
        const float z = live ? expf(fmaxf(l - m_new, kExpFloor)) : 0.f;
        m_run = m_new;
        zsum *= sc;
#pragma unroll
        for (int t = 0; t < VEC; ++t) acc[t] *= sc;
        for (int u0 = 0;;) {
          float zj[kFwdBatch];
#pragma unroll
          for (int u = 0; u < kFwdBatch; ++u)
            zj[u] = w.get(z, min(u0 + u, n_here - 1));
#pragma unroll
          for (int u = 0; u < kFwdBatch; ++u) {
            if (u0 + u < n_here) {  // walker-uniform
              zsum += zj[u];
#pragma unroll
              for (int t = 0; t < VEC; ++t)
                acc[t] = fmaf(zj[u], to_f32(p[u].v[t]), acc[t]);
            }
          }
          u0 += kFwdBatch;
          if (u0 >= n_here) break;
          batch_rows(w, c, u0, n_here, B + cl.kk, K, brows);
          gather(brows, 0, p);
        }
      }
      const bool first = slab == 0 && w.lane == 0;
      if (item < S) {
        if (cl.on) {
          F o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = acc[t];
          *reinterpret_cast<F*>(pacc + (int64_t)item * K + cl.kk) = o;
        }
        if (first) {
          pm[item] = m_run;
          pz[item] = zsum;
        }
      } else {
        const float d = fmaxf(zsum, kDenomEps);
        if (cl.on) {
          P o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[t] / d);
          *reinterpret_cast<P*>(out + (int64_t)it.row * K + cl.kk) = o;
        }
        if (first) {
          mx[it.row] = isfinite(m_run) ? m_run : 0.f;  // an empty row: 0
          den[it.row] = d;
        }
      }
    }
  }
}

template <typename T, int VEC, int SW>
__global__ void __launch_bounds__(kThreads)
dot_bwd_rows_kernel(int m, int S, int K, int Ka, int L, int leaky,
                    float slope, const int* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const int* __restrict__ seg_row,
                    const int* __restrict__ seg_start,
                    const float* __restrict__ D1, const float* __restrict__ D2,
                    const T* __restrict__ B, const float* __restrict__ g,
                    const float* __restrict__ mx, const float* __restrict__ den,
                    const float* __restrict__ srow,
                    float* __restrict__ grad_D1, float* __restrict__ part) {
  using F = Pack<float, VEC>;
  // One edge a batch on 1-column lanes: at (Ka, K) = (16, 3) it beat 2 and
  // 4 (PERF.md, section 6).
  constexpr int kB = VEC == 1 ? 1 : kRowsBatch;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  const int nslab = (Ka + SW * VEC - 1) / (SW * VEC);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + m;
       item += gridDim.x * kPerBlock) {
    Item it;
    if (!item_edges(item, S, L, indptr, seg_row, seg_start, it)) continue;
    const float* __restrict__ d1 = D1 + (int64_t)it.row * Ka;
    const float* __restrict__ g_row = g + (int64_t)it.row * K;
    const float mh = mx[it.row], dn = den[it.row], s = srow[it.row];
    const Col<VEC, SW> ca(0, Ka, w.lane), cb(0, K, w.lane);
    const F xa = load<float, VEC>(d1 + ca.kk);
    const F xb = load<float, VEC>(g_row + cb.kk);
    for (int slab = 0; slab < nslab; ++slab) {
      const Col<VEC, SW> cl(slab, Ka, w.lane);  // this walk's grad_D1 columns
      float acc[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
      for (int base = it.s; base < it.t; base += SW) {
        const int e = base + w.lane;
        const bool live = e < it.t;
        const int c = live ? __ldg(indices + e) : 0;
        const int n_here = min(SW, it.t - base);
        if constexpr (kLaneDots<VEC>) {
          float dp = 0.f;
          if (live) {  // this lane's edge
            const float pre =
                lane_dot<float, float, VEC>(d1, D2 + (int64_t)c * Ka, Ka);
            const float u = lane_dot<float, T, VEC>(g_row, B + (int64_t)c * K, K);
            dp = attention(pre, leaky, slope, mh, dn) * (u - s) *
                 dact(pre, leaky, slope);
          }
          for (int u0 = 0; u0 < n_here; u0 += kB) {
            const float* drows[kB];
            F y[kB];
            float dj[kB];
            batch_rows(w, c, u0, n_here, D2, Ka, drows);
            gather(drows, cl.kk, y);
#pragma unroll
            for (int u = 0; u < kB; ++u)
              dj[u] = w.get(dp, min(u0 + u, n_here - 1));
#pragma unroll
            for (int u = 0; u < kB; ++u)
              if (u0 + u < n_here)
#pragma unroll
                for (int t = 0; t < VEC; ++t)
                  acc[t] = fmaf(dj[u], y[u].v[t], acc[t]);
          }
        } else {
          for (int u0 = 0; u0 < n_here; u0 += kB) {
            const float* drows[kB];
            const T* brows[kB];
            F y[kB];
            Pack<T, VEC> yb[kB];
            float pre[kB], uu[kB];
            batch_rows(w, c, u0, n_here, D2, Ka, drows);
            batch_rows(w, c, u0, n_here, B, K, brows);
            gather(drows, ca.kk, y);
            gather(brows, cb.kk, yb);
            edge_dots<float, float, VEC, SW>(w.lane, Ka, d1, xa, drows, y, pre);
            edge_dots<float, T, VEC, SW>(w.lane, K, g_row, xb, brows, yb, uu);
            sums(w, pre);
            sums(w, uu);
            if (slab > 0) gather(drows, cl.kk, y);  // this walk's columns
#pragma unroll
            for (int u = 0; u < kB; ++u) {
              if (u0 + u < n_here) {  // walker-uniform
                const float dp = attention(pre[u], leaky, slope, mh, dn) *
                                 (uu[u] - s) * dact(pre[u], leaky, slope);
#pragma unroll
                for (int t = 0; t < VEC; ++t)
                  acc[t] = fmaf(dp, y[u].v[t], acc[t]);
              }
            }
          }
        }
      }
      if (cl.on) {
        F o;
#pragma unroll
        for (int t = 0; t < VEC; ++t) o.v[t] = acc[t];
        float* dst = item < S ? part + (int64_t)item * Ka
                              : grad_D1 + (int64_t)it.row * Ka;
        *reinterpret_cast<F*>(dst + cl.kk) = o;
      }
    }
  }
}

// One walk a column gives both grad_D2 (Ka wide) and grad_B (K wide); a
// walk covers slab `slab` of both.
template <typename T, int VEC, int SW>
__global__ void __launch_bounds__(kThreads)
dot_bwd_cols_kernel(int n, int S, int K, int Ka, int L, int leaky,
                    float slope, const int* __restrict__ colptr,
                    const int* __restrict__ rows,
                    const int* __restrict__ seg_row,
                    const int* __restrict__ seg_start,
                    const float* __restrict__ D1, const float* __restrict__ D2,
                    const T* __restrict__ B, const float* __restrict__ g,
                    const float* __restrict__ mx, const float* __restrict__ den,
                    const float* __restrict__ srow, T* __restrict__ grad_B,
                    float* __restrict__ grad_D2, float* __restrict__ part_B,
                    float* __restrict__ part_D) {
  using F = Pack<float, VEC>;
  using P = Pack<T, VEC>;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  const int width = max(K, Ka);
  const int nslab = (width + SW * VEC - 1) / (SW * VEC);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + n;
       item += gridDim.x * kPerBlock) {
    Item it;  // it.row is the column
    if (!item_edges(item, S, L, colptr, seg_row, seg_start, it)) continue;
    const float* __restrict__ d2 = D2 + (int64_t)it.row * Ka;
    const T* __restrict__ b_col = B + (int64_t)it.row * K;
    const Col<VEC, SW> ca(0, Ka, w.lane), cb(0, K, w.lane);
    const F xa = load<float, VEC>(d2 + ca.kk);
    const P xb = load<T, VEC>(b_col + cb.kk);
    for (int slab = 0; slab < nslab; ++slab) {
      const Col<VEC, SW> cd(slab, Ka, w.lane), cg(slab, K, w.lane);
      float accD[VEC], accB[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) accD[t] = accB[t] = 0.f;
      for (int base = it.s; base < it.t; base += SW) {
        const int e = base + w.lane;
        const bool live = e < it.t;
        const int r = live ? __ldg(rows + e) : 0;
        const int n_here = min(SW, it.t - base);
        if constexpr (kLaneDots<VEC>) {
          float al = 0.f, dp = 0.f;
          if (live) {  // this lane's edge
            const float pre = lane_dot<float, float, VEC>(
                D1 + (int64_t)r * Ka, d2, Ka);
            const float u = lane_dot<float, T, VEC>(g + (int64_t)r * K, b_col,
                                                    K);
            al = attention(pre, leaky, slope, __ldg(mx + r), __ldg(den + r));
            dp = al * (u - __ldg(srow + r)) * dact(pre, leaky, slope);
          }
          for (int u0 = 0; u0 < n_here; u0 += kColsBatch) {
            const float *drows[kColsBatch], *grows[kColsBatch];
            F yd[kColsBatch], yg[kColsBatch];
            float aj[kColsBatch], dj[kColsBatch];
            batch_rows(w, r, u0, n_here, D1, Ka, drows);
            batch_rows(w, r, u0, n_here, g, K, grows);
            gather(drows, cd.kk, yd);
            gather(grows, cg.kk, yg);
#pragma unroll
            for (int u = 0; u < kColsBatch; ++u) {
              aj[u] = w.get(al, min(u0 + u, n_here - 1));
              dj[u] = w.get(dp, min(u0 + u, n_here - 1));
            }
#pragma unroll
            for (int u = 0; u < kColsBatch; ++u) {
              if (u0 + u < n_here) {
#pragma unroll
                for (int t = 0; t < VEC; ++t) {
                  accD[t] = fmaf(dj[u], yd[u].v[t], accD[t]);
                  accB[t] = fmaf(aj[u], yg[u].v[t], accB[t]);
                }
              }
            }
          }
        } else {
          // Lane j loads the row-side tables of edge j, ahead of the gathers.
          const float mr_l = __ldg(mx + r), dr_l = __ldg(den + r),
                      sr_l = __ldg(srow + r);
          for (int u0 = 0; u0 < n_here; u0 += kColsBatch) {
            const float *drows[kColsBatch], *grows[kColsBatch];
            F yd[kColsBatch], yg[kColsBatch];
            float pre[kColsBatch], uu[kColsBatch], mr[kColsBatch],
                dr[kColsBatch], sr[kColsBatch];
            batch_rows(w, r, u0, n_here, D1, Ka, drows);
            batch_rows(w, r, u0, n_here, g, K, grows);
            gather(drows, ca.kk, yd);
            gather(grows, cb.kk, yg);
#pragma unroll
            for (int u = 0; u < kColsBatch; ++u) {
              const int j = min(u0 + u, n_here - 1);
              mr[u] = w.get(mr_l, j);
              dr[u] = w.get(dr_l, j);
              sr[u] = w.get(sr_l, j);
            }
            edge_dots<float, float, VEC, SW>(w.lane, Ka, d2, xa, drows, yd, pre);
            edge_dots<T, float, VEC, SW>(w.lane, K, b_col, xb, grows, yg, uu);
            sums(w, pre);
            sums(w, uu);
            if (slab > 0) {  // this walk's columns
              gather(drows, cd.kk, yd);
              gather(grows, cg.kk, yg);
            }
#pragma unroll
            for (int u = 0; u < kColsBatch; ++u) {
              if (u0 + u < n_here) {  // walker-uniform
                const float al = attention(pre[u], leaky, slope, mr[u], dr[u]);
                const float dp = al * (uu[u] - sr[u]) * dact(pre[u], leaky, slope);
#pragma unroll
                for (int t = 0; t < VEC; ++t) {
                  accD[t] = fmaf(dp, yd[u].v[t], accD[t]);
                  accB[t] = fmaf(al, yg[u].v[t], accB[t]);
                }
              }
            }
          }
        }
      }
      if (cg.on) {
        if (item < S) {
          F o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = accB[t];
          *reinterpret_cast<F*>(part_B + (int64_t)item * K + cg.kk) = o;
        } else {
          P o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(accB[t]);
          *reinterpret_cast<P*>(grad_B + (int64_t)it.row * K + cg.kk) = o;
        }
      }
      if (cd.on) {
        F o;
#pragma unroll
        for (int t = 0; t < VEC; ++t) o.v[t] = accD[t];
        float* dst = item < S ? part_D + (int64_t)item * Ka
                              : grad_D2 + (int64_t)it.row * Ka;
        *reinterpret_cast<F*>(dst + cd.kk) = o;
      }
    }
  }
}

// --- the multi-head walk ---------------------------------------------------
//
// D1 (m, Ka), D2 (n, Ka) and B (n, K) in H head blocks of dk = Ka / H and
// dv = K / H columns.  A walker is a whole warp (SW = 32) whose lanes hold
// VEC columns in each of NS slabs, so that one walk of an item's edges
// covers both widths (kernels/gat_fused.py::DOT_HEAD_WALKS: VEC divides dk
// and dv, and 32*VEC*NS >= max(K, Ka)).  For each batch of NB edges every
// lane gathers its columns of the edges' rows and takes its partial of each
// edge's dot over its columns of each slab; the walker then sums each head's
// partials (head_totals).  Which lanes hold which columns, and so how a dot
// is summed, follows G, the lanes of a head's group
// (kernels/gat_fused.py::dot_head_group, which bad_heads checks):
//   * head-major (G > 0 and H*G <= SW: the MAJOR kernels): head h owns lanes
//     [h*G, (h+1)*G), and lane l holds columns h*dk + (s*G + l%G)*VEC of
//     slab s on both sides (K = Ka), so every slab of a lane is of one head.
//     The lane adds its slabs' partials in slab order, and a butterfly over
//     the group, log2(G) shuffles, completes every head's dot at once.  G is
//     dk / VEC where that is a power of two (the UniMP cell's hidden layers'
//     heads of 32 at 2-column lanes: 16, one slab), else the least power of
//     two whose NS slabs cover a head (its output layer's heads of 47 at
//     1-column lanes: 16, three slabs of 16 lanes a head, 94 of 96 lane
//     slots; one head of several slabs: 32, the walker-wide sum);
//   * slab-major (the rest): lane l holds columns (s*SW + l)*VEC of slab s,
//     so its slabs may be of different heads.  With G > 0 (K = Ka, and each
//     head fills G = dk / VEC lanes of a slab, more heads than a slab holds)
//     a butterfly over the head's lanes of each slab; with G = 0 (K != Ka,
//     or groups that would not fit: three heads of 30 at three slabs) head
//     by head: for each head the lane's partials of the head's columns added
//     in slab order, then Sub::sum's butterfly over the walker.
// A column past the head's width (past K or Ka) loads column 0, adds 0 to
// the dot and is neither folded nor stored.  Every lane of a head holds its
// total, the same bits in each.  A lane then folds its slabs with the
// weights of their heads, taken once a head slot (one a lane head-major, one
// a slab slab-major): the forward with an online softmax over the batches
// (the batch's maximum; the sums rescaled by exp(m_old - m_new) when it
// grows), as the single-head forward over its rounds.  The scale multiplies
// each dot (pre = scale * dot, one rounded product, __fmul_rn: no compiler
// fuses it into the subtraction of the row's maximum in one kernel and not
// in another), and the edge factor m~ (1 / keep_prob, or 0, from the (nnz,
// H) byte mask in CSR edge order; 1 without a mask) multiplies each weight
// where it is used: zd = z * m~ in the forward's sum (den keeps the
// undropped z), u * m~ in dpre, alpha * m~ for grad_B.  Each round of SW
// edges, lane j loads edge j's per-head values
// (the mask's factors; over the CSC also its row's mx, den and s_row) into a
// per-walker [table][head][edge] table in shared memory (stride SW + 1), so
// that a batch reads them without a dependent load.  The CSC walk reads the
// mask through perm (the CSR position of each CSC edge): so the UniMP cell's
// CSC walks took 3.5% and 2.8% less than over a copy of the mask in CSC
// order, the copy's own 3.5 ms aside (PERF.md, section 6).  The three
// kernels take G from one rule and each dot with the same lanes in the same
// order (fmaf is symmetric in its factors), so the backward's pre meets the
// forward's mx and den bit for bit.

// Edges whose rows a multi-head walker gathers before it folds any: 4, or 2
// in a walker holding several slabs, whose registers would otherwise cost
// it blocks an SM (the output layer's forward 15% faster, its backward walks
// 27% and 16%: PERF.md, section 6).
template <int NS>
constexpr int kHeadsBatchOf = NS == 1 ? 4 : 2;

// Blocks an SM the CSC walk's registers must allow: four (at most 64
// registers) took 5% less than three at the head-major walks of the UniMP
// cell's heads of 32 and 3-6% less at its heads of 47, with the same bits
// (PERF.md, section 6).
constexpr int kHeadsColsMinBlocks = 4;

// The lane's columns in each of a walker's NS slabs, on the D side (Ka wide,
// heads of dk) and the B side (K wide, heads of dv): the first column (0
// past the width, where the loads are not used) and its head (-1 past the
// width); and the D and B heads of each of its NH head slots (-1: none), the
// heads whose weights it folds: one slot in all head-major (the lane's
// group's head), one a slab slab-major.
template <int VEC, int SW, int NS, bool MAJOR>
struct HeadCols {
  static constexpr int NH = MAJOR ? 1 : NS;
  int kd[NS], kb[NS], hd[NS], hb[NS], jd[NH], jb[NH];
  __device__ HeadCols(int lane, int Ka, int K, int H, int G) {
    const int dk = Ka / H;
    if constexpr (MAJOR) {
      const int h = lane / G, c0 = lane % G;
      jd[0] = jb[0] = h < H ? h : -1;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int c = (s * G + c0) * VEC;
        const bool on = h < H && c < dk;
        hd[s] = hb[s] = on ? h : -1;
        kd[s] = kb[s] = on ? h * dk + c : 0;
      }
    } else {
      const int dv = K / H;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int k = (s * SW + lane) * VEC;
        hd[s] = jd[s] = k < Ka ? k / dk : -1;
        hb[s] = jb[s] = k < K ? k / dv : -1;
        kd[s] = k < Ka ? k : 0;
        kb[s] = k < K ? k : 0;
      }
    }
  }
  // Whether slab s takes the weights of slot j.
  __device__ static constexpr bool of(int s, int j) {
    return MAJOR ? j == 0 : s == j;
  }
};

// p[u][s]: the lane's partial of x[s] . y[s][u] over its VEC columns of slab
// s, in column order (0 where the slab is past the width).
template <typename TA, typename TB, int VEC, int NS, int N>
__device__ __forceinline__ void slab_dots(const Pack<TA, VEC> (&x)[NS],
                                          const Pack<TB, VEC> (&y)[NS][N],
                                          const int (&h)[NS],
                                          float (&p)[N][NS]) {
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float a = 0.f;
      if (h[s] >= 0)
#pragma unroll
        for (int t = 0; t < VEC; ++t)
          a = fmaf(to_f32(x[s].v[t]), to_f32(y[s][u].v[t]), a);
      p[u][s] = a;
    }
}

// q[u][j]: the dot of edge u for the head of slot j (dst: the slabs' heads
// on the other side where K != Ka), from the partials p whose columns are of
// head src[s].  Head-major: the lane's partials added in slab order, then a
// butterfly over its group of G lanes.  Slab-major with G > 0 (src = dst):
// each slab's partials summed over the head's G lanes by a butterfly; with
// G = 0, for each head the lane's partials of that head added in slab order,
// then summed over the walker.  Walker-uniform: all SW lanes take part.
template <bool MAJOR, int SW, int NS, int N, int NH>
__device__ __forceinline__ void head_totals(const Sub<SW>& w, int G, int H,
                                            const int (&src)[NS],
                                            const int (&dst)[NS],
                                            const float (&p)[N][NS],
                                            float (&q)[N][NH]) {
  if constexpr (MAJOR) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      float a = p[u][0];
#pragma unroll
      for (int s = 1; s < NS; ++s) a += p[u][s];
      q[u][0] = a;
    }
    for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < N; ++u)
        q[u][0] += __shfl_xor_sync(w.mask, q[u][0], o, SW);
  } else {
    if (G > 0) {
#pragma unroll
      for (int u = 0; u < N; ++u)
#pragma unroll
        for (int s = 0; s < NS; ++s) q[u][s] = p[u][s];
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < N; ++u)
#pragma unroll
          for (int s = 0; s < NS; ++s)
            q[u][s] += __shfl_xor_sync(w.mask, q[u][s], o, SW);
      return;
    }
#pragma unroll
    for (int u = 0; u < N; ++u)
#pragma unroll
      for (int s = 0; s < NS; ++s) q[u][s] = 0.f;
    for (int h = 0; h < H; ++h) {
      float t[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        float a = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s)
          if (src[s] == h) a += p[u][s];
        t[u] = a;
      }
      sums(w, t);
#pragma unroll
      for (int u = 0; u < N; ++u)
#pragma unroll
        for (int s = 0; s < NS; ++s)
          if (dst[s] == h) q[u][s] = t[u];
    }
  }
}

// The edge factor m~ of (mask row e, head h): 1 / keep_prob where the edge
// is kept, 0 where it is dropped.
__device__ __forceinline__ float edge_factor(const uint8_t* __restrict__ keep,
                                             int64_t e, int H, int h,
                                             float inv_keep) {
  return __ldg(keep + e * H + h) ? inv_keep : 0.f;
}

// Lane j's edge of a round into the walker's shared [table][head][edge]
// tables (stride SW + 1): the mask's factor of each head (table 0, where
// there is a mask) and, with ROW_TABLES, its row's mx, den and s_row of each
// head (tables 1-3).  Synchronises the walker before (the last round's reads)
// and after.
template <bool ROW_TABLES, int SW>
__device__ __forceinline__ void stage_edges(
    const Sub<SW>& w, float* __restrict__ st, int H, bool live, int64_t ek,
    int64_t r, const uint8_t* __restrict__ keep, float inv_keep,
    const float* __restrict__ mx, const float* __restrict__ den,
    const float* __restrict__ srow) {
  constexpr int kStride = SW + 1;
  w.sync();
  if (live) {
#pragma unroll 4
    for (int h = 0; h < H; ++h) {
      float* at = st + h * kStride + w.lane;
      if (keep != nullptr) at[0] = edge_factor(keep, ek, H, h, inv_keep);
      if constexpr (ROW_TABLES) {
        at[1 * H * kStride] = __ldg(mx + r * H + h);
        at[2 * H * kStride] = __ldg(den + r * H + h);
        at[3 * H * kStride] = __ldg(srow + r * H + h);
      }
    }
  }
  w.sync();
}

// scale * dpre: the gradient of an (edge, head)'s dot, from its pre, its
// row's tables, u = <g[r], B[c]> of the head and the edge factor.
__device__ __forceinline__ float dot_grad(float pre, float u, float f,
                                          float mx, float den, float s,
                                          int leaky, float slope,
                                          float scale) {
  return scale * (attention(pre, leaky, slope, mx, den) * (f * u - s) *
                  dact(pre, leaky, slope));
}

template <typename T, int VEC, int SW, int NS, bool MAJOR>
__global__ void __launch_bounds__(kThreads)
dot_heads_fwd_kernel(int m, int S, int K, int Ka, int H, int G, int L,
                     int leaky, float slope, float scale, float inv_keep,
                     const int* __restrict__ indptr,
                     const int* __restrict__ indices,
                     const int* __restrict__ seg_row,
                     const int* __restrict__ seg_start,
                     const float* __restrict__ D1,
                     const float* __restrict__ D2, const T* __restrict__ B,
                     const uint8_t* __restrict__ keep, T* __restrict__ out,
                     float* __restrict__ mx, float* __restrict__ den,
                     float* __restrict__ pm, float* __restrict__ pz,
                     float* __restrict__ pacc) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  using HC = HeadCols<VEC, SW, NS, MAJOR>;
  constexpr int NH = HC::NH;
  constexpr int NB = kHeadsBatchOf<NS>;
  constexpr int kStride = SW + 1;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  extern __shared__ float smem[];
  float* st = smem + (threadIdx.x / SW) * H * kStride;  // [head][edge]
  const int dv = K / H;
  const HC hc(w.lane, Ka, K, H, G);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + m;
       item += gridDim.x * kPerBlock) {
    Item it;
    if (!item_edges(item, S, L, indptr, seg_row, seg_start, it)) continue;
    F x[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      x[s] = load<float, VEC>(D1 + (int64_t)it.row * Ka + hc.kd[s]);
    float m_run[NH], zsum[NH], acc[NS][VEC];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      m_run[j] = -CUDART_INF_F;
      zsum[j] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[s][t] = 0.f;
    for (int base = it.s; base < it.t; base += SW) {
      // Walker-uniform down to the shuffles: all SW lanes take part.
      const int e = base + w.lane;
      const bool live = e < it.t;
      const int c = live ? __ldg(indices + e) : 0;
      const int n_here = min(SW, it.t - base);
      if (keep != nullptr)
        stage_edges<false>(w, st, H, live, e, 0, keep, inv_keep, nullptr,
                           nullptr, nullptr);
      for (int u0 = 0; u0 < n_here; u0 += NB) {
        const float* drows[NB];
        const T* brows[NB];
        batch_rows(w, c, u0, n_here, D2, Ka, drows);
        batch_rows(w, c, u0, n_here, B, K, brows);
        F yd[NS][NB];
        P yb[NS][NB];
#pragma unroll
        for (int u = 0; u < NB; ++u)
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            yd[s][u] = load<float, VEC>(drows[u] + hc.kd[s]);
            yb[s][u] = load<T, VEC>(brows[u] + hc.kb[s]);
          }
        float p[NB][NS], l[NB][NH];
        slab_dots(x, yd, hc.hd, p);
        head_totals<MAJOR>(w, G, H, hc.hd, hc.hb, p, l);
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int h = hc.jb[j];
          if (h < 0) continue;  // no shuffle below
          float mb = m_run[j];
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            l[u][j] = act(__fmul_rn(l[u][j], scale), leaky, slope);
            if (u0 + u < n_here) mb = fmaxf(mb, l[u][j]);
          }
          const float sc = m_run[j] == mb ? 1.f : expf(m_run[j] - mb);
          m_run[j] = mb;
          zsum[j] *= sc;
#pragma unroll
          for (int s = 0; s < NS; ++s)
            if (HC::of(s, j))
#pragma unroll
              for (int t = 0; t < VEC; ++t) acc[s][t] *= sc;
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            if (u0 + u < n_here) {
              const float z = expf(fmaxf(l[u][j] - mb, kExpFloor));
              zsum[j] += z;
              const float zd =
                  keep == nullptr ? z : z * st[h * kStride + u0 + u];
#pragma unroll
              for (int s = 0; s < NS; ++s)
                if (HC::of(s, j) && hc.hb[s] >= 0)
#pragma unroll
                  for (int t = 0; t < VEC; ++t)
                    acc[s][t] = fmaf(zd, to_f32(yb[s][u].v[t]), acc[s][t]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int h = hc.hb[s], k = hc.kb[s], j = MAJOR ? 0 : s;
      if (h < 0) continue;
      const bool first = k % dv == 0;  // the head's first column
      if (item < S) {
        F o;
#pragma unroll
        for (int t = 0; t < VEC; ++t) o.v[t] = acc[s][t];
        *reinterpret_cast<F*>(pacc + (int64_t)item * K + k) = o;
        if (first) {
          pm[(int64_t)item * H + h] = m_run[j];
          pz[(int64_t)item * H + h] = zsum[j];
        }
      } else {
        const float d = fmaxf(zsum[j], kDenomEps);
        P o;
#pragma unroll
        for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[s][t] / d);
        *reinterpret_cast<P*>(out + (int64_t)it.row * K + k) = o;
        if (first) {
          const int64_t at = (int64_t)it.row * H + h;
          mx[at] = isfinite(m_run[j]) ? m_run[j] : 0.f;  // an empty row: 0
          den[at] = d;
        }
      }
    }
  }
}

template <typename T, int VEC, int SW, int NS, bool MAJOR>
__global__ void __launch_bounds__(kThreads)
dot_heads_bwd_rows_kernel(int m, int S, int K, int Ka, int H, int G, int L,
                          int leaky, float slope, float scale, float inv_keep,
                          const int* __restrict__ indptr,
                          const int* __restrict__ indices,
                          const int* __restrict__ seg_row,
                          const int* __restrict__ seg_start,
                          const float* __restrict__ D1,
                          const float* __restrict__ D2,
                          const T* __restrict__ B, const float* __restrict__ g,
                          const uint8_t* __restrict__ keep,
                          const float* __restrict__ mx,
                          const float* __restrict__ den,
                          const float* __restrict__ srow,
                          float* __restrict__ grad_D1,
                          float* __restrict__ part) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  using HC = HeadCols<VEC, SW, NS, MAJOR>;
  constexpr int NH = HC::NH;
  constexpr int NB = kHeadsBatchOf<NS>;
  constexpr int kStride = SW + 1;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  extern __shared__ float smem[];
  float* st = smem + (threadIdx.x / SW) * H * kStride;  // [head][edge]
  const HC hc(w.lane, Ka, K, H, G);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + m;
       item += gridDim.x * kPerBlock) {
    Item it;
    if (!item_edges(item, S, L, indptr, seg_row, seg_start, it)) continue;
    const int64_t r = it.row;
    F xd[NS], xg[NS];
    float mh[NH], dn[NH], sr[NH];  // the row's tables at slot j's D head
    float acc[NS][VEC];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      xd[s] = load<float, VEC>(D1 + r * Ka + hc.kd[s]);
      xg[s] = load<float, VEC>(g + r * K + hc.kb[s]);
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[s][t] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int64_t at = r * H + max(hc.jd[j], 0);
      mh[j] = mx[at];
      dn[j] = den[at];
      sr[j] = srow[at];
    }
    for (int base = it.s; base < it.t; base += SW) {
      const int e = base + w.lane;
      const bool live = e < it.t;
      const int c = live ? __ldg(indices + e) : 0;
      const int n_here = min(SW, it.t - base);
      if (keep != nullptr)
        stage_edges<false>(w, st, H, live, e, 0, keep, inv_keep, nullptr,
                           nullptr, nullptr);
      for (int u0 = 0; u0 < n_here; u0 += NB) {
        const float* drows[NB];
        const T* brows[NB];
        batch_rows(w, c, u0, n_here, D2, Ka, drows);
        batch_rows(w, c, u0, n_here, B, K, brows);
        F yd[NS][NB];
        P yb[NS][NB];
#pragma unroll
        for (int u = 0; u < NB; ++u)
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            yd[s][u] = load<float, VEC>(drows[u] + hc.kd[s]);
            yb[s][u] = load<T, VEC>(brows[u] + hc.kb[s]);
          }
        float pd[NB][NS], pb[NB][NS], qd[NB][NH], qb[NB][NH];
        slab_dots(xd, yd, hc.hd, pd);
        slab_dots(xg, yb, hc.hb, pb);
        head_totals<MAJOR>(w, G, H, hc.hd, hc.hd, pd, qd);
        head_totals<MAJOR>(w, G, H, hc.hb, hc.hd, pb, qb);
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          if (u0 + u < n_here) {  // walker-uniform
#pragma unroll
            for (int j = 0; j < NH; ++j) {
              const int h = hc.jd[j];
              if (h < 0) continue;
              const float f =
                  keep == nullptr ? 1.f : st[h * kStride + u0 + u];
              const float dd =
                  dot_grad(__fmul_rn(qd[u][j], scale), qb[u][j], f, mh[j],
                           dn[j], sr[j], leaky, slope, scale);
#pragma unroll
              for (int s = 0; s < NS; ++s)
                if (HC::of(s, j) && hc.hd[s] >= 0)
#pragma unroll
                  for (int t = 0; t < VEC; ++t)
                    acc[s][t] = fmaf(dd, yd[s][u].v[t], acc[s][t]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (hc.hd[s] < 0) continue;
      F o;
#pragma unroll
      for (int t = 0; t < VEC; ++t) o.v[t] = acc[s][t];
      float* dst = item < S ? part + (int64_t)item * Ka : grad_D1 + r * Ka;
      *reinterpret_cast<F*>(dst + hc.kd[s]) = o;
    }
  }
}

// One walk a column gives grad_D2 (Ka wide) and grad_B (K wide).
template <typename T, int VEC, int SW, int NS, bool MAJOR>
__global__ void __launch_bounds__(kThreads, kHeadsColsMinBlocks)
dot_heads_bwd_cols_kernel(int n, int S, int K, int Ka, int H, int G, int L,
                          int leaky, float slope, float scale, float inv_keep,
                          const int* __restrict__ colptr,
                          const int* __restrict__ rows,
                          const int* __restrict__ seg_row,
                          const int* __restrict__ seg_start,
                          const float* __restrict__ D1,
                          const float* __restrict__ D2,
                          const T* __restrict__ B, const float* __restrict__ g,
                          const uint8_t* __restrict__ keep,
                          const int* __restrict__ perm,
                          const float* __restrict__ mx,
                          const float* __restrict__ den,
                          const float* __restrict__ srow,
                          T* __restrict__ grad_B, float* __restrict__ grad_D2,
                          float* __restrict__ part_B,
                          float* __restrict__ part_D) {
  using P = Pack<T, VEC>;
  using F = Pack<float, VEC>;
  using HC = HeadCols<VEC, SW, NS, MAJOR>;
  constexpr int NH = HC::NH;
  constexpr int NB = kHeadsBatchOf<NS>;
  constexpr int kStride = SW + 1;
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  extern __shared__ float smem[];
  // [table][head][edge]: the edge factor, and the edge's row's mx, den and
  // s_row.
  float* st = smem + (threadIdx.x / SW) * 4 * H * kStride;
  const int tab = H * kStride;
  const HC hc(w.lane, Ka, K, H, G);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + n;
       item += gridDim.x * kPerBlock) {
    Item it;  // it.row is the column
    if (!item_edges(item, S, L, colptr, seg_row, seg_start, it)) continue;
    const int64_t c = it.row;
    F xd[NS];
    P xb[NS];
    float accD[NS][VEC], accB[NS][VEC];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      xd[s] = load<float, VEC>(D2 + c * Ka + hc.kd[s]);
      xb[s] = load<T, VEC>(B + c * K + hc.kb[s]);
#pragma unroll
      for (int t = 0; t < VEC; ++t) accD[s][t] = accB[s][t] = 0.f;
    }
    for (int base = it.s; base < it.t; base += SW) {
      const int e = base + w.lane;
      const bool live = e < it.t;
      const int r = live ? __ldg(rows + e) : 0;
      const int n_here = min(SW, it.t - base);
      // The edge's row of the mask: its CSR position.
      const int64_t ek = live && keep != nullptr ? __ldg(perm + e) : e;
      stage_edges<true>(w, st, H, live, ek, r, keep, inv_keep, mx, den, srow);
      for (int u0 = 0; u0 < n_here; u0 += NB) {
        const float *drows[NB], *grows[NB];
        batch_rows(w, r, u0, n_here, D1, Ka, drows);
        batch_rows(w, r, u0, n_here, g, K, grows);
        F yd[NS][NB], yg[NS][NB];
#pragma unroll
        for (int u = 0; u < NB; ++u)
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            yd[s][u] = load<float, VEC>(drows[u] + hc.kd[s]);
            yg[s][u] = load<float, VEC>(grows[u] + hc.kb[s]);
          }
        float pd[NB][NS], pb[NB][NS], qd[NB][NH], qb[NB][NH], qa[NB][NH];
        slab_dots(xd, yd, hc.hd, pd);
        slab_dots(xb, yg, hc.hb, pb);
        head_totals<MAJOR>(w, G, H, hc.hd, hc.hd, pd, qd);
        head_totals<MAJOR>(w, G, H, hc.hb, hc.hd, pb, qb);
        // The dot of slot j's B head, for grad_B's weight: qd where the
        // heads of the two sides coincide (K = Ka, always head-major).
        if (MAJOR || K == Ka) {
#pragma unroll
          for (int u = 0; u < NB; ++u)
#pragma unroll
            for (int j = 0; j < NH; ++j) qa[u][j] = qd[u][j];
        } else {
          head_totals<MAJOR>(w, 0, H, hc.hd, hc.hb, pd, qa);
        }
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          if (u0 + u < n_here) {  // walker-uniform
            const int i = u0 + u;
#pragma unroll
            for (int j = 0; j < NH; ++j) {
              const int hD = hc.jd[j], hB = hc.jb[j];
              if (hD >= 0) {
                const float* at = st + hD * kStride + i;
                const float dd = dot_grad(
                    __fmul_rn(qd[u][j], scale), qb[u][j],
                    keep == nullptr ? 1.f : at[0],
                    at[tab], at[2 * tab], at[3 * tab], leaky, slope, scale);
#pragma unroll
                for (int s = 0; s < NS; ++s)
                  if (HC::of(s, j) && hc.hd[s] >= 0)
#pragma unroll
                    for (int t = 0; t < VEC; ++t)
                      accD[s][t] = fmaf(dd, yd[s][u].v[t], accD[s][t]);
              }
              if (hB >= 0) {
                const float* at = st + hB * kStride + i;
                float a = attention(__fmul_rn(qa[u][j], scale), leaky, slope,
                                    at[tab], at[2 * tab]);
                if (keep != nullptr) a *= at[0];
#pragma unroll
                for (int s = 0; s < NS; ++s)
                  if (HC::of(s, j) && hc.hb[s] >= 0)
#pragma unroll
                    for (int t = 0; t < VEC; ++t)
                      accB[s][t] = fmaf(a, yg[s][u].v[t], accB[s][t]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (hc.hb[s] >= 0) {
        if (item < S) {
          F o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = accB[s][t];
          *reinterpret_cast<F*>(part_B + (int64_t)item * K + hc.kb[s]) = o;
        } else {
          P o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(accB[s][t]);
          *reinterpret_cast<P*>(grad_B + c * K + hc.kb[s]) = o;
        }
      }
      if (hc.hd[s] >= 0) {
        F o;
#pragma unroll
        for (int t = 0; t < VEC; ++t) o.v[t] = accD[s][t];
        float* dst = item < S ? part_D + (int64_t)item * Ka : grad_D2 + c * Ka;
        *reinterpret_cast<F*>(dst + hc.kd[s]) = o;
      }
    }
  }
}

// --- launches --------------------------------------------------------------

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

bool bad_args(int K, int Ka, int vec, const Split& sp) {
  return K < 1 || Ka < 1 || K % vec != 0 || Ka % vec != 0 ||
         gespmm::bad_split(sp);
}

// Every table and buffer aligned to VEC of its element type.
template <typename T, int VEC>
bool aligned_all(std::initializer_list<const void*> f32,
                 std::initializer_list<const void*> typed) {
  for (const void* p : f32)
    if (!aligned(p, VEC * sizeof(float))) return false;
  for (const void* p : typed)
    if (!aligned(p, VEC * sizeof(T))) return false;
  return true;
}

template <typename T>
cudaError_t forward(int m, int K, int Ka, int vec, int sw, int leaky,
                    float slope, const Split& sp, const int* indptr,
                    const int* indices, const float* D1, const float* D2,
                    const T* B, T* out, float* mx, float* den, float* pm,
                    float* pz, float* pacc, cudaStream_t stream) {
  if (bad_args(K, Ka, vec, sp)) return cudaErrorInvalidValue;
  return dispatch(vec, sw, [&](auto V, auto W) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    if (!aligned_all<T, VEC>({D1, D2, pacc}, {B, out}))
      return cudaErrorInvalidValue;
    dot_fwd_kernel<T, VEC, SW><<<item_grid(sp.S + m, SW), kThreads, 0, stream>>>(
        m, sp.S, K, Ka, sp.L, leaky, slope, indptr, indices, sp.seg_row,
        sp.seg_start, D1, D2, B, out, mx, den, pm, pz, pacc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || sp.J == 0) return err;
    return gespmm::launch_softmax_carry<T, VEC>(sp.J, K, 1, 1, sp.long_rows,
                                               sp.seg_ptr, pm, pz, pacc, out,
                                               mx, den, stream);
  });
}

template <typename T>
cudaError_t backward_rows(int m, int K, int Ka, int vec, int sw, int leaky,
                          float slope, const Split& sp, const int* indptr,
                          const int* indices, const float* D1, const float* D2,
                          const T* B, const float* g, const float* mx,
                          const float* den, const float* srow, float* grad_D1,
                          float* part, cudaStream_t stream) {
  if (bad_args(K, Ka, vec, sp)) return cudaErrorInvalidValue;
  return dispatch(vec, sw, [&](auto V, auto W) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    if (!aligned_all<T, VEC>({D1, D2, g, grad_D1, part}, {B}))
      return cudaErrorInvalidValue;
    dot_bwd_rows_kernel<T, VEC, SW>
        <<<item_grid(sp.S + m, SW), kThreads, 0, stream>>>(
            m, sp.S, K, Ka, sp.L, leaky, slope, indptr, indices, sp.seg_row,
            sp.seg_start, D1, D2, B, g, mx, den, srow, grad_D1, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || sp.J == 0) return err;
    return gespmm::launch_carry<float, VEC>(sp.J, Ka, sp.long_rows,
                                            sp.seg_ptr, part, grad_D1, stream);
  });
}

template <typename T>
cudaError_t backward_cols(int n, int K, int Ka, int vec, int sw, int leaky,
                          float slope, const Split& sp, const int* colptr,
                          const int* rows, const float* D1, const float* D2,
                          const T* B, const float* g, const float* mx,
                          const float* den, const float* srow, T* grad_B,
                          float* grad_D2, float* part_B, float* part_D,
                          cudaStream_t stream) {
  if (bad_args(K, Ka, vec, sp)) return cudaErrorInvalidValue;
  return dispatch(vec, sw, [&](auto V, auto W) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    if (!aligned_all<T, VEC>({D1, D2, g, grad_D2, part_B, part_D},
                             {B, grad_B}))
      return cudaErrorInvalidValue;
    dot_bwd_cols_kernel<T, VEC, SW>
        <<<item_grid(sp.S + n, SW), kThreads, 0, stream>>>(
            n, sp.S, K, Ka, sp.L, leaky, slope, colptr, rows, sp.seg_row,
            sp.seg_start, D1, D2, B, g, mx, den, srow, grad_B, grad_D2,
            part_B, part_D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || sp.J == 0) return err;
    err = gespmm::launch_carry<T, VEC>(sp.J, K, sp.long_rows, sp.seg_ptr,
                                       part_B, grad_B, stream);
    if (err != cudaSuccess) return err;
    return gespmm::launch_carry<float, VEC>(sp.J, Ka, sp.long_rows,
                                            sp.seg_ptr, part_D, grad_D2,
                                            stream);
  });
}

// The instantiated multi-head walkers (kernels/gat_fused.py::DOT_HEAD_WALKS):
// whole warps of 2-column lanes holding one slab (K, Ka <= 64 with even
// heads: the UniMP cell's hidden layers, heads of 32) and of 1-column lanes
// holding three (K, Ka <= 96: its output layer, heads of 47), each
// head-major (fn's last argument 1) or slab-major (0).
template <typename Fn>
cudaError_t dispatch_heads(int vec, int sw, int ns, bool major, Fn&& fn) {
  using gespmm::Int;
  if (vec == 2 && sw == 32 && ns == 1)
    return major ? fn(Int<2>(), Int<32>(), Int<1>(), Int<1>())
                 : fn(Int<2>(), Int<32>(), Int<1>(), Int<0>());
  if (vec == 1 && sw == 32 && ns == 3)
    return major ? fn(Int<1>(), Int<32>(), Int<3>(), Int<1>())
                 : fn(Int<1>(), Int<32>(), Int<3>(), Int<0>());
  return cudaErrorInvalidValue;
}

// Whether G lanes a head make the walk head-major (the multi-head walk's
// comment).
bool head_major(int G, int H, int sw) { return G > 0 && H * G <= sw; }

// A G (kernels/gat_fused.py::dot_head_group) that the walker cannot take: a
// group must be a power of two of at most SW lanes, with K = Ka, and hold a
// whole head, in its NS slabs head-major and in one slab slab-major.
bool bad_group(int K, int Ka, int H, int vec, int sw, int ns, int G) {
  if (G == 0) return false;
  if (G < 0 || G > sw || (G & (G - 1)) != 0 || K != Ka) return true;
  const int dk = Ka / H;
  return head_major(G, H, sw) ? G * vec * ns < dk : G * vec != dk;
}

bool bad_heads(int K, int Ka, int H, int vec, int sw, int ns, int G,
               const Split& sp) {
  return H < 1 || K < 1 || Ka < 1 || K % H != 0 || Ka % H != 0 ||
         (K / H) % vec != 0 || (Ka / H) % vec != 0 ||
         (K > Ka ? K : Ka) > sw * vec * ns ||
         bad_group(K, Ka, H, vec, sw, ns, G) || gespmm::bad_split(sp);
}

// Dynamic shared memory of `tables` [head][edge] tables a walker, opting in
// above the default 48 KiB.
template <typename Kernel>
cudaError_t head_tables(Kernel kernel, int sw, int tables, int H,
                        size_t* bytes) {
  *bytes = (size_t)(kThreads / sw) * tables * H * (sw + 1) * sizeof(float);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

// The multi-head launches' arguments besides the split and the tables.
struct Heads {
  int H, G, leaky;
  float slope, scale, inv_keep;
};

template <typename T>
cudaError_t forward_heads(int m, int K, int Ka, int vec, int sw, int ns,
                          const Heads& hp, const Split& sp, const int* indptr,
                          const int* indices, const float* D1, const float* D2,
                          const T* B, const uint8_t* keep, T* out, float* mx,
                          float* den, float* pm, float* pz, float* pacc,
                          cudaStream_t stream) {
  if (bad_heads(K, Ka, hp.H, vec, sw, ns, hp.G, sp))
    return cudaErrorInvalidValue;
  return dispatch_heads(vec, sw, ns, head_major(hp.G, hp.H, sw),
                        [&](auto V, auto W, auto N, auto M) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    constexpr int NS = decltype(N)::value;
    constexpr bool MAJOR = decltype(M)::value == 1;
    if (!aligned_all<T, VEC>({D1, D2, pacc}, {B, out}))
      return cudaErrorInvalidValue;
    auto kernel = dot_heads_fwd_kernel<T, VEC, SW, NS, MAJOR>;
    size_t smem;
    cudaError_t err = head_tables(kernel, SW, 1, hp.H, &smem);
    if (err != cudaSuccess) return err;
    kernel<<<item_grid(sp.S + m, SW), kThreads, smem, stream>>>(
        m, sp.S, K, Ka, hp.H, hp.G, sp.L, hp.leaky, hp.slope, hp.scale,
        hp.inv_keep, indptr, indices, sp.seg_row, sp.seg_start, D1, D2, B,
        keep, out, mx, den, pm, pz, pacc);
    err = cudaGetLastError();
    if (err != cudaSuccess || sp.J == 0) return err;
    return gespmm::launch_softmax_carry<T, VEC>(sp.J, K, hp.H, 1,
                                               sp.long_rows, sp.seg_ptr, pm,
                                               pz, pacc, out, mx, den, stream);
  });
}

template <typename T>
cudaError_t backward_rows_heads(int m, int K, int Ka, int vec, int sw, int ns,
                                const Heads& hp, const Split& sp,
                                const int* indptr, const int* indices,
                                const float* D1, const float* D2, const T* B,
                                const float* g, const uint8_t* keep,
                                const float* mx, const float* den,
                                const float* srow, float* grad_D1, float* part,
                                cudaStream_t stream) {
  if (bad_heads(K, Ka, hp.H, vec, sw, ns, hp.G, sp))
    return cudaErrorInvalidValue;
  return dispatch_heads(vec, sw, ns, head_major(hp.G, hp.H, sw),
                        [&](auto V, auto W, auto N, auto M) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    constexpr int NS = decltype(N)::value;
    constexpr bool MAJOR = decltype(M)::value == 1;
    if (!aligned_all<T, VEC>({D1, D2, g, grad_D1, part}, {B}))
      return cudaErrorInvalidValue;
    auto kernel = dot_heads_bwd_rows_kernel<T, VEC, SW, NS, MAJOR>;
    size_t smem;
    cudaError_t err = head_tables(kernel, SW, 1, hp.H, &smem);
    if (err != cudaSuccess) return err;
    kernel<<<item_grid(sp.S + m, SW), kThreads, smem, stream>>>(
        m, sp.S, K, Ka, hp.H, hp.G, sp.L, hp.leaky, hp.slope, hp.scale,
        hp.inv_keep, indptr, indices, sp.seg_row, sp.seg_start, D1, D2, B, g,
        keep, mx, den, srow, grad_D1, part);
    err = cudaGetLastError();
    if (err != cudaSuccess || sp.J == 0) return err;
    return gespmm::launch_carry<float, VEC>(sp.J, Ka, sp.long_rows,
                                            sp.seg_ptr, part, grad_D1, stream);
  });
}

template <typename T>
cudaError_t backward_cols_heads(int n, int K, int Ka, int vec, int sw, int ns,
                                const Heads& hp, const Split& sp,
                                const int* colptr, const int* rows,
                                const float* D1, const float* D2, const T* B,
                                const float* g, const uint8_t* keep,
                                const int* perm, const float* mx,
                                const float* den, const float* srow, T* grad_B,
                                float* grad_D2, float* part_B, float* part_D,
                                cudaStream_t stream) {
  if (bad_heads(K, Ka, hp.H, vec, sw, ns, hp.G, sp))
    return cudaErrorInvalidValue;
  return dispatch_heads(vec, sw, ns, head_major(hp.G, hp.H, sw),
                        [&](auto V, auto W, auto N, auto M) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    constexpr int NS = decltype(N)::value;
    constexpr bool MAJOR = decltype(M)::value == 1;
    if (!aligned_all<T, VEC>({D1, D2, g, grad_D2, part_B, part_D},
                             {B, grad_B}))
      return cudaErrorInvalidValue;
    auto kernel = dot_heads_bwd_cols_kernel<T, VEC, SW, NS, MAJOR>;
    size_t smem;
    cudaError_t err = head_tables(kernel, SW, 4, hp.H, &smem);
    if (err != cudaSuccess) return err;
    kernel<<<item_grid(sp.S + n, SW), kThreads, smem, stream>>>(
        n, sp.S, K, Ka, hp.H, hp.G, sp.L, hp.leaky, hp.slope, hp.scale,
        hp.inv_keep, colptr, rows, sp.seg_row, sp.seg_start, D1, D2, B, g,
        keep, perm, mx, den, srow, grad_B, grad_D2, part_B, part_D);
    err = cudaGetLastError();
    if (err != cudaSuccess || sp.J == 0) return err;
    err = gespmm::launch_carry<T, VEC>(sp.J, K, sp.long_rows, sp.seg_ptr,
                                       part_B, grad_B, stream);
    if (err != cudaSuccess) return err;
    return gespmm::launch_carry<float, VEC>(sp.J, Ka, sp.long_rows,
                                            sp.seg_ptr, part_D, grad_D2,
                                            stream);
  });
}


}  // namespace

// Every entry point takes the split of its structure: segment length L, S
// segments and J long rows (S = J = 0: no split, no carry) with the lists
// seg_row, seg_start (S), long_rows (J) and seg_ptr (J + 1), and scratch
// buffers of S rows (null when S = 0).  vec (1, 2 or 4) divides K and Ka,
// and every table is aligned to it; sw is 4, 8, 16 or 32.  leaky = 0 is the
// identity act (slope unused).

// Forward over the CSR (indptr, indices): m >= 1, K >= 1, Ka >= 1, nnz >= 1
// (the caller returns early otherwise).  D1 (m, Ka), D2 (n, Ka), mx and den
// (m,) are f32; B (n, K) and out (m, K) are of one type.  Scratch: pm, pz
// (S,) and pacc (S, K), f32.
#define GESPMM_DOT_FWD(NAME, T)                                               \
  extern "C" int NAME(int m, int K, int Ka, int vec, int sw, int leaky,       \
                      float slope, int L, int S, int J, const int* seg_row,   \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const int* indptr,                  \
                      const int* indices, const float* D1, const float* D2,   \
                      const void* B, void* out, float* mx, float* den,        \
                      float* pm, float* pz, float* pacc, void* stream) {      \
    return (int)forward<T>(                                                   \
        m, K, Ka, vec, sw, leaky, slope,                                      \
        Split{L, S, J, seg_row, seg_start, long_rows, seg_ptr}, indptr,       \
        indices, D1, D2, (const T*)B, (T*)out, mx, den, pm, pz, pacc,         \
        (cudaStream_t)stream);                                                \
  }

GESPMM_DOT_FWD(gespmm_dot_fwd_f32, float)
GESPMM_DOT_FWD(gespmm_dot_fwd_bf16, __nv_bfloat16)

// Backward over the CSR: grad_D1 (m, Ka) f32.  g (m, K), mx, den and srow
// (m,) are f32; B (n, K) is f32 or bf16.  Scratch: part (S, Ka), f32.
#define GESPMM_DOT_BWD_ROWS(NAME, T)                                          \
  extern "C" int NAME(int m, int K, int Ka, int vec, int sw, int leaky,       \
                      float slope, int L, int S, int J, const int* seg_row,   \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const int* indptr,                  \
                      const int* indices, const float* D1, const float* D2,   \
                      const void* B, const float* g, const float* mx,         \
                      const float* den, const float* srow, float* grad_D1,    \
                      float* part, void* stream) {                            \
    return (int)backward_rows<T>(                                             \
        m, K, Ka, vec, sw, leaky, slope,                                      \
        Split{L, S, J, seg_row, seg_start, long_rows, seg_ptr}, indptr,       \
        indices, D1, D2, (const T*)B, g, mx, den, srow, grad_D1, part,        \
        (cudaStream_t)stream);                                                \
  }

GESPMM_DOT_BWD_ROWS(gespmm_dot_bwd_rows_f32, float)
GESPMM_DOT_BWD_ROWS(gespmm_dot_bwd_rows_bf16, __nv_bfloat16)

// Backward over the CSC (colptr, rows): n >= 1 columns; grad_B (n, K) in B's
// type and grad_D2 (n, Ka) f32.  The row-side tables are those of the
// backward over the CSR.  Scratch: part_B (S, K) and part_D (S, Ka), f32.
#define GESPMM_DOT_BWD_COLS(NAME, T)                                          \
  extern "C" int NAME(int n, int K, int Ka, int vec, int sw, int leaky,       \
                      float slope, int L, int S, int J, const int* seg_row,   \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const int* colptr, const int* rows, \
                      const float* D1, const float* D2, const void* B,        \
                      const float* g, const float* mx, const float* den,      \
                      const float* srow, void* grad_B, float* grad_D2,        \
                      float* part_B, float* part_D, void* stream) {           \
    return (int)backward_cols<T>(                                             \
        n, K, Ka, vec, sw, leaky, slope,                                      \
        Split{L, S, J, seg_row, seg_start, long_rows, seg_ptr}, colptr, rows, \
        D1, D2, (const T*)B, g, mx, den, srow, (T*)grad_B, grad_D2, part_B,   \
        part_D, (cudaStream_t)stream);                                        \
  }

GESPMM_DOT_BWD_COLS(gespmm_dot_bwd_cols_f32, float)
GESPMM_DOT_BWD_COLS(gespmm_dot_bwd_cols_bf16, __nv_bfloat16)

// The multi-head entry points, f32 only (the UniMP cell's calls): the
// arguments of the single-head ones, with H (which divides K and Ka) after K
// and Ka, ns and G (the lanes of a head's group, 0 for head by head:
// kernels/gat_fused.py::dot_head_group) after sw, the scale and 1 / keep_prob
// after the slope, and the (nnz, H) byte mask (null: none) after B; the CSC
// walk also takes perm, through which it reads the mask.  mx, den, srow and
// the forward's scratch pm, pz are (·, H).
#define GESPMM_DOT_HEADS_FWD(NAME, T)                                         \
  extern "C" int NAME(int m, int K, int Ka, int H, int vec, int sw, int ns,   \
                      int G, int leaky, float slope, float scale,             \
                      float inv_keep, int L, int S, int J,                    \
                      const int* seg_row, const int* seg_start,               \
                      const int* long_rows, const int* seg_ptr,               \
                      const int* indptr, const int* indices, const float* D1, \
                      const float* D2,                                        \
                      const void* B, const unsigned char* keep, void* out,    \
                      float* mx, float* den, float* pm, float* pz,            \
                      float* pacc, void* stream) {                            \
    return (int)forward_heads<T>(                                             \
        m, K, Ka, vec, sw, ns, Heads{H, G, leaky, slope, scale, inv_keep},    \
        Split{L, S, J, seg_row, seg_start, long_rows, seg_ptr}, indptr,       \
        indices, D1, D2, (const T*)B, keep, (T*)out, mx, den, pm, pz, pacc,   \
        (cudaStream_t)stream);                                                \
  }

GESPMM_DOT_HEADS_FWD(gespmm_dot_heads_fwd_f32, float)

#define GESPMM_DOT_HEADS_BWD_ROWS(NAME, T)                                    \
  extern "C" int NAME(int m, int K, int Ka, int H, int vec, int sw, int ns,   \
                      int G, int leaky, float slope, float scale,             \
                      float inv_keep, int L, int S, int J,                    \
                      const int* seg_row, const int* seg_start,               \
                      const int* long_rows, const int* seg_ptr,               \
                      const int* indptr, const int* indices, const float* D1, \
                      const float* D2,                                        \
                      const void* B, const float* g,                          \
                      const unsigned char* keep, const float* mx,             \
                      const float* den, const float* srow, float* grad_D1,    \
                      float* part, void* stream) {                            \
    return (int)backward_rows_heads<T>(                                       \
        m, K, Ka, vec, sw, ns, Heads{H, G, leaky, slope, scale, inv_keep},    \
        Split{L, S, J, seg_row, seg_start, long_rows, seg_ptr}, indptr,       \
        indices, D1, D2, (const T*)B, g, keep, mx, den, srow, grad_D1, part,  \
        (cudaStream_t)stream);                                                \
  }

GESPMM_DOT_HEADS_BWD_ROWS(gespmm_dot_heads_bwd_rows_f32, float)

#define GESPMM_DOT_HEADS_BWD_COLS(NAME, T)                                    \
  extern "C" int NAME(int n, int K, int Ka, int H, int vec, int sw, int ns,   \
                      int G, int leaky, float slope, float scale,             \
                      float inv_keep, int L, int S, int J,                    \
                      const int* seg_row, const int* seg_start,               \
                      const int* long_rows,                                   \
                      const int* seg_ptr, const int* colptr, const int* rows, \
                      const float* D1, const float* D2, const void* B,        \
                      const float* g, const unsigned char* keep,              \
                      const int* perm, const float* mx, const float* den,     \
                      const float* srow, void* grad_B, float* grad_D2,        \
                      float* part_B, float* part_D, void* stream) {           \
    return (int)backward_cols_heads<T>(                                       \
        n, K, Ka, vec, sw, ns, Heads{H, G, leaky, slope, scale, inv_keep},    \
        Split{L, S, J, seg_row, seg_start, long_rows, seg_ptr}, colptr, rows, \
        D1, D2, (const T*)B, g, keep, perm, mx, den, srow, (T*)grad_B,        \
        grad_D2, part_B, part_D, (cudaStream_t)stream);                       \
  }

GESPMM_DOT_HEADS_BWD_COLS(gespmm_dot_heads_bwd_cols_f32, float)

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
