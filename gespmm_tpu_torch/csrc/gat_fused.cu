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
//   * K is cut into slabs of SW*VEC columns, and a walker holds NS of them
//     at once (kernels/gat_fused.py::launch_shape), walking the groups of NS
//     slabs in turn: on a whole warp 4 at 4-column lanes and 6 at 1-column
//     lanes, where they divide K's slabs and their heads fit its lanes and
//     tables, else 1.  At the products GAT's K = 512 (VEC 4) a warp holds all
//     4 slabs, at K = 188 (VEC 1) all 6, so each walks a row's edges once
//     where a walk a slab re-derived every edge's weights 4 or 6 times;
//     NS = 1 where K fits one slab (K <= SW*VEC);
//   * the walk goes in batches of SW edges.  Lane j owns edge j of the batch:
//     it loads the edge's index and node-table entries, for every head of the
//     walker's slabs at once (4 heads' loads issued before any is used), and
//     computes the per-(edge, head) quantities once (the logit, z, alpha, w).
//     They reach the column lanes through a small shared-memory table per
//     walker ([head][edge], stride SW + 1, so that neither the writes nor the
//     column lanes' reads conflict); the edge index goes by shuffle;
//   * the lanes then run over columns, VEC consecutive each in each of the
//     NS slabs (vector loads; VEC divides dh, so a lane's columns in a slab
//     lie in one head), and gather the B (or g) rows of 4 edges (2 where a
//     lane holds 16 columns or more) in every slab before folding any, with
//     idle lanes reading column 0 and the batch's last edge loaded again in
//     place of edges past its end, so that 4 x NS gathers are in flight and
//     none sits behind a branch (an `if (active)` load in an unrolled loop
//     compiled to a branch around each gather in halo_spmm.cu).  Each slab
//     keeps its own sums in registers (NS is a template parameter) and takes
//     the edges in the same order as a walk of its own, so every output is
//     the same bits at any NS;
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
//     head's run (a fixed shuffle order), and after the walk the slabs are
//     written in order, each carrying the partial of a head that continues
//     into the next slab;
//   * every output element is written once, without atomics, so two calls
//     agree bit for bit;
//   * expf, not __expf (the build does not use --use_fast_math), so the
//     float64 comparisons keep their margins.
// Not here yet: a multi-head edge step (the loop over the heads runs a
// shuffle tree and an exp per head, so 8 heads take 1.4-3.6x one head's time
// at the same K: PERF.md, section 6); lanes wider than one column at an odd
// head width (K = 188 runs 1-column lanes); the edges of several short rows
// in one batch (a row of about 5 edges leaves most of a walker's edge lanes
// idle).
//
// The walker's chain of dependent loads (indptr, indices, dst, B) sets a
// short row's time, so the first B rows of a batch are gathered before its
// edge math and overlap the dst gathers.
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// dh % VEC == 0 and every K-wide table aligned to VEC elements), SW (4, 8,
// 16 or 32) and NS (1; 4 at VEC 4 and 6 at VEC 1 on SW = 32; dividing K's
// slabs, whose every group of NS touches at most SW heads).  Each entry point
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not take.

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

// Table rows gathered a slab before they are folded: 4, or 2 where a lane
// holds 16 columns or more over its slabs, so that a walker keeps 8-16 rows
// in flight without running out of registers.
template <int NS, int VEC>
constexpr int kBatchOf = NS * VEC >= 16 ? 2 : 4;

// Heads whose node-table entries a walker loads before it uses any: 4 where
// it holds several slabs (a whole warp, often several heads), 1 in a
// one-slab walker, whose short rows are latency-bound and whose occupancy
// the registers of more loads in flight would cut.
template <int NS>
constexpr int kHeadLoadsOf = NS > 1 ? 4 : 1;

// Blocks of walkers an SM keeps at least (each kernel's second launch
// bound).  A walker holding several slabs is held to 128 registers a lane,
// two blocks an SM: left free, the CSC backward and the K = 188 walks took
// more and one block, and ran 1.1-1.5x longer.  A one-slab walker's short
// rows are latency-bound, and it keeps the occupancy at which each kernel
// was measured fastest (PERF.md, section 6, row 5): ONE_SLAB blocks, 1
// leaving the registers free.
template <int NS, int ONE_SLAB>
constexpr int kMinBlocks = NS > 1 ? 2 : ONE_SLAB;

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
  int k_begin, k_end, k, kk, h_lo, nh, hd, run_end;
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
    run_end = min(k_end, (hd + 1) * dh);
  }
};

// The NS slabs of group `grp` (slabs grp*NS .. grp*NS + NS - 1): the heads
// h_lo .. h_lo + nh - 1 they touch (the rows of the walker's [head][edge]
// tables; nh <= SW, the launch checks), and for each slab the lane's first
// column (0 past K) and its head's row.
template <int SW, int VEC, int NS>
struct Group {
  int h_lo, nh, kk[NS], hg[NS];
  __device__ Group(int grp, int K, int dh, int lane) {
    const int k0 = grp * NS * SW * VEC;
    h_lo = k0 / dh;
    nh = (min(K, k0 + NS * SW * VEC) - 1) / dh - h_lo + 1;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const Cols<SW, VEC> cl(grp * NS + s, K, dh, lane);
      kk[s] = cl.kk;
      hg[s] = cl.hd - h_lo;
    }
  }
};

// Calls fn(hh, v[0..T-1]) for each head hh < nh of a group, with v[t] =
// tab[t][hh], the lane's entries of T node tables at its edge: the loads of
// HL heads are issued before any is used (past nh the last head is loaded
// again and not used), so that a walker's per-edge gathers of the tables
// overlap.  Walker-uniform: fn may shuffle.
template <int HL, int T, typename Fn>
__device__ __forceinline__ void for_heads(int nh, const float* const (&tab)[T],
                                          Fn&& fn) {
  for (int h0 = 0; h0 < nh; h0 += HL) {
    float v[HL][T];
#pragma unroll
    for (int q = 0; q < HL; ++q) {
#pragma unroll
      for (int t = 0; t < T; ++t) v[q][t] = __ldg(tab[t] + min(h0 + q, nh - 1));
    }
#pragma unroll
    for (int q = 0; q < HL; ++q) {
      if (h0 + q < nh) fn(h0 + q, v[q]);
    }
  }
}

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

// Gathers the rows of NB edges of the batch (u0 .. u0 + NB - 1; past n_here
// the batch's last edge again) from a K-wide table, at the lane's columns of
// each of the group's NS slabs, before any is folded.
template <int SW, int VEC, int NS, int NB, typename P, typename T>
__device__ __forceinline__ void gather(const Sub<SW>& w,
                                       const Group<SW, VEC, NS>& gr,
                                       P (&p)[NS][NB], const T* __restrict__ X,
                                       int K, int idx, int u0, int n_here) {
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const T* row = X + (int64_t)w.get(idx, min(u0 + u, n_here - 1)) * K;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      p[s][u] = *reinterpret_cast<const P*>(row + gr.kk[s]);
  }
}

template <typename T, int VEC, int SW, int NS>
__global__ void
__launch_bounds__(kThreads, kMinBlocks<NS, VEC == 1 ? 5 : 1>)
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
  constexpr int NB = kBatchOf<NS, VEC>;
  const Sub<SW> w;
  extern __shared__ float smem[];
  float* zb = smem + (threadIdx.x / SW) * nh_max * kStride;  // [head][edge]
  const int ngrp = (K + NS * SW * VEC - 1) / (NS * SW * VEC);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + m;
       item += gridDim.x * kPerBlock) {
    Item it;
    if (!item_edges(item, S, L, indptr, seg_row, seg_start, it)) continue;
    const int64_t rH = (int64_t)it.row * H;
    for (int grp = 0; grp < ngrp; ++grp) {
      const Group<SW, VEC, NS> gr(grp, K, dh, w.lane);
      // Lane hh < nh keeps head h_lo + hh's source score, shift and batch
      // rescale.
      float s_h = 0.f, m_run = -CUDART_INF_F, scale = 1.f;
      if (w.lane < gr.nh) {
        s_h = src[rH + gr.h_lo + w.lane];
        if (!exact) m_run = mx[rH + gr.h_lo + w.lane];
      }
      float acc[NS][VEC], zsum[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        zsum[s] = 0.f;
#pragma unroll
        for (int t = 0; t < VEC; ++t) acc[s][t] = 0.f;
      }
      for (int base = it.s; base < it.t; base += SW) {
        // Warp-uniform down to the shuffles: every lane of the walker takes
        // part; a lane past the batch takes edge index 0 and weight 0.
        const int e = base + w.lane;
        const bool live = e < it.t;
        const int c = live ? __ldg(indices + e) : 0;
        const int n_here = min(SW, it.t - base);
        // The first B rows are gathered before the edge math, so that their
        // loads overlap the dst gathers.
        P p[NS][NB];
        gather(w, gr, p, B, K, c, 0, n_here);
        const float* const tab[1] = {dst + (int64_t)c * H + gr.h_lo};
        for_heads<kHeadLoadsOf<NS>>(gr.nh, tab, [&](int hh,
                                                     const float (&v)[1]) {
          const float l = leaky(w.get(s_h, hh) + v[0], slope);
          const float m_old = w.get(m_run, hh);
          const float m_new =
              exact ? fmaxf(m_old, w.max(live ? l : -CUDART_INF_F)) : m_old;
          zb[hh * kStride + w.lane] =
              live ? expf(fmaxf(l - m_new, kExpFloor)) : 0.f;
          if (w.lane == hh) {
            scale = m_old == m_new ? 1.f : expf(m_old - m_new);
            m_run = m_new;
          }
        });
        w.sync();
        if (exact) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float sc = w.get(scale, gr.hg[s]);
            zsum[s] *= sc;
#pragma unroll
            for (int t = 0; t < VEC; ++t) acc[s][t] *= sc;
          }
        }
        for (int u0 = 0;;) {
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            if (u0 + u < n_here) {
#pragma unroll
              for (int s = 0; s < NS; ++s) {
                const float z = zb[gr.hg[s] * kStride + u0 + u];
                zsum[s] += z;
#pragma unroll
                for (int t = 0; t < VEC; ++t)
                  acc[s][t] = fmaf(z, to_f32(p[s][u].v[t]), acc[s][t]);
              }
            }
          }
          u0 += NB;
          if (u0 >= n_here) break;
          gather(w, gr, p, B, K, c, u0, n_here);
        }
        w.sync();  // the next batch overwrites zb
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const Cols<SW, VEC> cl(grp * NS + s, K, dh, w.lane);
        const float m_h = w.get(m_run, gr.hg[s]);
        if (!cl.active) continue;
        const bool first = cl.k % dh == 0;  // holds its head's first column
        if (item < S) {
          F o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = acc[s][t];
          *reinterpret_cast<F*>(pacc + (int64_t)item * K + cl.k) = o;
          if (first) {
            pm[(int64_t)item * H + cl.hd] = m_h;
            pz[(int64_t)item * H + cl.hd] = zsum[s];
          }
        } else {
          const float d = fmaxf(zsum[s], kDenomEps);
          P o;
#pragma unroll
          for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(acc[s][t] / d);
          *reinterpret_cast<P*>(out + (int64_t)it.row * K + cl.k) = o;
          if (first) {
            den[rH + cl.hd] = d;
            if (exact) mx[rH + cl.hd] = isfinite(m_h) ? m_h : 0.f;
          }
        }
      }
    }
  }
}

template <typename T, int VEC, int SW, int NS>
__global__ void
__launch_bounds__(kThreads, kMinBlocks<NS, VEC == 1 ? 5 : 4>)
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
  constexpr int NB = kBatchOf<NS, VEC>;
  const Sub<SW> w;
  extern __shared__ float smem[];
  float* wb = smem + (threadIdx.x / SW) * nh_max * kStride;  // [head][edge]
  const int ngrp = (K + NS * SW * VEC - 1) / (NS * SW * VEC);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + m;
       item += gridDim.x * kPerBlock) {
    Item it;
    if (!item_edges(item, S, L, indptr, seg_row, seg_start, it)) continue;
    const int64_t rH = (int64_t)it.row * H;
    float carry = 0.f;
    for (int grp = 0; grp < ngrp; ++grp) {
      const Group<SW, VEC, NS> gr(grp, K, dh, w.lane);
      // Lane hh < nh holds the row-side tables of head h_lo + hh.
      float s_h = 0.f, m_h = 0.f, d_h = 1.f;
      if (w.lane < gr.nh) {
        const int64_t at = rH + gr.h_lo + w.lane;
        s_h = src[at];
        m_h = mx[at];
        d_h = den[at];
      }
      float acc[NS][VEC], wsum[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        wsum[s] = 0.f;
#pragma unroll
        for (int t = 0; t < VEC; ++t) acc[s][t] = 0.f;
      }
      for (int base = it.s; base < it.t; base += SW) {
        const int e = base + w.lane;
        const bool live = e < it.t;
        const int c = live ? __ldg(indices + e) : 0;
        const int n_here = min(SW, it.t - base);
        P p[NS][NB];
        gather(w, gr, p, B, K, c, 0, n_here);
        const float* const tab[1] = {dst + (int64_t)c * H + gr.h_lo};
        for_heads<kHeadLoadsOf<NS>>(gr.nh, tab, [&](int hh,
                                                     const float (&v)[1]) {
          const float pre = w.get(s_h, hh) + v[0];
          const float a = attention(pre, slope, w.get(m_h, hh), w.get(d_h, hh));
          wb[hh * kStride + w.lane] = live ? a * dleaky(pre, slope) : 0.f;
        });
        w.sync();
        for (int u0 = 0;;) {
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            if (u0 + u < n_here) {
#pragma unroll
              for (int s = 0; s < NS; ++s) {
                const float wt = wb[gr.hg[s] * kStride + u0 + u];
                wsum[s] += wt;
#pragma unroll
                for (int t = 0; t < VEC; ++t)
                  acc[s][t] = fmaf(wt, to_f32(p[s][u].v[t]), acc[s][t]);
              }
            }
          }
          u0 += NB;
          if (u0 >= n_here) break;
          gather(w, gr, p, B, K, c, u0, n_here);
        }
        w.sync();
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const Cols<SW, VEC> cl(grp * NS + s, K, dh, w.lane);
        float x = 0.f;
        if (cl.active) {
          const F gv =
              *reinterpret_cast<const F*>(g + (int64_t)it.row * K + cl.k);
#pragma unroll
          for (int t = 0; t < VEC; ++t) x = fmaf(gv.v[t], acc[s][t], x);
        }
        x = head_sum(w, cl, x);
        if (head_total(w, cl, dh, x, carry)) {
          const float v = fmaf(-__ldg(srow + rH + cl.hd), wsum[s], x);
          if (item < S)
            part[(int64_t)item * H + cl.hd] = v;
          else
            grad_src[rH + cl.hd] = v;
        }
      }
    }
  }
}

template <typename T, int VEC, int SW, int NS>
__global__ void
__launch_bounds__(kThreads, kMinBlocks<NS, VEC == 1 ? 4 : 1>)
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
  constexpr int NB = kBatchOf<NS, VEC>;
  const Sub<SW> w;
  extern __shared__ float smem[];
  // [head][edge] tables of alpha, w and w * s[r, h].
  float* ab = smem + (threadIdx.x / SW) * 3 * nh_max * kStride;
  float* wb = ab + nh_max * kStride;
  float* qb = wb + nh_max * kStride;
  const int ngrp = (K + NS * SW * VEC - 1) / (NS * SW * VEC);
  for (int item = blockIdx.x * kPerBlock + threadIdx.x / SW; item < S + n;
       item += gridDim.x * kPerBlock) {
    Item it;  // it.row is the column
    if (!item_edges(item, S, L, colptr, seg_row, seg_start, it)) continue;
    const int64_t cH = (int64_t)it.row * H;
    float carry = 0.f;
    for (int grp = 0; grp < ngrp; ++grp) {
      const Group<SW, VEC, NS> gr(grp, K, dh, w.lane);
      const float d_c = w.lane < gr.nh ? dst[cH + gr.h_lo + w.lane] : 0.f;
      float accB[NS][VEC], accD[NS][VEC], sw[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        sw[s] = 0.f;
#pragma unroll
        for (int t = 0; t < VEC; ++t) accB[s][t] = accD[s][t] = 0.f;
      }
      for (int base = it.s; base < it.t; base += SW) {
        const int e = base + w.lane;
        const bool live = e < it.t;
        const int r = live ? __ldg(rows + e) : 0;
        const int n_here = min(SW, it.t - base);
        F gv[NS][NB];
        gather(w, gr, gv, g, K, r, 0, n_here);
        // The row-side tables of the edge's row, for every head of the group.
        const int64_t rh = (int64_t)r * H + gr.h_lo;
        const float* const tab[4] = {src + rh, mx + rh, den + rh, srow + rh};
        for_heads<kHeadLoadsOf<NS>>(gr.nh, tab, [&](int hh,
                                                     const float (&v)[4]) {
          const float pre = v[0] + w.get(d_c, hh);
          const float a = attention(pre, slope, v[1], v[2]);
          const float wv = a * dleaky(pre, slope);
          const float q = wv * v[3];
          ab[hh * kStride + w.lane] = live ? a : 0.f;
          wb[hh * kStride + w.lane] = live ? wv : 0.f;
          qb[hh * kStride + w.lane] = live ? q : 0.f;
        });
        w.sync();
        for (int u0 = 0;;) {
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            if (u0 + u < n_here) {
#pragma unroll
              for (int s = 0; s < NS; ++s) {
                const int at = gr.hg[s] * kStride + u0 + u;
                const float a = ab[at], wv = wb[at];
                sw[s] += qb[at];
#pragma unroll
                for (int t = 0; t < VEC; ++t) {
                  accB[s][t] = fmaf(a, gv[s][u].v[t], accB[s][t]);
                  accD[s][t] = fmaf(wv, gv[s][u].v[t], accD[s][t]);
                }
              }
            }
          }
          u0 += NB;
          if (u0 >= n_here) break;
          gather(w, gr, gv, g, K, r, u0, n_here);
        }
        w.sync();
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const Cols<SW, VEC> cl(grp * NS + s, K, dh, w.lane);
        float x = 0.f;
        if (cl.active) {
          const P b =
              *reinterpret_cast<const P*>(B + (int64_t)it.row * K + cl.k);
#pragma unroll
          for (int t = 0; t < VEC; ++t) x = fmaf(to_f32(b.v[t]), accD[s][t], x);
          if (item < S) {
            F o;
#pragma unroll
            for (int t = 0; t < VEC; ++t) o.v[t] = accB[s][t];
            *reinterpret_cast<F*>(part_B + (int64_t)item * K + cl.k) = o;
          } else {
            P o;
#pragma unroll
            for (int t = 0; t < VEC; ++t) o.v[t] = from_f32<T>(accB[s][t]);
            *reinterpret_cast<P*>(grad_B + (int64_t)it.row * K + cl.k) = o;
          }
        }
        x = head_sum(w, cl, x);
        if (head_total(w, cl, dh, x, carry)) {
          const float v = x - sw[s];
          if (item < S)
            part_dst[(int64_t)item * H + cl.hd] = v;
          else
            grad_dst[cH + cl.hd] = v;
        }
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

// Calls fn(Int<VEC>, Int<SW>, Int<NS>) for the instantiated walkers: NS = 1
// at every (VEC, SW); on whole warps, the only walkers whose K spans several
// slabs, NS = 4 at 4-column lanes and 6 at 1-column lanes, the products GAT's
// K = 512 and K = 188 (kernels/gat_fused.py::WALK_SLABS, which picks NS).
template <typename Fn>
cudaError_t dispatch_walk(int vec, int sw, int ns, Fn&& fn) {
  return dispatch(vec, sw, [&](auto V, auto W) -> cudaError_t {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    if (ns == 1) return fn(V, W, gespmm::Int<1>());
    if constexpr (SW == 32 && VEC == 4)
      if (ns == 4) return fn(V, W, gespmm::Int<4>());
    if constexpr (SW == 32 && VEC == 1)
      if (ns == 6) return fn(V, W, gespmm::Int<6>());
    return cudaErrorInvalidValue;
  });
}

// The heads of the widest group of NS slabs of W columns (the rows of a
// walker's tables), or 0 where NS slabs a walker do not fit K: they must
// divide K's slabs, and each group's heads must fit the SW lanes (lane j
// holds head j's row-side entries).
int group_heads(int K, int dh, int W, int ns, int sw) {
  const int nh = heads_per_slab(K, dh, ns * W);
  return ((K + W - 1) / W) % ns == 0 && nh <= sw ? nh : 0;
}

template <typename T>
cudaError_t forward(int m, int K, int H, int vec, int sw, int ns, int exact,
                    float slope, const Split& sp, const int* indptr,
                    const int* indices, const float* src, const float* dst,
                    const T* B, float* mx, T* out, float* den, float* pm,
                    float* pz, float* pacc, cudaStream_t stream) {
  if (bad_args(K, H, vec, sp)) return cudaErrorInvalidValue;
  const int dh = K / H;
  return dispatch_walk(vec, sw, ns, [&](auto V, auto W, auto N) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    constexpr int NS = decltype(N)::value;
    const int nh = group_heads(K, dh, SW * VEC, NS, SW);
    if (nh == 0) return cudaErrorInvalidValue;
    if (!aligned(B, VEC * sizeof(T)) || !aligned(out, VEC * sizeof(T)) ||
        (sp.S > 0 && !aligned(pacc, VEC * sizeof(float))))
      return cudaErrorInvalidValue;
    auto kernel = gat_fwd_kernel<T, VEC, SW, NS>;
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
cudaError_t backward_rows(int m, int K, int H, int vec, int sw, int ns,
                          float slope, const Split& sp, const int* indptr,
                          const int* indices, const float* src,
                          const float* dst, const T* B, const float* g,
                          const float* mx, const float* den, const float* srow,
                          float* grad_src, float* part, cudaStream_t stream) {
  if (bad_args(K, H, vec, sp)) return cudaErrorInvalidValue;
  const int dh = K / H;
  return dispatch_walk(vec, sw, ns, [&](auto V, auto W, auto N) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    constexpr int NS = decltype(N)::value;
    const int nh = group_heads(K, dh, SW * VEC, NS, SW);
    if (nh == 0) return cudaErrorInvalidValue;
    if (!aligned(B, VEC * sizeof(T)) || !aligned(g, VEC * sizeof(float)))
      return cudaErrorInvalidValue;
    auto kernel = gat_bwd_rows_kernel<T, VEC, SW, NS>;
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
cudaError_t backward_cols(int n, int K, int H, int vec, int sw, int ns,
                          float slope, const Split& sp, const int* colptr,
                          const int* rows, const float* src, const float* dst,
                          const T* B,
                          const float* g, const float* mx, const float* den,
                          const float* srow, T* grad_B, float* grad_dst,
                          float* part_B, float* part_dst, cudaStream_t stream) {
  if (bad_args(K, H, vec, sp)) return cudaErrorInvalidValue;
  const int dh = K / H;
  return dispatch_walk(vec, sw, ns, [&](auto V, auto W, auto N) {
    constexpr int VEC = decltype(V)::value, SW = decltype(W)::value;
    constexpr int NS = decltype(N)::value;
    const int nh = group_heads(K, dh, SW * VEC, NS, SW);
    if (nh == 0) return cudaErrorInvalidValue;
    if (!aligned(B, VEC * sizeof(T)) || !aligned(g, VEC * sizeof(float)) ||
        !aligned(grad_B, VEC * sizeof(T)) ||
        (sp.S > 0 && !aligned(part_B, VEC * sizeof(float))))
      return cudaErrorInvalidValue;
    auto kernel = gat_bwd_cols_kernel<T, VEC, SW, NS>;
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
  extern "C" int NAME(int m, int K, int H, int vec, int sw, int ns,           \
                      int exact, float slope, int L, int S, int J,            \
                      const int* seg_row,                                     \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const int* indptr,                  \
                      const int* indices, const float* src, const float* dst, \
                      const void* B, float* mx, void* out, float* den,        \
                      float* pm, float* pz, float* pacc, void* stream) {      \
    return (int)forward<T>(m, K, H, vec, sw, ns, exact, slope,                \
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
  extern "C" int NAME(int m, int K, int H, int vec, int sw, int ns,           \
                      float slope, int L, int S, int J, const int* seg_row,   \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const int* indptr,                  \
                      const int* indices, const float* src, const float* dst, \
                      const void* B, const float* g, const float* mx,         \
                      const float* den, const float* srow, float* grad_src,   \
                      float* part, void* stream) {                            \
    return (int)backward_rows<T>(                                             \
        m, K, H, vec, sw, ns, slope,                                          \
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
  extern "C" int NAME(int n, int K, int H, int vec, int sw, int ns,           \
                      float slope, int L, int S, int J, const int* seg_row,   \
                      const int* seg_start, const int* long_rows,             \
                      const int* seg_ptr, const int* colptr,                  \
                      const int* rows, const float* src, const float* dst,    \
                      const void* B, const float* g, const float* mx,         \
                      const float* den, const float* srow, void* grad_B,      \
                      float* grad_dst, float* part_B, float* part_dst,        \
                      void* stream) {                                         \
    return (int)backward_cols<T>(                                             \
        n, K, H, vec, sw, ns, slope,                                          \
        Split{L, S, J, seg_row, seg_start, long_rows, seg_ptr}, colptr, rows, \
        src, dst, (const T*)B, g, mx, den, srow, (T*)grad_B, grad_dst,        \
        part_B, part_dst, (cudaStream_t)stream);                              \
  }

GESPMM_GAT_BWD_COLS(gespmm_gat_bwd_cols_f32, float)
GESPMM_GAT_BWD_COLS(gespmm_gat_bwd_cols_bf16, __nv_bfloat16)

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
