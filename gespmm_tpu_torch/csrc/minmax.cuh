// The max/min contribution and its running (extremum, count) fold, shared by
// the max/min SpMM (spmm_minmax.cu) and the joint diag+halo SpMM
// (halo_spmm.cu), and the fold of split rows' (extremum, count) pairs
// (carry.cuh's pair carry).
//
// The backward over the CSC (spmm_minmax.cu) finds the edges that achieve an
// output again by recomputing each contribution and comparing it with the
// stored output, so every forward must form a contribution with the same
// f32 expression: __fmul_rn(val, B) (which nvcc never contracts into an
// FMA), or B itself for a binary matrix.  Both kernels take it from here, so
// that the two cannot drift apart; the build does not use --use_fast_math.

#pragma once

#include <math_constants.h>

namespace gespmm {

template <bool HAS_VALS>
__device__ __forceinline__ float minmax_contrib(float val, float b) {
  return HAS_VALS ? __fmul_rn(val, b) : b;
}

// The identity of the running extremum: an empty row keeps it, with count 0.
template <bool IS_MAX>
__device__ __forceinline__ float minmax_identity() {
  return IS_MAX ? -CUDART_INF_F : CUDART_INF_F;
}

// A strictly better contribution resets the count to 1, an equal one adds 1.
template <bool IS_MAX>
__device__ __forceinline__ void minmax_fold(float x, float& best, int& count) {
  const bool better = IS_MAX ? x > best : x < best;
  count = better ? 1 : count + (x == best);
  best = better ? x : best;
}

// Folds a segment's (extremum, count) pair into the running pair, in
// segment order: a strictly better extremum replaces the pair, an equal one
// adds its count.  Over a row's segments in order this gives the extremum
// and the count of minmax_fold over the whole row, bit for bit (the same
// exact compares; the first achieving segment keeps its extremum, so even
// the sign of a zero is the one-warp walk's).
template <bool IS_MAX>
__device__ __forceinline__ void minmax_fold_pair(float x, float n, float& best,
                                                 float& count) {
  const bool better = IS_MAX ? x > best : x < best;
  count = better ? n : count + (x == best ? n : 0.f);
  best = better ? x : best;
}

}  // namespace gespmm
