// nnz-chunked CSR SpMM for Hopper (sm_90a):
//
//     out[r, :] = sum_{e in row r} val_e * B[col_e, :]      (f32 accumulation)
//
// over the chunk work list of gespmm_tpu_torch/sparse/partition.py: row
// blocks of R rows, each block's nonzeros cut into chunks of at most E
// consecutive CSR edges.
//
// Replaces gespmm_tpu/kernels/spmm_pallas.py::_spmm_kernel (spmm_pallas.py:48,
// launched by _spmm_pallas_call, pallas_call :246), the method="pallas" tier.
// On the TPU each grid step DMA-gathered one chunk's E rows of B into VMEM and
// reduced them with one MXU product P[R,E] @ G[E,K]; the grid ran the chunks
// in order, so a block's output stayed resident in VMEM and consecutive
// chunks of a block added into it.  Every step was the same work whatever the
// row lengths: a hub row was spread over many equal steps.
//
// Blocks and warps run in no order on Hopper, so nothing carries from one
// chunk to the next; a row cut by a chunk boundary ("cut row") is summed in
// two passes:
//   * pass 1, one walker per piece.  A piece is the part of one row that lies
//     in one chunk (the plan's piece_ptr / piece_row / piece_slot, built on
//     the host with the plan; an empty row a chunk owns is a piece without
//     edges, which writes zeros).  So a warp's serial work is at most E
//     edges whatever the row lengths, a hub row spreads over many walkers,
//     and the short rows of a chunk are walked side by side instead of one
//     after the other.  A whole row's sum is written to out; a cut row's
//     piece writes its f32 partial to its slot of a scratch buffer (the
//     chunk's head slot when the row began in an earlier chunk, else its
//     tail slot);
//   * pass 2 (the carry, carry.cuh, shared with spmm_grouped.cu), one warp
//     per cut row: the row's partials are added in chunk order and the sum
//     written to out.
// A piece is summed edge by edge in order, so the result is bitwise that of
// the first port (one warp a chunk, walking its rows in turn).  Every output
// element is written once, by one walker, without atomics, so the result is
// bitwise repeatable.  Rows past m are never written (the pieces stop at row
// m - 1).
//
// The walk (carry.cuh::walk_edges): a walker is SW = 4, 8, 16 or 32 lanes of
// a warp, the fewest that cover K / VEC columns (kernels/spmm_csr.py::
// walk_shape: at K = 32 an 8-lane walker of 16-byte lanes, four walkers a
// warp; at K = 128 one warp); a second grid dimension walks K slabs of
// SW * VEC columns.  The walker loads one edge's (col, val) a lane, a round of
// SW, broadcast by shuffle, and gathers the B rows of a batch of edges before
// it adds any, with no branch around a gather (the round's last edge loaded
// again past its end, column 0 for lanes past K).  The batch depth follows
// what the plan's pieces are like (kBatchOf, kTailOf).  The first port walked
// a chunk's edges with one warp, one gather in flight behind a
// data-dependent loop that flushed finished rows and an `if (active)` branch.
//
// What bounds it: bytes.  Every nonzero gathers one K-wide row of B for 2K
// flops (0.5 flop per byte in f32), far below the card's ridge point; the
// scratch traffic is two K-wide f32 rows per chunk boundary, the piece lists
// three ints a piece.
//
// Plain C interface, loaded with ctypes.  The caller picks (VEC, SW) (VEC in
// 1, 2, 4 with K % VEC == 0 and B, out and partial aligned to VEC elements;
// SW in 4, 8, 16, 32).  The entry point launches on the given stream, does
// not synchronise, and returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments it does not take.

#include "carry.cuh"

namespace {

using namespace gespmm;  // the launch shape, type helpers, walker and carry

// Edges whose B rows a walker gathers before it adds any (scripts/row8_ab.py
// --variants; PERF.md).  A narrower walker takes 4 when the plan's pieces
// average at least kDeepPiece edges (DEEP; the sweep's rmat15, ~19-25 edges
// a piece, where 4 beat 2 by 6% at K = 32), else 2 (sbm's ~5-edge pieces,
// where 4 lost 7-10%: a batch of 4 loads rows past a short piece's end).  A
// whole-warp walker (K >= 128) takes 4 and the rest of a round one at a time
// (kTailOf): level with the best fixed depth at both rmat15 chunk sizes,
// where 1 lost 4% at E = 256 and 4 lost 1% at E = 64.  A narrower walker
// keeps one depth: a second loop (4, then 2 at a time) lost 16-20% there,
// its walkers taking different loops.
constexpr int kDeepPiece = 8;
template <int SW, bool DEEP>
constexpr int kBatchOf = SW == 32 || DEEP ? 4 : 2;
template <int SW, bool DEEP>
constexpr int kTailOf = SW == 32 ? 1 : kBatchOf<SW, DEEP>;

// The running f32 sums of a lane's VEC columns.
template <typename T, int VEC>
struct SumFold {
  float acc[VEC];
  __device__ __forceinline__ void operator()(float v, const Pack<T, VEC>& b) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(v, to_f32(b.v[i]), acc[i]);
  }
};

template <typename T, int VEC, int SW, bool DEEP, bool HAS_VALS>
__global__ void __launch_bounds__(kThreads)
spmm_piece_kernel(int P, int K, const int* __restrict__ piece_ptr,
                  const int* __restrict__ piece_row,
                  const int* __restrict__ piece_slot,
                  const int* __restrict__ indices,
                  const float* __restrict__ vals, const T* __restrict__ B,
                  T* __restrict__ out, float* __restrict__ partial) {
  constexpr int kPerBlock = kThreads / SW;
  const Sub<SW> w;
  const int k = (blockIdx.y * SW + w.lane) * VEC;  // first column of this lane
  const bool active = k < K;  // K % VEC == 0, so k < K covers all VEC
  const int kk = active ? k : 0;  // a lane past K reads column 0, drops it
  for (int p = blockIdx.x * kPerBlock + threadIdx.x / SW; p < P;
       p += gridDim.x * kPerBlock) {
    const int s = piece_ptr[p], t = piece_ptr[p + 1];
    const int row = piece_row[p], slot = piece_slot[p];
    SumFold<T, VEC> sum;
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum.acc[i] = 0.f;
    walk_edges<T, VEC, SW, kBatchOf<SW, DEEP>, HAS_VALS, kTailOf<SW, DEEP>>(
        w, s, t, K, kk, indices, vals, B, sum);
    if (!active) continue;
    if (slot >= 0) {
      Pack<float, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = sum.acc[i];
      *reinterpret_cast<Pack<float, VEC>*>(partial + (int64_t)slot * K + k) = o;
    } else {
      Pack<T, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(sum.acc[i]);
      *reinterpret_cast<Pack<T, VEC>*>(out + (int64_t)row * K + k) = o;
    }
  }
}

template <typename T, int VEC, int SW, bool DEEP>
void launch_pieces(int P, int K, const int* indices, const float* vals,
                   const int* piece_ptr, const int* piece_row,
                   const int* piece_slot, const T* B, T* out, float* partial,
                   cudaStream_t stream) {
  constexpr int kPerBlock = kThreads / SW;
  const unsigned blocks = (unsigned)((P + kPerBlock - 1) / kPerBlock);
  const dim3 grid(blocks < kMaxBlocksX ? blocks : kMaxBlocksX,
                  (unsigned)((K + SW * VEC - 1) / (SW * VEC)));
  if (vals != nullptr) {
    spmm_piece_kernel<T, VEC, SW, DEEP, true><<<grid, kThreads, 0, stream>>>(
        P, K, piece_ptr, piece_row, piece_slot, indices, vals, B, out,
        partial);
  } else {
    spmm_piece_kernel<T, VEC, SW, DEEP, false><<<grid, kThreads, 0, stream>>>(
        P, K, piece_ptr, piece_row, piece_slot, indices, nullptr, B, out,
        partial);
  }
}

template <typename T>
cudaError_t launch(int P, int J, int K, int vec, int sw, int nnz,
                   const int* indices, const float* vals,
                   const int* piece_ptr, const int* piece_row,
                   const int* piece_slot, const int* cut_rows,
                   const int* cut_ptr, const T* B, T* out, float* partial,
                   cudaStream_t stream) {
  if (P < 1 || K < 1 || J < 0 || vec < 1 || K % vec != 0 ||
      (uintptr_t)B % (vec * sizeof(T)) != 0 ||
      (uintptr_t)out % (vec * sizeof(T)) != 0 ||
      (J > 0 && (partial == nullptr ||
                 (uintptr_t)partial % (vec * sizeof(float)) != 0)))
    return cudaErrorInvalidValue;
  const bool deep = (int64_t)nnz >= (int64_t)kDeepPiece * P;
  return dispatch(vec, sw, [&](auto v, auto s) -> cudaError_t {
    constexpr int VEC = decltype(v)::value, SW = decltype(s)::value;
    auto pieces = [&](auto d) {
      launch_pieces<T, VEC, SW, decltype(d)::value>(
          P, K, indices, vals, piece_ptr, piece_row, piece_slot, B, out,
          partial, stream);
    };
    if constexpr (SW < 32) {
      if (deep) {
        pieces(std::true_type());
      } else {
        pieces(std::false_type());
      }
    } else {
      pieces(std::false_type());  // one depth for a whole warp
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || J == 0) return err;
    return launch_carry<T, VEC>(J, K, cut_rows, cut_ptr, partial, out, stream);
  });
}

}  // namespace

// P >= 1 pieces over nnz edges, K >= 1 (the caller returns early
// otherwise); J cut rows (pass 2 runs only for J > 0) with partial a
// (cut_ptr[J], K) f32 scratch buffer; vals may be null (implicit 1.0).
extern "C" int gespmm_spmm_chunk_f32(
    int P, int J, int K, int vec, int sw, int nnz, const int* indices,
    const float* vals, const int* piece_ptr, const int* piece_row,
    const int* piece_slot, const int* cut_rows, const int* cut_ptr,
    const float* B, float* out, float* partial, void* stream) {
  return (int)launch<float>(P, J, K, vec, sw, nnz, indices, vals, piece_ptr,
                            piece_row, piece_slot, cut_rows, cut_ptr, B, out,
                            partial, (cudaStream_t)stream);
}

extern "C" int gespmm_spmm_chunk_bf16(
    int P, int J, int K, int vec, int sw, int nnz, const int* indices,
    const float* vals, const int* piece_ptr, const int* piece_row,
    const int* piece_slot, const int* cut_rows, const int* cut_ptr,
    const void* B, void* out, float* partial, void* stream) {
  return (int)launch<__nv_bfloat16>(
      P, J, K, vec, sw, nnz, indices, vals, piece_ptr, piece_row, piece_slot,
      cut_rows, cut_ptr, (const __nv_bfloat16*)B, (__nv_bfloat16*)out,
      partial, (cudaStream_t)stream);
}

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
