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
// Here one warp takes one chunk, so the work of a warp is at most E edges
// whatever the row lengths, and a hub row spreads over many warps.  Blocks
// and warps run in no order on Hopper, so nothing carries from one chunk to
// the next; a row cut by a chunk boundary ("cut row") is summed in two passes:
//   * pass 1, one warp per chunk: the lanes own VEC consecutive columns of a
//     32*VEC-wide K slab (a second grid dimension walks the slabs); the
//     chunk's (col, val) pairs are loaded 32 at a time, one per lane, and
//     broadcast with __shfl_sync; the warp walks its rows in order, keeping
//     each row's sum in f32 registers.  A row wholly inside the chunk (an
//     empty row too) is written to out directly; the partial sum of a cut row
//     goes to its slot of an f32 scratch buffer instead (head_slot for the
//     chunk's first row when it began in an earlier chunk, tail_slot for its
//     last row when it goes on into a later one);
//   * pass 2 (the carry, carry.cuh, shared with spmm_grouped.cu), one warp
//     per cut row: the row's partials are added in chunk order and the sum
//     written to out.
// Every output element is written once, by one warp, without atomics, so the
// result is bitwise repeatable.  Rows past m are never written (the plan's
// row lists stop at m - 1).
//
// What bounds it: bytes.  Every nonzero gathers one K-wide row of B for 2K
// flops (0.5 flop per byte in f32), far below the card's ridge point; the
// scratch traffic is two K-wide f32 rows per chunk boundary.  The chunking
// bounds each warp's serial walk at E edges, where the one-warp-per-row CSR
// kernel (spmm_csr.cu) walks a hub row of thousands of edges with one warp.
// Not here yet: a block per chunk with the edges split over its warps,
// staging B rows through shared memory with TMA, and wgmma.
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// K % VEC == 0 and B, out aligned to VEC elements).  The entry point launches
// on the given stream, does not synchronise, and returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments it does not take.

#include "carry.cuh"

namespace {

using namespace gespmm;  // the launch shape, type helpers and carry pass

constexpr unsigned kFull = 0xffffffffu;

// Where a finished row's sum goes: its slot of the scratch buffer when the
// row is cut at this chunk's start (head) or end (tail), else out.
template <typename T, int VEC>
__device__ __forceinline__ void flush_row(float (&acc)[VEC], int r, int rs,
                                          int re, int s, int t, int head,
                                          int tail, int K, int k, bool active,
                                          T* __restrict__ out,
                                          float* __restrict__ partial) {
  if (active) {
    if (rs < s || re > t) {
      Pack<float, VEC> p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) p.v[i] = acc[i];
      const int slot = rs < s ? head : tail;
      *reinterpret_cast<Pack<float, VEC>*>(partial + (int64_t)slot * K + k) = p;
    } else {
      Pack<T, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i]);
      *reinterpret_cast<Pack<T, VEC>*>(out + (int64_t)r * K + k) = o;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
}

template <typename T, int VEC, bool HAS_VALS>
__global__ void __launch_bounds__(kThreads)
spmm_chunk_kernel(int C, int K, const int* __restrict__ indptr,
                  const int* __restrict__ indices,
                  const float* __restrict__ vals,
                  const int* __restrict__ chunk_start,
                  const int* __restrict__ chunk_count,
                  const int* __restrict__ row_lo,
                  const int* __restrict__ row_hi,
                  const int* __restrict__ head_slot,
                  const int* __restrict__ tail_slot, const T* __restrict__ B,
                  T* __restrict__ out, float* __restrict__ partial) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.y * 32 + lane) * VEC;  // first column of this lane
  const bool active = k < K;  // K % VEC == 0, so k < K covers all VEC
  const int stride = gridDim.x * kWarps;
  for (int c = blockIdx.x * kWarps + (threadIdx.x >> 5); c < C; c += stride) {
    // Everything below is warp-uniform down to the shuffles.
    const int s = chunk_start[c];
    const int t = s + chunk_count[c];
    const int head = head_slot[c], tail = tail_slot[c];
    const int r_hi = row_hi[c];
    int r = row_lo[c];
    int rs = indptr[r], re = indptr[r + 1];
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int base = s; base < t; base += 32) {
      const int e = base + lane;
      int col = 0;
      float v = 0.f;
      if (e < t) {
        col = __ldg(indices + e);
        if (HAS_VALS) v = __ldg(vals + e);
      }
      const int n_here = min(32, t - base);
      for (int j = 0; j < n_here; ++j) {
        // Finish every row that ends before this edge (empty rows too).
        while (base + j >= re) {
          flush_row<T, VEC>(acc, r, rs, re, s, t, head, tail, K, k, active,
                            out, partial);
          ++r;
          rs = re;
          re = __ldg(indptr + r + 1);
        }
        const int cj = __shfl_sync(kFull, col, j);
        float vj = 1.f;
        if (HAS_VALS) vj = __shfl_sync(kFull, v, j);
        if (active) {
          const P p = *reinterpret_cast<const P*>(B + (int64_t)cj * K + k);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fmaf(vj, to_f32(p.v[i]), acc[i]);
        }
      }
    }
    // The row holding the chunk's last edge, then the empty rows the chunk
    // owns after it (a block's trailing empty rows, or a chunk without edges).
    for (;;) {
      flush_row<T, VEC>(acc, r, rs, re, s, t, head, tail, K, k, active, out,
                        partial);
      if (++r > r_hi) break;
      rs = re;
      re = __ldg(indptr + r + 1);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(int C, int J, int K, const int* indptr,
                       const int* indices, const float* vals,
                       const int* chunk_start, const int* chunk_count,
                       const int* row_lo, const int* row_hi,
                       const int* head_slot, const int* tail_slot,
                       const int* cut_rows, const int* cut_ptr, const T* B,
                       T* out, float* partial, cudaStream_t stream) {
  if (K % VEC != 0 || (uintptr_t)B % (VEC * sizeof(T)) != 0 ||
      (uintptr_t)out % (VEC * sizeof(T)) != 0 ||
      (J > 0 && (uintptr_t)partial % (VEC * sizeof(float)) != 0))
    return cudaErrorInvalidValue;
  const dim3 grid = warp_grid(C, K, VEC);
  if (vals != nullptr) {
    spmm_chunk_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(
        C, K, indptr, indices, vals, chunk_start, chunk_count, row_lo, row_hi,
        head_slot, tail_slot, B, out, partial);
  } else {
    spmm_chunk_kernel<T, VEC, false><<<grid, kThreads, 0, stream>>>(
        C, K, indptr, indices, nullptr, chunk_start, chunk_count, row_lo,
        row_hi, head_slot, tail_slot, B, out, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || J == 0) return err;
  return launch_carry<T, VEC>(J, K, cut_rows, cut_ptr, partial, out, stream);
}

template <typename T>
cudaError_t launch(int C, int J, int K, int vec, const int* indptr,
                   const int* indices, const float* vals,
                   const int* chunk_start, const int* chunk_count,
                   const int* row_lo, const int* row_hi, const int* head_slot,
                   const int* tail_slot, const int* cut_rows,
                   const int* cut_ptr, const T* B, T* out, float* partial,
                   cudaStream_t stream) {
  switch (vec) {
    case 4:
      return launch_vec<T, 4>(C, J, K, indptr, indices, vals, chunk_start,
                              chunk_count, row_lo, row_hi, head_slot, tail_slot,
                              cut_rows, cut_ptr, B, out, partial, stream);
    case 2:
      return launch_vec<T, 2>(C, J, K, indptr, indices, vals, chunk_start,
                              chunk_count, row_lo, row_hi, head_slot, tail_slot,
                              cut_rows, cut_ptr, B, out, partial, stream);
    case 1:
      return launch_vec<T, 1>(C, J, K, indptr, indices, vals, chunk_start,
                              chunk_count, row_lo, row_hi, head_slot, tail_slot,
                              cut_rows, cut_ptr, B, out, partial, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C >= 1 chunks, K >= 1, m >= 1 (the caller returns early otherwise); J cut
// rows (pass 2 runs only for J > 0) with partial a (cut_ptr[J], K) f32
// scratch buffer; vals may be null (implicit 1.0).
extern "C" int gespmm_spmm_chunk_f32(
    int C, int J, int K, int vec, const int* indptr, const int* indices,
    const float* vals, const int* chunk_start, const int* chunk_count,
    const int* row_lo, const int* row_hi, const int* head_slot,
    const int* tail_slot, const int* cut_rows, const int* cut_ptr,
    const float* B, float* out, float* partial, void* stream) {
  return (int)launch<float>(C, J, K, vec, indptr, indices, vals, chunk_start,
                            chunk_count, row_lo, row_hi, head_slot, tail_slot,
                            cut_rows, cut_ptr, B, out, partial,
                            (cudaStream_t)stream);
}

extern "C" int gespmm_spmm_chunk_bf16(
    int C, int J, int K, int vec, const int* indptr, const int* indices,
    const float* vals, const int* chunk_start, const int* chunk_count,
    const int* row_lo, const int* row_hi, const int* head_slot,
    const int* tail_slot, const int* cut_rows, const int* cut_ptr,
    const void* B, void* out, float* partial, void* stream) {
  return (int)launch<__nv_bfloat16>(
      C, J, K, vec, indptr, indices, vals, chunk_start, chunk_count, row_lo,
      row_hi, head_slot, tail_slot, cut_rows, cut_ptr,
      (const __nv_bfloat16*)B, (__nv_bfloat16*)out, partial,
      (cudaStream_t)stream);
}

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
