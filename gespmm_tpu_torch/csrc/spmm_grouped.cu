// Grouped-gather SpMM for Hopper (sm_90a):
//
//     out[r, :] = sum_{e in row r} val_e * B[col_e, :]      (f32 accumulation)
//
// over the grouped work list of gespmm_tpu_torch/sparse/partition.py::
// build_grouped_plan: row blocks of R rows, each block's nonzeros cut in CSR
// order into chunks of at most E edges and at most NG distinct aligned groups
// of G consecutive B rows (group g = B rows [g*G, g*G + G)).
//
// Replaces gespmm_tpu/kernels/spmm_grouped.py::_grouped_kernel
// (spmm_grouped.py:44, launched by _grouped_call, pallas_call :243), the
// method="pallas" tier over plan="grouped".  On the TPU each grid step DMA'd
// its chunk's distinct groups of B into VMEM once (one descriptor a group,
// which cut the descriptor count, the TPU's binding resource) and reduced the
// chunk on the MXU as (P[R,E] @ Q[E,S]) @ staged[S,K], with a 3-way bf16 split
// of the staged rows for a binary matrix; the grid ran in order, so a block's
// output stayed resident in VMEM across its chunks.
//
// Here the mechanism that sets this kernel apart from the chunk kernel
// (spmm_chunk.cu) is kept: each chunk's distinct groups are staged into shared
// memory ONCE, and every edge reads its B row from there through its slot
// (pos(group) * G + col % G).  One CTA per (chunk, K tile):
//   * staging: all threads of the CTA copy the chunk's edge slots and values,
//     and its group ids, into shared memory; then the chunk's group_count * G
//     B rows, restricted to the tile's columns, with plain vector loads in
//     batches of kStageUnroll (rows past n, the tail of the last group when
//     n % G != 0, are never read, and no edge points at them);
//   * the walk: thread i owns VEC consecutive columns of the K tile and walks
//     the chunk's edges in CSR order, accumulating each row in f32 registers
//     with FMAs from the staged rows.  The MXU triple product and its bf16
//     split were the TPU's way to do this reduction, not the function;
//   * rows cut by a chunk boundary use the chunk kernel's scheme: a row wholly
//     inside the chunk (an empty row too) is written to out directly, a cut
//     row's partial sum goes to its slot of an f32 scratch buffer (head_slot
//     for the chunk's first row when it began in an earlier chunk, tail_slot
//     for its last row when it goes on into a later one), and the carry pass
//     of carry.cuh, one warp per cut row, adds the slots in chunk order.
//     Every output element is written once, without atomics, so the result
//     is bitwise repeatable.  Hopper's CTAs run in no order, so nothing can
//     stay resident across chunks as the TPU's block output did.
//
// Shared memory is set at run time by the plan: NG * G staged rows of KT
// columns.  The caller picks KT so that a CTA fits (two a SM where possible);
// above 48 KiB the launch opts in with cudaFuncSetAttribute.
//
// What bounds it: bytes.  Every nonzero is 2K flops on K-wide rows of B (0.5
// flop per byte in f32), far below the card's ridge point.  The staging moves
// group_count * G rows per chunk, which on the graphs of this repository is
// 4-7 times the rows a per-edge gather moves (only G = 1 stages about one row
// an edge); those bytes mostly come from L2.  Not here yet: tensor cores
// (mma/wgmma over the staged tile, as the TPU used its MXU), TMA or cp.async
// staging overlapped with the walk, several chunks a CTA.
//
// Plain C interface, loaded with ctypes.  The caller picks VEC (1, 2 or 4;
// K % VEC == 0, KT % VEC == 0, and B, out, partial aligned to VEC elements).
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it does
// not take.

#include "carry.cuh"

namespace {

using namespace gespmm;  // the type helpers and the carry pass

constexpr int kMinThreads = 128;         // staging threads of a narrow tile
constexpr int kStageUnroll = 4;          // loads in flight per staging thread
constexpr size_t kDefaultSmem = 48 * 1024;

// Bytes of the shared-memory header: the chunk's edge slots and values (E
// each) and its group ids (NG), rounded up so the staged rows start aligned.
__host__ __device__ __forceinline__ size_t header_bytes(int E, int NG) {
  return ((size_t)(2 * E + NG) * 4 + 15) / 16 * 16;
}

// Where a finished row's sum goes: its slot of the scratch buffer when the
// row is cut at this chunk's start (head) or end (tail), else out.
template <typename T, int VEC>
__device__ __forceinline__ void flush_row(float (&acc)[VEC], int r, int rs,
                                          int re, int s, int t, int head,
                                          int tail, int K, int k,
                                          T* __restrict__ out,
                                          float* __restrict__ partial) {
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
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
}

template <typename T, int VEC, bool HAS_VALS>
__global__ void spmm_grouped_kernel(
    int n, int K, int KT, int E, int NG, int G, const int* __restrict__ indptr,
    const float* __restrict__ vals, const int* __restrict__ chunk_start,
    const int* __restrict__ chunk_count, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const int* __restrict__ head_slot,
    const int* __restrict__ tail_slot, const int* __restrict__ groups,
    const int* __restrict__ group_count, const int* __restrict__ slots,
    const T* __restrict__ B, T* __restrict__ out,
    float* __restrict__ partial) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_slot = reinterpret_cast<int*>(smem);
  float* s_val = reinterpret_cast<float*>(smem + (size_t)E * 4);
  int* s_grp = reinterpret_cast<int*>(smem + (size_t)E * 8);
  T* staged = reinterpret_cast<T*>(smem + header_bytes(E, NG));

  const int c = blockIdx.x;
  const int k0 = blockIdx.y * KT;
  const int lanes = min(KT, K - k0) / VEC;  // threads owning a column pack
  const int s = chunk_start[c];
  const int cnt = chunk_count[c];
  const int ng = group_count[c];

  // 1. The chunk's edge slots and values, and its group ids.
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    s_slot[i] = __ldg(slots + s + i);
    if (HAS_VALS) s_val[i] = __ldg(vals + s + i);
  }
  for (int i = threadIdx.x; i < ng; i += blockDim.x)
    s_grp[i] = __ldg(groups + (int64_t)c * NG + i);
  __syncthreads();

  // 2. Its groups' B rows, columns [k0, k0 + lanes * VEC): staged row j is B
  // row s_grp[j / G] * G + j % G.  Each thread keeps kStageUnroll loads in
  // flight before it stores them.
  const int total = ng * G * lanes;
  for (int base = threadIdx.x; base < total;
       base += kStageUnroll * blockDim.x) {
    P v[kStageUnroll];
    int dst[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = base + u * blockDim.x;
      dst[u] = -1;
      if (i < total) {
        const int j = i / lanes, l = i - j * lanes;
        const int g = j / G;
        const int brow = s_grp[g] * G + (j - g * G);
        if (brow < n) {
          v[u] = *reinterpret_cast<const P*>(B + (int64_t)brow * K + k0 +
                                             l * VEC);
          dst[u] = j * KT + l * VEC;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u)
      if (dst[u] >= 0) *reinterpret_cast<P*>(staged + dst[u]) = v[u];
  }
  __syncthreads();

  // 3. The walk: thread i owns columns k .. k + VEC - 1 of the tile.
  const int tid = threadIdx.x;
  if (tid >= lanes) return;  // no barrier below
  const int k = k0 + tid * VEC;
  const int t = s + cnt;
  const int head = head_slot[c], tail = tail_slot[c];
  const int r_hi = row_hi[c];
  int r = row_lo[c];
  int rs = __ldg(indptr + r), re = __ldg(indptr + r + 1);
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int e = s; e < t; ++e) {
    // Finish every row that ends before this edge (empty rows too).
    while (e >= re) {
      flush_row<T, VEC>(acc, r, rs, re, s, t, head, tail, K, k, out, partial);
      ++r;
      rs = re;
      re = __ldg(indptr + r + 1);
    }
    const float v = HAS_VALS ? s_val[e - s] : 1.f;
    const P p = *reinterpret_cast<const P*>(staged + s_slot[e - s] * KT +
                                            tid * VEC);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(v, to_f32(p.v[i]), acc[i]);
  }
  // The row holding the chunk's last edge, then the empty rows the chunk
  // owns after it (a block's trailing empty rows, or a chunk without edges).
  for (;;) {
    flush_row<T, VEC>(acc, r, rs, re, s, t, head, tail, K, k, out, partial);
    if (++r > r_hi) break;
    rs = re;
    re = __ldg(indptr + r + 1);
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(int C, int J, int n, int K, int KT, int E, int NG,
                       int G, const int* indptr, const float* vals,
                       const int* chunk_start, const int* chunk_count,
                       const int* row_lo, const int* row_hi,
                       const int* head_slot, const int* tail_slot,
                       const int* cut_rows, const int* cut_ptr,
                       const int* groups, const int* group_count,
                       const int* slots, const T* B, T* out, float* partial,
                       cudaStream_t stream) {
  if (K % VEC != 0 || KT % VEC != 0 || KT < VEC || KT / VEC > 1024 ||
      (uintptr_t)B % (VEC * sizeof(T)) != 0 ||
      (uintptr_t)out % (VEC * sizeof(T)) != 0 ||
      (J > 0 && (uintptr_t)partial % (VEC * sizeof(float)) != 0))
    return cudaErrorInvalidValue;
  const size_t smem =
      header_bytes(E, NG) + (size_t)NG * G * KT * sizeof(T);
  const int lanes = KT / VEC;
  const int threads =
      lanes > kMinThreads ? (lanes + 31) / 32 * 32 : kMinThreads;
  void (*kernel)(int, int, int, int, int, int, const int*, const float*,
                 const int*, const int*, const int*, const int*, const int*,
                 const int*, const int*, const int*, const int*, const T*, T*,
                 float*) =
      vals != nullptr ? spmm_grouped_kernel<T, VEC, true>
                      : spmm_grouped_kernel<T, VEC, false>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)C, (unsigned)((K + KT - 1) / KT));
  kernel<<<grid, threads, smem, stream>>>(
      n, K, KT, E, NG, G, indptr, vals, chunk_start, chunk_count, row_lo,
      row_hi, head_slot, tail_slot, groups, group_count, slots, B, out,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || J == 0) return err;
  return launch_carry<T, VEC>(J, K, cut_rows, cut_ptr, partial, out, stream);
}

template <typename T>
cudaError_t launch(int C, int J, int n, int K, int KT, int vec, int E, int NG,
                   int G, const int* indptr, const float* vals,
                   const int* chunk_start, const int* chunk_count,
                   const int* row_lo, const int* row_hi, const int* head_slot,
                   const int* tail_slot, const int* cut_rows,
                   const int* cut_ptr, const int* groups,
                   const int* group_count, const int* slots, const T* B,
                   T* out, float* partial, cudaStream_t stream) {
  switch (vec) {
    case 4:
      return launch_vec<T, 4>(C, J, n, K, KT, E, NG, G, indptr, vals,
                              chunk_start, chunk_count, row_lo, row_hi,
                              head_slot, tail_slot, cut_rows, cut_ptr, groups,
                              group_count, slots, B, out, partial, stream);
    case 2:
      return launch_vec<T, 2>(C, J, n, K, KT, E, NG, G, indptr, vals,
                              chunk_start, chunk_count, row_lo, row_hi,
                              head_slot, tail_slot, cut_rows, cut_ptr, groups,
                              group_count, slots, B, out, partial, stream);
    case 1:
      return launch_vec<T, 1>(C, J, n, K, KT, E, NG, G, indptr, vals,
                              chunk_start, chunk_count, row_lo, row_hi,
                              head_slot, tail_slot, cut_rows, cut_ptr, groups,
                              group_count, slots, B, out, partial, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C >= 1 chunks, K >= 1, m >= 1 and n >= 1 (the caller returns early
// otherwise); KT the K tile (a multiple of vec), E the most edges a chunk,
// NG the groups array's row width, G the group rows; J cut rows (the carry
// pass runs only for J > 0) with partial a (cut_ptr[J], K) f32 scratch
// buffer; vals may be null (implicit 1.0).
extern "C" int gespmm_spmm_grouped_f32(
    int C, int J, int n, int K, int KT, int vec, int E, int NG, int G,
    const int* indptr, const float* vals, const int* chunk_start,
    const int* chunk_count, const int* row_lo, const int* row_hi,
    const int* head_slot, const int* tail_slot, const int* cut_rows,
    const int* cut_ptr, const int* groups, const int* group_count,
    const int* slots, const float* B, float* out, float* partial,
    void* stream) {
  return (int)launch<float>(C, J, n, K, KT, vec, E, NG, G, indptr, vals,
                            chunk_start, chunk_count, row_lo, row_hi,
                            head_slot, tail_slot, cut_rows, cut_ptr, groups,
                            group_count, slots, B, out, partial,
                            (cudaStream_t)stream);
}

extern "C" int gespmm_spmm_grouped_bf16(
    int C, int J, int n, int K, int KT, int vec, int E, int NG, int G,
    const int* indptr, const float* vals, const int* chunk_start,
    const int* chunk_count, const int* row_lo, const int* row_hi,
    const int* head_slot, const int* tail_slot, const int* cut_rows,
    const int* cut_ptr, const int* groups, const int* group_count,
    const int* slots, const void* B, void* out, float* partial,
    void* stream) {
  return (int)launch<__nv_bfloat16>(
      C, J, n, K, KT, vec, E, NG, G, indptr, vals, chunk_start, chunk_count,
      row_lo, row_hi, head_slot, tail_slot, cut_rows, cut_ptr, groups,
      group_count, slots, (const __nv_bfloat16*)B, (__nv_bfloat16*)out,
      partial, (cudaStream_t)stream);
}

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
