// Grouped-gather SpMM for Hopper (sm_90a):
//
//     out[r, :] = sum_{e in row r} val_e * B[col_e, :]      (f32 accumulation)
//
// over the grouped work list of gespmm_tpu_torch/sparse/partition.py::
// build_grouped_plan: row blocks of R rows, each block's nonzeros cut in CSR
// order into chunks of at most E edges and at most NG distinct aligned groups
// of G consecutive B rows.
//
// Replaces gespmm_tpu/kernels/spmm_grouped.py::_grouped_kernel
// (spmm_grouped.py:44, launched by _grouped_call, pallas_call :243), the
// method="pallas" tier over plan="grouped".  On the TPU each grid step DMA'd
// its chunk's distinct groups of B into VMEM once (one descriptor a group,
// which cut the descriptor count, that chip's binding resource) and reduced
// the chunk on the MXU as (P[R,E] @ Q[E,S]) @ staged[S,K]; the grid ran in
// order, so a block's output stayed resident in VMEM across its chunks.
//
// What bounds it here: bytes, from L2 (B fits the 50 MB L2 at the repo's
// shapes).  Every nonzero is 2K flops on K-wide rows of B (0.5 flop per byte
// in f32), far below the card's ridge point, so the design moves as few bytes
// as it can and keeps many of them in flight:
//   * a chunk stages only the B rows its edges reference (the plan's
//     ref_rows, derived on the host from its groups and slots), each once:
//     about one row an edge at the defaults, where whole groups staged 4-7;
//   * a persistent CTA walks the work items (chunk, K tile) c, c + gridDim.x,
//     ... through a ring of NS (2 or 3) shared-memory stages.  Producer warps
//     fill the stages with cp.async (16-byte .cg copies where the row
//     slices are 16-byte aligned): they load the next item's metadata while
//     they issue the current one's copies, and signal each stage's "full"
//     mbarrier when their copies land; they refill a stage once the consumers
//     have arrived on its "empty" mbarrier.  So the producers' chains of
//     dependent loads (chunk -> its referenced rows -> the copies) stay off
//     the walk, and NS - 1 items' rows, edge slots, values and row offsets
//     land while the consumers walk one;
//   * every consumer thread walks: thread t owns column t of the K tile (the
//     consumer warps hold the tile's width, rounded up to a warp) and walks
//     the chunk's rows in order, each row's edges reading their staged row
//     through their slot, with f32 FMAs.  The MXU triple product was the
//     TPU's way to do this reduction, not the function: at 2 flops for 4-8
//     bytes staged, tensor cores would wait on the same staging;
//   * rows cut by a chunk boundary use the chunk kernel's scheme: a row wholly
//     inside the chunk (an empty row too) is written to out directly, a cut
//     row's partial sum goes to its slot of an f32 scratch buffer (head_slot
//     for the chunk's first row when it began in an earlier chunk, tail_slot
//     for its last row when it goes on into a later one), and the carry pass
//     of carry.cuh, one warp per cut row, adds the slots in chunk order.
//     Every output element is written once, by one thread, without atomics,
//     so the result is bitwise repeatable.
// On the card the producers bound it: its time falls as producer warps, and
// CTAs (narrower K tiles), are added, each item a chain of dependent loads
// (PERF.md, PR 7).  The wrapper launches the best the card measured.
//
// A stage holds the chunk's header (six scalars, the R + 1 row offsets of its
// rows, its edges' slots and values) and max_refs staged rows of KT columns;
// the caller picks KT and NS so that NS stages fit a CTA (two CTAs an SM where
// possible); above 48 KiB the launch opts in with cudaFuncSetAttribute.
//
// Plain C interface, loaded with ctypes.  cw is the staging copy's width in
// bytes (16, 8, 4; 2 for a bf16 B with odd K, copied with plain loads and
// stores): K and KT times the element size, and B's address, are multiples of
// it.  The entry point launches on the given stream, does not synchronise,
// and returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// does not take.

#include "carry.cuh"

namespace {

using namespace gespmm;  // the type helpers and the carry pass

constexpr int kMaxCols = 256;  // K-tile columns: one consumer thread each
constexpr int kScalars = 8;    // header ints before the row offsets
constexpr int kBarrierBytes = 64;  // the 2 * NS mbarriers, before stage 0
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Bytes of a stage's header: six scalars (two spare ints), the chunk's R + 1
// row offsets, and its E edge slots and E values.
__host__ __device__ __forceinline__ size_t header_bytes(int E, int R) {
  return align16((size_t)(kScalars + R + 1 + 2 * E) * 4);
}

template <typename T>
__host__ __device__ __forceinline__ size_t stage_bytes(int E, int R,
                                                       int max_refs, int KT) {
  return header_bytes(E, R) + align16((size_t)max_refs * KT * sizeof(T));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int cw) {
  const unsigned s = smem_addr(dst);
  switch (cw) {
    case 16:  // L2 only: the staged rows are read once from shared memory
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
      break;
    default:  // 2 bytes: below cp.async's smallest copy
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// A plain arrive (release: this thread's earlier shared-memory reads and
// writes are ordered before the phase completes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// The phase also waits for this thread's cp.async copies issued so far.
__device__ __forceinline__ void mbar_track_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait (acquire) until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

struct Args {
  int items, ntiles, K, KT, E, R, max_refs, NS, cw, producers;
  const int* indptr;
  const float* vals;
  const int* chunk_start;
  const int* chunk_count;
  const int* row_lo;
  const int* row_hi;
  const int* head_slot;
  const int* tail_slot;
  const int* ref_ptr;
  const int* ref_rows;
  const int* ref_slot;
  float* partial;
};

// What the producer needs of a work item before it can issue its copies.
struct Item {
  int c, k0, width, s, cnt, r_lo, r_hi, ref0, nref;
};

__device__ __forceinline__ Item load_item(const Args& a, int i) {
  Item it{};
  if (i >= a.items) return it;
  it.c = i / a.ntiles;
  it.k0 = (i - it.c * a.ntiles) * a.KT;
  it.width = min(a.KT, a.K - it.k0);
  it.s = __ldg(a.chunk_start + it.c);
  it.cnt = __ldg(a.chunk_count + it.c);
  it.r_lo = __ldg(a.row_lo + it.c);
  it.r_hi = __ldg(a.row_hi + it.c);
  it.ref0 = __ldg(a.ref_ptr + it.c);
  it.nref = __ldg(a.ref_ptr + it.c + 1) - it.ref0;
  return it;
}

// Producer warp pw of a.producers: issue its share of the copies of item
// ``it`` into its stage.
template <typename T, bool HAS_VALS>
__device__ __forceinline__ void issue(const Args& a, unsigned char* stage,
                                      const Item& it, int pw,
                                      const T* __restrict__ B) {
  const int lane = threadIdx.x & 31;
  const int P = a.producers;
  const int pl = pw * 32 + lane, lanes = P * 32;  // over the producer warps
  int* h = reinterpret_cast<int*>(stage);
  if (pl < 6) {
    const int* src = pl == 0   ? a.chunk_start
                     : pl == 1 ? a.chunk_count
                     : pl == 2 ? a.row_lo
                     : pl == 3 ? a.row_hi
                     : pl == 4 ? a.head_slot
                               : a.tail_slot;
    cp_async(h + pl, src + it.c, 4);
  }
  int* rowptr = h + kScalars;
  for (int q = pl; q < it.r_hi - it.r_lo + 2; q += lanes)
    cp_async(rowptr + q, a.indptr + it.r_lo + q, 4);
  int* slot = rowptr + a.R + 1;
  float* val = reinterpret_cast<float*>(slot + a.E);
  for (int q = pl; q < it.cnt; q += lanes) {
    cp_async(slot + q, a.ref_slot + it.s + q, 4);
    if (HAS_VALS) cp_async(val + q, a.vals + it.s + q, 4);
  }
  // The referenced rows, columns [k0, k0 + width): staged row j is B row
  // ref_rows[ref0 + j], in pieces of cw bytes; warp pw stages rows pw,
  // pw + P, ...  Its row ids come 64 at a time, one load a lane, and are
  // broadcast with shuffles; a lane copies piece p of a row, the lanes
  // spread over rows when a row has fewer than 32 pieces.
  unsigned char* staged = stage + header_bytes(a.E, a.R);
  const int pieces = it.width * (int)sizeof(T) / a.cw;
  const size_t pitch = (size_t)a.KT * sizeof(T);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(B + it.k0);
  const int rps = pieces <= 32 ? 32 / pieces : 1;  // rows a step
  const int jr = lane / (pieces <= 32 ? pieces : 32);
  const int p0 = pieces <= 32 ? lane - jr * pieces : lane;
  const int mine = it.nref > pw ? (it.nref - pw + P - 1) / P : 0;
  const int* ids = a.ref_rows + it.ref0 + pw;
  for (int w0 = 0; w0 < mine; w0 += 64) {
    const int nw = min(64, mine - w0);
    const int idA = lane < nw ? __ldg(ids + (w0 + lane) * P) : 0;
    const int idB = lane + 32 < nw ? __ldg(ids + (w0 + lane + 32) * P) : 0;
    for (int jb = 0; jb < nw; jb += rps) {
      const int j = jb + jr;  // this lane's row of the step
      const int bA = __shfl_sync(0xffffffffu, idA, j & 31);
      const int bB = __shfl_sync(0xffffffffu, idB, j & 31);
      if (jr >= rps || j >= nw) continue;
      const int64_t brow = j < 32 ? bA : bB;
      const size_t row = (size_t)pw + (size_t)(w0 + j) * P;
      for (int p = p0; p < pieces; p += 32)
        cp_async(staged + row * pitch + (size_t)p * a.cw,
                 src + (brow * a.K) * (int64_t)sizeof(T) + (size_t)p * a.cw,
                 a.cw);
    }
  }
}

// A consumer thread walks item i from its stage: thread t owns column k0 + t.
template <typename T, bool HAS_VALS>
__device__ __forceinline__ void walk(const Args& a,
                                     const unsigned char* stage, int i,
                                     T* __restrict__ out) {
  const int c = i / a.ntiles;
  const int k0 = (i - c * a.ntiles) * a.KT;
  const int t = threadIdx.x;
  if (t >= min(a.KT, a.K - k0)) return;
  const int k = k0 + t;
  const int* h = reinterpret_cast<const int*>(stage);
  const int s = h[0], e_end = h[0] + h[1], r_lo = h[2], r_hi = h[3];
  const int head = h[4], tail = h[5];
  const int* rowptr = h + kScalars;  // rowptr[q] = indptr[r_lo + q]
  const int* slot = rowptr + a.R + 1;
  const float* val = reinterpret_cast<const float*>(slot + a.E);
  const T* col = reinterpret_cast<const T*>(stage + header_bytes(a.E, a.R)) + t;
  for (int q = 0; q <= r_hi - r_lo; ++q) {
    const int rs = rowptr[q], re = rowptr[q + 1];
    const int lo = max(rs, s) - s, hi = min(re, e_end) - s;
    float acc = 0.f;
#pragma unroll 4
    for (int e = lo; e < hi; ++e) {
      const float v = HAS_VALS ? val[e] : 1.f;
      acc = fmaf(v, to_f32(col[slot[e] * a.KT]), acc);
    }
    if (rs < s || re > e_end)  // cut at the chunk's start or end
      a.partial[(int64_t)(rs < s ? head : tail) * a.K + k] = acc;
    else
      out[(int64_t)(r_lo + q) * a.K + k] = from_f32<T>(acc);
  }
}

// Threads [0, consumers) walk; the last a.producers warps produce.  Shared
// memory: the NS "full" and NS "empty" mbarriers, then the NS stages.
template <typename T, bool HAS_VALS>
__global__ void spmm_grouped_kernel(Args a, const T* __restrict__ B,
                                    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + a.NS;
  unsigned char* stages = smem + kBarrierBytes;
  const size_t sb = stage_bytes<T>(a.E, a.R, a.max_refs, a.KT);
  const int consumers = blockDim.x - 32 * a.producers;
  if (threadIdx.x == 0) {
    for (int st = 0; st < a.NS; ++st) {
      mbar_init(full + st, 32 * a.producers);  // the producers' lanes
      mbar_init(empty + st, consumers / 32);  // one arrive a consumer warp
    }
  }
  __syncthreads();  // the only CTA-wide barrier: the roles part here
  if (threadIdx.x >= consumers) {
    const int pw = (threadIdx.x - consumers) >> 5;
    Item cur = load_item(a, blockIdx.x);
    for (int it = 0;; ++it) {
      const int i = blockIdx.x + it * gridDim.x;
      if (i >= a.items) break;
      // The next item's metadata loads fly while this one's copies issue.
      const Item next = load_item(a, i + gridDim.x);
      const int st = it % a.NS;
      // Before refilling, wait for the walk of the item NS back.
      if (it >= a.NS) mbar_wait(empty + st, ((it / a.NS) + 1) & 1);
      issue<T, HAS_VALS>(a, stages + st * sb, cur, pw, B);
      mbar_track_copies(full + st);
      mbar_arrive(full + st);
      cur = next;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  for (int it = 0;; ++it) {
    const int i = blockIdx.x + it * gridDim.x;
    if (i >= a.items) break;
    const int st = it % a.NS;
    mbar_wait(full + st, (it / a.NS) & 1);
    walk<T, HAS_VALS>(a, stages + st * sb, i, out);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + st);
  }
}

template <typename T>
cudaError_t launch(Args a, int J, int carry_vec, const int* cut_rows,
                   const int* cut_ptr, const T* B, T* out,
                   cudaStream_t stream) {
  const int cw = a.cw;
  if (a.KT < 1 || a.KT > kMaxCols || a.NS < 2 || a.NS > 3 ||
      a.producers < 1 || a.producers > 4 ||
      !(cw == 16 || cw == 8 || cw == 4 || (cw == 2 && sizeof(T) == 2)) ||
      (a.K * sizeof(T)) % cw != 0 || (a.KT * sizeof(T)) % cw != 0 ||
      (uintptr_t)B % cw != 0 || a.max_refs > a.E ||
      (J > 0 && (uintptr_t)a.partial % (carry_vec * sizeof(float)) != 0))
    return cudaErrorInvalidValue;
  const size_t smem =
      kBarrierBytes + a.NS * stage_bytes<T>(a.E, a.R, a.max_refs, a.KT);
  // consumers, then producers
  const int threads = (a.KT + 31) / 32 * 32 + 32 * a.producers;
  void (*kernel)(Args, const T*, T*) =
      a.vals != nullptr ? spmm_grouped_kernel<T, true>
                        : spmm_grouped_kernel<T, false>;
  cudaError_t err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = min(a.items, per_sm * sms);  // persistent CTAs
  kernel<<<blocks, threads, smem, stream>>>(a, B, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || J == 0) return err;
  switch (carry_vec) {
    case 4:
      return launch_carry<T, 4>(J, a.K, cut_rows, cut_ptr, a.partial, out,
                                stream);
    case 2:
      return launch_carry<T, 2>(J, a.K, cut_rows, cut_ptr, a.partial, out,
                                stream);
    case 1:
      return launch_carry<T, 1>(J, a.K, cut_rows, cut_ptr, a.partial, out,
                                stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C >= 1 chunks, K >= 1 (the caller returns early otherwise); KT the K tile
// (at most 256 columns), NS the stages (2 or 3), P the producer warps (1 to
// 4), cw the copy width, E the
// most edges a chunk, R the rows a block, max_refs the most referenced rows a
// chunk; J cut rows (the carry pass, at carry_vec columns a lane, runs only
// for J > 0) with partial a (cut_ptr[J], K) f32 scratch buffer; vals may be
// null (implicit 1.0).
#define GESPMM_GROUPED_ENTRY(NAME, T)                                         \
  extern "C" int NAME(                                                        \
      int C, int J, int K, int KT, int NS, int P, int cw, int carry_vec,      \
      int E, int R, int max_refs, const int* indptr, const float* vals,       \
      const int* chunk_start, const int* chunk_count, const int* row_lo,      \
      const int* row_hi, const int* head_slot, const int* tail_slot,          \
      const int* cut_rows, const int* cut_ptr, const int* ref_ptr,            \
      const int* ref_rows, const int* ref_slot, const void* B, void* out,     \
      float* partial, void* stream) {                                         \
    if (C < 1 || K < 1 || KT < 1) return (int)cudaErrorInvalidValue;          \
    const int ntiles = (K + KT - 1) / KT;                                     \
    Args a{C * ntiles, ntiles,      K,           KT,      E,                  \
           R,          max_refs,    NS,          cw,      P,                  \
           indptr,     vals,        chunk_start, chunk_count, row_lo,         \
           row_hi,     head_slot,   tail_slot,   ref_ptr, ref_rows,           \
           ref_slot,   partial};                                              \
    return (int)launch<T>(a, J, carry_vec, cut_rows, cut_ptr, (const T*)B,    \
                          (T*)out, (cudaStream_t)stream);                     \
  }

GESPMM_GROUPED_ENTRY(gespmm_spmm_grouped_f32, float)
GESPMM_GROUPED_ENTRY(gespmm_spmm_grouped_bf16, __nv_bfloat16)

extern "C" const char* gespmm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
