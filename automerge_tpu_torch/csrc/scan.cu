// Prefix-scan kernels for the text engine (sm_90a), bound through ctypes.
//
// Replaces the two Pallas TPU kernels of automerge_tpu/ops/scan_pallas.py:
//   multi_scan           (_multi_scan_kernel, scan_pallas.py:170-215)
//   fused_segment_scans  (_fused_kernel,      scan_pallas.py:76-167)
//
// The TPU versions walk (8, 128) tiles on a grid that runs IN ORDER on one
// core and carry the running totals across grid steps in SMEM. Hopper
// blocks run in no order, so each scan here is reduce-then-scan in three
// launches:
//   1. every block reduces its chunk of kChunk elements to one total
//      (per row for multi_scan; a (sum, max, sum) triple for the segment
//      scans);
//   2. one block per row scans those totals in place (inclusive);
//   3. every block re-reads its chunk, scans it with warp shuffles and a
//      cross-warp step in shared memory, and adds the inclusive total of
//      the blocks before it.
// Any length works: the ragged edge of the last chunk is masked.
//
// What bounds them on an H100: both move bytes and do almost no
// arithmetic (one add or max per element), so the floor is HBM traffic —
// multi_scan reads and writes 4 bytes per element per row, the segment
// scans read 2 bytes and write 12. Phases 1 and 3 each stream the input
// (the first read is usually still in the 50 MB L2 for the sizes the
// engine uses), so this design pays about one extra read over the bound.
// Loads are coalesced (consecutive threads on consecutive elements in
// every round). A single-pass decoupled look-back scan with 16-byte loads
// would remove the extra read and two launches; that is later work.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                   // block-strided rounds per chunk
constexpr int kChunk = kThreads * kRounds;    // elements per block
constexpr unsigned kFull = 0xffffffffu;

struct SumOp {
  __device__ __forceinline__ static int apply(int a, int b) { return a + b; }
  __device__ __forceinline__ static int identity() { return 0; }
};

// The segment-head candidates are slot numbers >= 1 or 0, and the TPU
// kernel's carry starts at 0, so 0 is the identity of this max.
struct MaxOp {
  __device__ __forceinline__ static int apply(int a, int b) {
    return a > b ? a : b;
  }
  __device__ __forceinline__ static int identity() { return 0; }
};

template <class Op>
__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = Op::apply(v, n);
  }
  return v;
}

// Inclusive scan of one value per thread across the block. Returns the
// thread's inclusive prefix and stores the block total in *total.
// `sh` holds kWarps ints; the trailing barrier lets the caller reuse it.
template <class Op>
__device__ __forceinline__ int block_inclusive_scan(int v, int* sh,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  v = warp_inclusive_scan<Op>(v, lane);
  if (lane == 31) sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int w = lane < kWarps ? sh[lane] : Op::identity();
    w = warp_inclusive_scan<Op>(w, lane);
    if (lane < kWarps) sh[lane] = w;
  }
  __syncthreads();
  if (wid > 0) v = Op::apply(v, sh[wid - 1]);
  *total = sh[kWarps - 1];
  __syncthreads();
  return v;
}

template <class Op>
__device__ __forceinline__ int block_reduce(int v, int* sh) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = Op::apply(v, __shfl_xor_sync(kFull, v, off));
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  int t = Op::identity();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t = Op::apply(t, sh[w]);
  __syncthreads();
  return t;
}

// Phase 2, shared by both scans: in-place inclusive scan of `nblk`
// per-block totals, one block per row (blockIdx.x).
template <class Op>
__device__ void scan_totals_row(int* tot, int nblk) {
  __shared__ int sh[kWarps];
  int carry = Op::identity();
  for (int s = 0; s < nblk; s += kThreads) {
    const int i = s + threadIdx.x;
    const int v = i < nblk ? tot[i] : Op::identity();
    int total;
    const int incl = block_inclusive_scan<Op>(v, sh, &total);
    if (i < nblk) tot[i] = Op::apply(carry, incl);
    carry = Op::apply(carry, total);
  }
}

// ---------------------------------------------------------------- multi_scan

__global__ void __launch_bounds__(kThreads)
ms_block_totals(const int* __restrict__ x, int n, int nblk,
                int* __restrict__ tot) {
  __shared__ int sh[kWarps];
  const int row = blockIdx.y;
  const int* xr = x + (size_t)row * n;
  const int start = blockIdx.x * kChunk;
  int acc = 0;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const int i = start + r * kThreads + threadIdx.x;
    if (i < n) acc += xr[i];
  }
  acc = block_reduce<SumOp>(acc, sh);
  if (threadIdx.x == 0) tot[(size_t)row * nblk + blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
ms_scan_totals(int* tot, int nblk) {
  scan_totals_row<SumOp>(tot + (size_t)blockIdx.x * nblk, nblk);
}

__global__ void __launch_bounds__(kThreads)
ms_scan_blocks(const int* __restrict__ x, int* __restrict__ y, int n,
               int nblk, const int* __restrict__ tot) {
  __shared__ int sh[kWarps];
  const int row = blockIdx.y;
  const int* xr = x + (size_t)row * n;
  int* yr = y + (size_t)row * n;
  const int start = blockIdx.x * kChunk;
  int carry = blockIdx.x > 0 ? tot[(size_t)row * nblk + blockIdx.x - 1] : 0;
  for (int r = 0; r < kRounds; ++r) {
    const int base = start + r * kThreads;
    if (base >= n) break;                     // uniform across the block
    const int i = base + threadIdx.x;
    const int v = i < n ? xr[i] : 0;
    int total;
    const int incl = block_inclusive_scan<SumOp>(v, sh, &total);
    if (i < n) yr[i] = carry + incl;
    carry += total;
  }
}

// ------------------------------------------------------- fused_segment_scans

struct SegBits {
  int seg_start;   // slot starts a segment: a live element whose chain bit is clear
  int vis;         // slot is a live element holding a value
  int cand;        // the slot number if it starts a segment, else 0
};

__device__ __forceinline__ SegBits seg_bits(const unsigned char* chain,
                                            const unsigned char* has, int i,
                                            int n, int n_elems, int base) {
  SegBits b{0, 0, 0};
  if (i < n) {
    const int flat = base + i;               // global slot number
    const bool is_elem = flat >= 1 && flat <= n_elems;
    b.seg_start = (is_elem && !chain[i]) ? 1 : 0;
    b.vis = (is_elem && has[i]) ? 1 : 0;
    b.cand = b.seg_start ? flat : 0;
  }
  return b;
}

__global__ void __launch_bounds__(kThreads)
fs_block_totals(const unsigned char* __restrict__ chain,
                const unsigned char* __restrict__ has, int n,
                const int* __restrict__ n_elems_p, int base, int nblk,
                int* __restrict__ tot) {
  __shared__ int sh[kWarps];
  const int n_elems = *n_elems_p;
  const int start = blockIdx.x * kChunk;
  int rank = 0, head = 0, vis = 0;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const SegBits b = seg_bits(chain, has, start + r * kThreads + threadIdx.x,
                               n, n_elems, base);
    rank += b.seg_start;
    head = MaxOp::apply(head, b.cand);
    vis += b.vis;
  }
  rank = block_reduce<SumOp>(rank, sh);
  head = block_reduce<MaxOp>(head, sh);
  vis = block_reduce<SumOp>(vis, sh);
  if (threadIdx.x == 0) {
    tot[blockIdx.x] = rank;
    tot[nblk + blockIdx.x] = head;
    tot[2 * nblk + blockIdx.x] = vis;
  }
}

__global__ void __launch_bounds__(kThreads)
fs_scan_totals(int* tot, int nblk) {
  int* row = tot + (size_t)blockIdx.x * nblk;
  if (blockIdx.x == 1)
    scan_totals_row<MaxOp>(row, nblk);
  else
    scan_totals_row<SumOp>(row, nblk);
}

__global__ void __launch_bounds__(kThreads)
fs_scan_blocks(const unsigned char* __restrict__ chain,
               const unsigned char* __restrict__ has, int n,
               const int* __restrict__ n_elems_p, int base, int nblk,
               const int* __restrict__ tot, int* __restrict__ rank_out,
               int* __restrict__ head_out, int* __restrict__ vis_out) {
  __shared__ int sh_rank[kWarps];
  __shared__ int sh_head[kWarps];
  __shared__ int sh_vis[kWarps];
  const int n_elems = *n_elems_p;
  const int b = blockIdx.x;
  const int start = b * kChunk;
  int c_rank = b > 0 ? tot[b - 1] : 0;
  int c_head = b > 0 ? tot[nblk + b - 1] : 0;
  int c_vis = b > 0 ? tot[2 * nblk + b - 1] : 0;
  for (int r = 0; r < kRounds; ++r) {
    const int rbase = start + r * kThreads;
    if (rbase >= n) break;                    // uniform across the block
    const int i = rbase + threadIdx.x;
    const SegBits bits = seg_bits(chain, has, i, n, n_elems, base);
    int t_rank, t_head, t_vis;
    const int s_rank = block_inclusive_scan<SumOp>(bits.seg_start, sh_rank,
                                                   &t_rank);
    const int s_head = block_inclusive_scan<MaxOp>(bits.cand, sh_head,
                                                   &t_head);
    const int s_vis = block_inclusive_scan<SumOp>(bits.vis, sh_vis, &t_vis);
    if (i < n) {
      rank_out[i] = c_rank + s_rank;
      head_out[i] = MaxOp::apply(c_head, s_head);
      vis_out[i] = c_vis + s_vis;
    }
    c_rank += t_rank;
    c_head = MaxOp::apply(c_head, t_head);
    c_vis += t_vis;
  }
}

inline int num_chunks(int n) { return (n + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

// Elements each block of phases 1 and 3 covers; the caller sizes the
// scratch totals as ceil(n / chunk) ints per row.
int amt_scan_chunk() { return kChunk; }

// y[k, :] = inclusive prefix sum of x[k, :], int32 (K, N) row-major.
// scratch: int32[K * ceil(N / chunk)].
int amt_multi_scan(const void* x, void* y, void* scratch, int k, int n,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = num_chunks(n);
  int* tot = static_cast<int*>(scratch);
  dim3 grid(nblk, k);
  ms_block_totals<<<grid, kThreads, 0, s>>>(static_cast<const int*>(x), n,
                                            nblk, tot);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ms_scan_totals<<<k, kThreads, 0, s>>>(tot, nblk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ms_scan_blocks<<<grid, kThreads, 0, s>>>(static_cast<const int*>(x),
                                           static_cast<int*>(y), n, nblk, tot);
  return static_cast<int>(cudaGetLastError());
}

// (rank_incl, seg_head, cumvis) of bool chain/has_value columns of
// length n; n_elems is read on the device from an int32 scalar.
// scratch: int32[3 * ceil(n / chunk)].
int amt_fused_segment_scans(const void* chain, const void* has, int n,
                            const void* n_elems, int base, void* scratch,
                            void* rank, void* head, void* cumvis,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = num_chunks(n);
  int* tot = static_cast<int*>(scratch);
  const unsigned char* c = static_cast<const unsigned char*>(chain);
  const unsigned char* h = static_cast<const unsigned char*>(has);
  const int* ne = static_cast<const int*>(n_elems);
  fs_block_totals<<<nblk, kThreads, 0, s>>>(c, h, n, ne, base, nblk, tot);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fs_scan_totals<<<3, kThreads, 0, s>>>(tot, nblk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fs_scan_blocks<<<nblk, kThreads, 0, s>>>(
      c, h, n, ne, base, nblk, tot, static_cast<int*>(rank),
      static_cast<int*>(head), static_cast<int*>(cumvis));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
