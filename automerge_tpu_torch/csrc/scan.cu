// Prefix-scan kernels for the text engine (sm_90a), bound through ctypes.
//
// Replaces the Pallas TPU kernels of automerge_tpu/ops/scan_pallas.py:
//   multi_scan           (_multi_scan_kernel, scan_pallas.py:170-215,
//                         pallas_call at :204)
//   fused_segment_scans  (_fused_kernel, scan_pallas.py:76-167,
//                         pallas_call at :142)
//   sharded_fused_scans  (scan_pallas.py:218-266: per-shard
//                         fused_segment_scans + an all_gather of the
//                         shards' totals under shard_map) as the pair
//                         fs_totals + fs_scan with a carry-in, below
//
// What bounds them on an H100: both move bytes and do one add or max per
// element, so the floor is HBM traffic. multi_scan reads and writes 4 bytes
// per element per row: 302 MB at the merge shape (6, 6,291,456), 0.090 ms at
// 3.35 TB/s. The segment scans read 2 bytes (two bool columns) and write 12
// (three int32 columns) per slot: 88 MB at C = 6,291,456, 0.026 ms.
//
// Design: one single-pass launch per call, a chained scan with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016). The TPU kernels carry their running
// totals across a grid that runs in order; Hopper blocks run in no order,
// so each block here
//   1. takes its tile from a ticket (atomicAdd on a counter in the
//      scratch), so every tile before it has already started and the
//      look-back below never waits on a block that was never scheduled;
//   2. loads its tile once with 16-byte loads (multi_scan: int4 loads in
//      striped order, moved through shared memory to BLOCKED order, kItems
//      consecutive values per thread; segment scans: two uint4 of 16 bools
//      per column per thread, packed into one 32-bit mask per column);
//   3. scans in registers: a serial scan over the thread's items (for the
//      segment scans, popcounts and a count-leading-zeros on the masks), a
//      warp-shuffle scan of the thread totals, one cross-warp step in
//      shared memory;
//   4. publishes its aggregate (flag A), lets warp 0 fold the status words
//      of its predecessors 32 at a time until the first inclusive prefix
//      (flag P), then publishes its own inclusive prefix;
//   5. adds its exclusive prefix and moves the results back through
//      shared memory to striped order, so each warp stores whole
//      contiguous int4 vectors.
// A status word is one 64-bit {flag, value}, written and read whole with
// ld/st.relaxed.gpu, so a reader never sees a flag without its value. The
// segment scans keep six per tile: the (rank, head, vis) aggregate and the
// (rank, head, vis) inclusive prefix, each value in its own word; a reader
// takes a triple only when all three of its words carry their flag.
// Sums run in unsigned arithmetic (wrap-around defined, equal to
// torch.cumsum(..., dtype=torch.int32)); the max of the segment heads has
// identity 0 because its candidates are global slot numbers >= 1, or 0.
//
// The segment scans also take (rows, n) matrices, every row scanned on its
// own with its own element count (the DocSet's per-document
// materialization): a tile's ticket names its row and its place in the
// row, tickets run row after row, and the look-back reads only status
// words of its own row, as multi_scan does for its K rows.
//
// Inputs the 16-byte path cannot take (multi_scan with N % 4 != 0, so that
// a row does not start on 16 bytes; any pointer off 16-byte alignment,
// such as a bool view t[1:]) take a scalar path inside the same kernel,
// chosen by the entry point from the pointers and lengths. The ragged edge
// of the last tile is masked on either path.
//
// Sizes, from one run of scripts/sweep_scan_tiles.py at the merge shapes
// on an H100 80GB HBM3 at 700 W, each call reading its input from HBM
// (PERF.md has the table). multi_scan: 256 threads x 32 int32 (an
// 8,192-column tile, 32 KB of loads in flight per block, 60 registers,
// 4 blocks per SM) took 0.129 ms; 128 x 32 tied (0.130 ms); 512 x 16 took
// 0.138 ms, 256 x 16 0.145 ms and 256 x 8 0.173 ms, because fewer bytes
// in flight per SM leave HBM latency uncovered. Segment scans: 256
// threads x 32 slots (one 32-bit mask per column per thread, 8,192 slots
// per tile, 80 registers, 3 blocks per SM) took 0.038 ms, 128 threads
// 0.039 ms and 64 threads 0.044 ms. Evict-first 16-byte stores (__stcs)
// beat plain ones in both kernels (0.129 vs 0.133 ms, 0.038 vs 0.039 ms).
// TMA bulk copies were not taken: the plain 16-byte loads already pass
// half the bound.
//
// The sharded form (an element column cut into shards, each scanned at its
// own global base) is reduce, exchange, then scan. fs_totals reduces one
// shard's live slots to (segment starts, last segment-start slot or 0,
// visible count) per row: 2 bytes read a slot, integer atomics into an
// int32 (rows, 3) output zeroed first (sums and a max: the result does not
// depend on their order). The caller gathers every shard's totals onto
// each shard's device, (n_shards, rows, 3), without a host sync; fs_scan
// then takes them as a carry-in: the tile 0 of each row folds the earlier
// shards' totals (rank and vis summed, heads maxed, 0 for none, as
// scan_pallas.py:251-258 does) into the inclusive prefix it publishes, so
// the decoupled look-back carries them to every later tile. The pair reads
// the two bool columns twice and writes the three int32 columns once: 16
// bytes a slot against the 14 of one pass (0.0263 ms at C = 6,291,456 on
// an H100 at 3.35 TB/s), plus 12 bytes a row and shard of totals.
//
// The scratch is one 64-bit ticket word plus the status words; the entry
// point zeroes it on the caller's stream (cudaMemsetAsync) before the
// launch, so a reused allocation never shows the flags of an earlier call.
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kMsThreads = 256;
constexpr int kMsItems = 32;                      // int32 per thread
constexpr int kMsTile = kMsThreads * kMsItems;    // columns per tile
constexpr int kFsThreads = 256;
constexpr int kFsItems = 32;                      // slots per thread: one mask
constexpr int kFsTile = kFsThreads * kFsItems;    // slots per tile
constexpr int kFsWords = 6;                       // status words per tile
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kFlagA = 1ull << 32;                // aggregate published
constexpr u64 kFlagP = 2ull << 32;                // inclusive prefix published

static_assert(kMsItems % 4 == 0 && kMsItems >= 4 && kMsItems <= 32,
              "multi_scan items per thread: a multiple of 4, at most 32");
static_assert(kMsThreads % 32 == 0 && kFsThreads % 32 == 0,
              "whole warps");
static_assert(kMsThreads / 32 <= 32 && kFsThreads / 32 <= 32,
              "one warp scans the warp totals");

// ------------------------------------------------------------------ helpers

__device__ __forceinline__ void st_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 ld_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// A 16-byte evict-first store of results no kernel here reads again.
__device__ __forceinline__ void store4(int* p, int4 v) {
  __stcs(reinterpret_cast<int4*>(p), v);
}

// Shared-memory index of int4 vector q: XOR the low three bits with the
// next three, so that 8 threads of a quarter-warp touch 8 distinct 16-byte
// bank groups both in striped order (consecutive q) and in blocked order
// (q = t * (items / 4) + m, items in {4, 8, 16, 32}).
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 3) & 7); }

__device__ __forceinline__ unsigned warp_incl_sum(unsigned v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

__device__ __forceinline__ unsigned warp_incl_max(unsigned v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = max(v, n);
  }
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ unsigned warp_max(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Ticket: the tile this block scans, in the order blocks started.
__device__ __forceinline__ int take_ticket(unsigned* ticket, int* sh) {
  if (threadIdx.x == 0) *sh = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  return *sh;
}

// ---------------------------------------------------------------- multi_scan

// Decoupled look-back of one row, run by one whole warp. `st` is the row's
// status words, `idx` this tile's index in the row, `agg` its aggregate.
// Returns the sum of every tile before it in the row.
__device__ unsigned lookback_sum(u64* st, int idx, unsigned agg, int lane) {
  if (idx == 0) {
    if (lane == 0) st_status(st, kFlagP | agg);
    return 0;
  }
  if (lane == 0) st_status(st + idx, kFlagA | agg);
  unsigned excl = 0;
  for (int p = idx - 1 - lane;; p -= 32) {
    u64 s = kFlagP;                            // before the row: P, value 0
    if (p >= 0) {
      do {
        s = ld_status(st + p);
      } while ((s >> 32) == 0);
    }
    const unsigned pm = __ballot_sync(kFull, (s >> 32) == (kFlagP >> 32));
    const int last = pm ? __ffs(pm) - 1 : 31;  // nearest tile with P
    excl += warp_sum(lane <= last ? static_cast<unsigned>(s) : 0u);
    if (pm) break;
  }
  if (lane == 0) st_status(st + idx, kFlagP | (excl + agg));
  return excl;
}

__global__ void __launch_bounds__(kMsThreads)
ms_scan(const int* __restrict__ x, int* __restrict__ y, int n, int tpr,
        int vec_in, int vec_out, unsigned* ticket, u64* status) {
  constexpr int kWarps = kMsThreads / 32;
  constexpr int kVecs = kMsItems / 4;            // int4 per thread
  __shared__ int4 sh_v[kMsTile / 4];
  __shared__ unsigned sh_w[kWarps];
  __shared__ int sh_tile;
  __shared__ unsigned sh_prefix;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;

  const int tile = take_ticket(ticket, &sh_tile);
  const int row = tile / tpr;
  const int ct = tile - row * tpr;               // tile index in the row
  const int c0 = ct * kMsTile;
  const size_t off = static_cast<size_t>(row) * n + c0;
  const int* xr = x + off;
  int* yr = y + off;
  const int valid = min(kMsTile, n - c0);

  // striped loads: vector q = j * threads + t covers columns 4q .. 4q + 3
  int4 v[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int e = 4 * (j * kMsThreads + t);
    if (vec_in && e + 4 <= valid) {
      v[j] = __ldg(reinterpret_cast<const int4*>(xr + e));
    } else {
      v[j].x = e < valid ? xr[e] : 0;
      v[j].y = e + 1 < valid ? xr[e + 1] : 0;
      v[j].z = e + 2 < valid ? xr[e + 2] : 0;
      v[j].w = e + 3 < valid ? xr[e + 3] : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) sh_v[swz(j * kMsThreads + t)] = v[j];
  __syncthreads();

  // blocked: this thread's kMsItems consecutive columns, scanned serially
  unsigned a[kMsItems];
#pragma unroll
  for (int m = 0; m < kVecs; ++m) {
    const int4 w = sh_v[swz(t * kVecs + m)];
    a[4 * m] = w.x;
    a[4 * m + 1] = w.y;
    a[4 * m + 2] = w.z;
    a[4 * m + 3] = w.w;
  }
#pragma unroll
  for (int k = 1; k < kMsItems; ++k) a[k] += a[k - 1];
  const unsigned total = a[kMsItems - 1];

  const unsigned incl = warp_incl_sum(total, lane);
  if (lane == 31) sh_w[wid] = incl;
  __syncthreads();
  unsigned woff = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned s = sh_w[w];
    woff += w < wid ? s : 0u;
    agg += s;
  }
  if (wid == 0) {
    const unsigned pre = lookback_sum(status + static_cast<size_t>(row) * tpr,
                                      ct, agg, lane);
    if (lane == 0) sh_prefix = pre;
  }
  __syncthreads();
  const unsigned add = sh_prefix + woff + incl - total;

#pragma unroll
  for (int m = 0; m < kVecs; ++m) {
    int4 w;
    w.x = static_cast<int>(a[4 * m] + add);
    w.y = static_cast<int>(a[4 * m + 1] + add);
    w.z = static_cast<int>(a[4 * m + 2] + add);
    w.w = static_cast<int>(a[4 * m + 3] + add);
    sh_v[swz(t * kVecs + m)] = w;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int q = j * kMsThreads + t;
    const int e = 4 * q;
    const int4 w = sh_v[swz(q)];
    if (vec_out && e + 4 <= valid) {
      store4(yr + e, w);
    } else {
      if (e < valid) yr[e] = w.x;
      if (e + 1 < valid) yr[e + 1] = w.y;
      if (e + 2 < valid) yr[e + 2] = w.z;
      if (e + 3 < valid) yr[e + 3] = w.w;
    }
  }
}

// ------------------------------------------------------- fused_segment_scans

struct Tri {
  unsigned rank, head, vis;   // segment starts, latest start slot, visible
};

__device__ __forceinline__ Tri combine(Tri a, Tri b) {
  return {a.rank + b.rank, max(a.head, b.head), a.vis + b.vis};
}

__device__ __forceinline__ Tri warp_reduce(Tri v) {
  return {warp_sum(v.rank), warp_max(v.head), warp_sum(v.vis)};
}

__device__ __forceinline__ unsigned tri_get(Tri v, int c) {
  return c == 0 ? v.rank : (c == 1 ? v.head : v.vis);
}

// Reads a triple: its three words must all carry their flag.
__device__ __forceinline__ bool load_tri(const u64* w, Tri* out) {
  const u64 r = ld_status(w), h = ld_status(w + 1), v = ld_status(w + 2);
  if ((r >> 32) == 0 || (h >> 32) == 0 || (v >> 32) == 0) return false;
  *out = {static_cast<unsigned>(r), static_cast<unsigned>(h),
          static_cast<unsigned>(v)};
  return true;
}

// Look-back over (rank, head, vis); per tile, words 0-2 hold the aggregate
// (flag A) and words 3-5 the inclusive prefix (flag P). Tile 0 starts from
// `cin`, the carry-in of the shards before this one ({0, 0, 0} unsharded).
__device__ Tri lookback_tri(u64* st, int idx, Tri agg, Tri cin, int lane) {
  u64* me = st + static_cast<size_t>(kFsWords) * idx;
  if (idx == 0) {
    if (lane < 3)
      st_status(me + 3 + lane, kFlagP | tri_get(combine(cin, agg), lane));
    return cin;
  }
  if (lane < 3) st_status(me + lane, kFlagA | tri_get(agg, lane));
  Tri excl = {0, 0, 0};
  for (int p = idx - 1 - lane;; p -= 32) {
    Tri s = {0, 0, 0};
    bool is_p = true;                          // before the first tile
    if (p >= 0) {
      const u64* w = st + static_cast<size_t>(kFsWords) * p;
      while (true) {
        if (load_tri(w + 3, &s)) break;
        if (load_tri(w, &s)) {
          is_p = false;
          break;
        }
      }
    }
    const unsigned pm = __ballot_sync(kFull, is_p);
    const int last = pm ? __ffs(pm) - 1 : 31;
    if (lane > last) s = {0, 0, 0};
    excl = combine(excl, warp_reduce(s));
    if (pm) break;
  }
  if (lane < 3)
    st_status(me + 3 + lane, kFlagP | tri_get(combine(excl, agg), lane));
  return excl;
}

// 4 bools (bytes) of one word -> 4 bits, byte 0 to bit 0.
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ unsigned mask32(uint4 a, uint4 b) {
  return nibble(a.x) | nibble(a.y) << 4 | nibble(a.z) << 8 |
         nibble(a.w) << 12 | nibble(b.x) << 16 | nibble(b.y) << 20 |
         nibble(b.z) << 24 | nibble(b.w) << 28;
}

// Bits lo..hi set (0 <= lo, hi <= 31), or 0 when lo > hi.
__device__ __forceinline__ unsigned bit_range(long long lo, long long hi) {
  if (lo > hi) return 0u;
  const unsigned upto = (2u << static_cast<int>(hi)) - 1u;  // bits 0..hi
  return upto & ~((1u << static_cast<int>(lo)) - 1u);
}

// One output column: value k of this thread's 32 goes through shared
// memory (blocked -> striped) and out as int4 stores.
template <class F>
__device__ __forceinline__ void store_column(int4* sh_v, int* out, int s0,
                                             int n, int vec_out, F value) {
  const int t = threadIdx.x;
#pragma unroll
  for (int m = 0; m < kFsItems / 4; ++m) {
    int4 w;
    w.x = static_cast<int>(value(4 * m));
    w.y = static_cast<int>(value(4 * m + 1));
    w.z = static_cast<int>(value(4 * m + 2));
    w.w = static_cast<int>(value(4 * m + 3));
    sh_v[swz(t * (kFsItems / 4) + m)] = w;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kFsItems / 4; ++j) {
    const int q = j * kFsThreads + t;
    const int e = s0 + 4 * q;
    const int4 w = sh_v[swz(q)];
    if (vec_out && e + 4 <= n) {
      store4(out + e, w);
    } else {
      if (e < n) out[e] = w.x;
      if (e + 1 < n) out[e + 1] = w.y;
      if (e + 2 < n) out[e + 2] = w.z;
      if (e + 3 < n) out[e + 3] = w.w;
    }
  }
  __syncthreads();
}

// One thread's 32 slots from i0 on, of a row of length n whose first slot
// is global slot `base`: the segment-start and visible bits (sm, vm) of
// its live slots (global slot in [1, ne], i < n).
__device__ __forceinline__ void slot_masks(
    const unsigned char* __restrict__ chain,
    const unsigned char* __restrict__ has, int n, int i0, long long f0,
    long long ne, int vec_in, unsigned* sm, unsigned* vm) {
  unsigned cm = 0, hm = 0;                       // chain / has_value bits
  if (vec_in && i0 + kFsItems <= n) {
    const uint4* c4 = reinterpret_cast<const uint4*>(chain + i0);
    const uint4* h4 = reinterpret_cast<const uint4*>(has + i0);
    const uint4 c_lo = __ldg(c4), c_hi = __ldg(c4 + 1);
    const uint4 h_lo = __ldg(h4), h_hi = __ldg(h4 + 1);
    cm = mask32(c_lo, c_hi);
    hm = mask32(h_lo, h_hi);
  } else {
#pragma unroll 4
    for (int k = 0; k < kFsItems; ++k) {
      if (i0 + k < n) {
        cm |= static_cast<unsigned>(chain[i0 + k] != 0) << k;
        hm |= static_cast<unsigned>(has[i0 + k] != 0) << k;
      }
    }
  }
  const long long lo = max(1ll - f0, 0ll);
  const long long hi = min(min(ne - f0, 31ll),
                           static_cast<long long>(n) - 1 - i0);
  const unsigned em = bit_range(lo, hi);
  *sm = em & ~cm;                                // segment starts
  *vm = em & hm;                                 // visible elements
}

__device__ __forceinline__ Tri thread_tri(unsigned sm, unsigned vm,
                                          long long f0) {
  return {static_cast<unsigned>(__popc(sm)),
          sm ? static_cast<unsigned>(f0 + 31 - __clz(sm)) : 0u,
          static_cast<unsigned>(__popc(vm))};
}

// Rows of length n, each scanned on its own: tiles take tickets row after
// row (tpr tiles per row), and the look-back stays inside the row. Row r
// reads its element count from n_elems_p[r * ne_stride] (stride 0: one
// count for every row). With `carry` (the int32 (n_shards, rows, 3) totals
// of every shard of the column, this one at index `shard`), row r starts
// from the combined totals of shards 0 .. shard - 1.
__global__ void __launch_bounds__(kFsThreads)
fs_scan(const unsigned char* __restrict__ chain,
        const unsigned char* __restrict__ has, int n, int tpr, int rows,
        const int* __restrict__ n_elems_p, int ne_stride, int base,
        const int* __restrict__ carry, int shard,
        int vec_in, int vec_out, unsigned* ticket, u64* status,
        int* __restrict__ rank_out, int* __restrict__ head_out,
        int* __restrict__ vis_out) {
  constexpr int kWarps = kFsThreads / 32;
  __shared__ int4 sh_v[kFsTile / 4];
  __shared__ unsigned sh_w[3][kWarps];
  __shared__ int sh_tile;
  __shared__ Tri sh_prefix;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;

  const int tile = take_ticket(ticket, &sh_tile);
  const int row = tile / tpr;
  const int ct = tile - row * tpr;               // tile index in the row
  const size_t roff = static_cast<size_t>(row) * n;
  chain += roff;
  has += roff;
  rank_out += roff;
  head_out += roff;
  vis_out += roff;
  const int s0 = ct * kFsTile;                   // first slot of the tile
  const int i0 = s0 + t * kFsItems;              // first slot of the thread

  const long long f0 = static_cast<long long>(base) + i0;
  const long long ne = n_elems_p[static_cast<size_t>(row) * ne_stride];
  unsigned sm, vm;
  slot_masks(chain, has, n, i0, f0, ne, vec_in, &sm, &vm);
  const Tri mine = thread_tri(sm, vm, f0);
  // exclusive scan across the block
  Tri incl = {warp_incl_sum(mine.rank, lane), warp_incl_max(mine.head, lane),
              warp_incl_sum(mine.vis, lane)};
  if (lane == 31) {
    sh_w[0][wid] = incl.rank;
    sh_w[1][wid] = incl.head;
    sh_w[2][wid] = incl.vis;
  }
  Tri ex_lane = {__shfl_up_sync(kFull, incl.rank, 1),
                 __shfl_up_sync(kFull, incl.head, 1),
                 __shfl_up_sync(kFull, incl.vis, 1)};
  if (lane == 0) ex_lane = {0, 0, 0};
  __syncthreads();
  Tri woff = {0, 0, 0}, agg = {0, 0, 0};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const Tri s = {sh_w[0][w], sh_w[1][w], sh_w[2][w]};
    if (w < wid) woff = combine(woff, s);
    agg = combine(agg, s);
  }
  if (wid == 0) {
    Tri cin = {0, 0, 0};
    if (carry != nullptr && ct == 0) {
      for (int s = 0; s < shard; ++s) {
        const int* c = carry + (static_cast<size_t>(s) * rows + row) * 3;
        cin = combine(cin, {static_cast<unsigned>(c[0]),
                            static_cast<unsigned>(c[1]),
                            static_cast<unsigned>(c[2])});
      }
    }
    const Tri pre = lookback_tri(
        status + static_cast<size_t>(row) * tpr * kFsWords, ct, agg, cin,
        lane);
    if (lane == 0) sh_prefix = pre;
  }
  __syncthreads();
  const Tri start = combine(combine(sh_prefix, woff), ex_lane);

  store_column(sh_v, rank_out, s0, n, vec_out, [&](int k) {
    return start.rank + __popc(sm & ((2u << k) - 1u));
  });
  store_column(sh_v, head_out, s0, n, vec_out, [&](int k) {
    const unsigned upto = sm & ((2u << k) - 1u);
    return upto ? static_cast<unsigned>(f0 + 31 - __clz(upto)) : start.head;
  });
  store_column(sh_v, vis_out, s0, n, vec_out, [&](int k) {
    return start.vis + __popc(vm & ((2u << k) - 1u));
  });
}

// Per row, the totals of its live slots: (segment starts, the latest
// segment-start slot or 0, visible count), added (and maxed) into the
// int32 (rows, 3) `out`, which the entry point zeroes first. One tile a
// block, as fs_scan cuts them; no ticket, no look-back.
__global__ void __launch_bounds__(kFsThreads)
fs_totals(const unsigned char* __restrict__ chain,
          const unsigned char* __restrict__ has, int n, int tpr,
          const int* __restrict__ n_elems_p, int ne_stride, int base,
          int vec_in, int* __restrict__ out) {
  constexpr int kWarps = kFsThreads / 32;
  __shared__ unsigned sh_w[3][kWarps];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int row = blockIdx.x / tpr;
  const int ct = blockIdx.x - row * tpr;
  const size_t roff = static_cast<size_t>(row) * n;
  const int i0 = ct * kFsTile + t * kFsItems;
  const long long f0 = static_cast<long long>(base) + i0;
  const long long ne = n_elems_p[static_cast<size_t>(row) * ne_stride];
  unsigned sm = 0, vm = 0;
  if (i0 < n) slot_masks(chain + roff, has + roff, n, i0, f0, ne, vec_in,
                         &sm, &vm);
  const Tri w = warp_reduce(thread_tri(sm, vm, f0));
  if (lane == 0) {
    sh_w[0][wid] = w.rank;
    sh_w[1][wid] = w.head;
    sh_w[2][wid] = w.vis;
  }
  __syncthreads();
  if (t == 0) {
    Tri agg = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < kWarps; ++k)
      agg = combine(agg, {sh_w[0][k], sh_w[1][k], sh_w[2][k]});
    unsigned* o = reinterpret_cast<unsigned*>(out) + static_cast<size_t>(row) * 3;
    if (agg.rank) atomicAdd(o, agg.rank);
    if (agg.head) atomicMax(o + 1, agg.head);
    if (agg.vis) atomicAdd(o + 2, agg.vis);
  }
}

inline int num_tiles(int n, int tile) { return (n + tile - 1) / tile; }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Columns of one multi_scan tile and slots of one segment-scan tile; the
// caller sizes the scratch from them (8 bytes for the ticket plus 8 per
// status word: one per multi_scan tile, six per segment-scan tile).
int amt_multi_scan_tile() { return kMsTile; }
int amt_fused_scan_tile() { return kFsTile; }

// y[k, :] = inclusive prefix sum of x[k, :], int32 (K, N) row-major.
// scratch: at least 8 * (1 + K * ceil(N / tile)) bytes, 8-byte aligned.
int amt_multi_scan(const void* x, void* y, void* scratch,
                   long long scratch_bytes, int k, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tpr = num_tiles(n, kMsTile);
  const long long tiles = static_cast<long long>(k) * tpr;
  const long long need = 8 * (1 + tiles);
  if (scratch_bytes < need || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(scratch, 0, need, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  u64* words = static_cast<u64*>(scratch);
  const int vec_in = n % 4 == 0 && aligned16(x);
  const int vec_out = n % 4 == 0 && aligned16(y);
  ms_scan<<<static_cast<unsigned>(tiles), kMsThreads, 0, s>>>(
      static_cast<const int*>(x), static_cast<int*>(y), n, tpr, vec_in,
      vec_out, reinterpret_cast<unsigned*>(words), words + 1);
  return static_cast<int>(cudaGetLastError());
}

// (rank_incl, seg_head, cumvis) of `rows` rows of bool chain/has_value
// columns, each row n long and scanned on its own; row r reads its
// element count n_elems[r * ne_stride] on the device (ne_stride 0: one
// count for all rows). `carry` (may be null): the int32 (n_shards, rows,
// 3) totals of every shard of a sharded column (amt_fs_totals), this
// shard at index `shard`; row r then starts from shards 0 .. shard - 1.
// scratch: at least 8 * (1 + 6 * rows * ceil(n / tile)) bytes, 8-byte
// aligned.
int amt_fused_segment_scans(const void* chain, const void* has, int rows,
                            int n, const void* n_elems, int ne_stride,
                            int base, const void* carry, int shard,
                            void* scratch, long long scratch_bytes,
                            void* rank, void* head, void* cumvis,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tpr = num_tiles(n, kFsTile);
  const long long tiles = static_cast<long long>(rows) * tpr;
  const long long need = 8 * (1 + static_cast<long long>(kFsWords) * tiles);
  if (scratch_bytes < need || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(scratch, 0, need, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  u64* words = static_cast<u64*>(scratch);
  // every row must start on 16 bytes too: bool rows of a multiple of 16
  // slots, int32 rows of a multiple of 4
  const int vec_in = aligned16(chain) && aligned16(has) &&
                     (rows == 1 || n % 16 == 0);
  const int vec_out = aligned16(rank) && aligned16(head) &&
                      aligned16(cumvis) && (rows == 1 || n % 4 == 0);
  fs_scan<<<static_cast<unsigned>(tiles), kFsThreads, 0, s>>>(
      static_cast<const unsigned char*>(chain),
      static_cast<const unsigned char*>(has), n, tpr, rows,
      static_cast<const int*>(n_elems), ne_stride, base,
      static_cast<const int*>(carry), shard, vec_in, vec_out,
      reinterpret_cast<unsigned*>(words), words + 1, static_cast<int*>(rank),
      static_cast<int*>(head), static_cast<int*>(cumvis));
  return static_cast<int>(cudaGetLastError());
}

// The int32 (rows, 3) totals (segment starts, latest segment-start slot
// or 0, visible count) of the live slots of `rows` rows of bool
// chain/has_value columns, each n long with first global slot `base`;
// element counts as amt_fused_segment_scans reads them. `out` is zeroed
// on the stream first.
int amt_fs_totals(const void* chain, const void* has, int rows, int n,
                  const void* n_elems, int ne_stride, int base, void* out,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tpr = num_tiles(n, kFsTile);
  const long long tiles = static_cast<long long>(rows) * tpr;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(out, 0, 12ll * rows, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec_in = aligned16(chain) && aligned16(has) &&
                     (rows == 1 || n % 16 == 0);
  fs_totals<<<static_cast<unsigned>(tiles), kFsThreads, 0, s>>>(
      static_cast<const unsigned char*>(chain),
      static_cast<const unsigned char*>(has), n, tpr,
      static_cast<const int*>(n_elems), ne_stride, base, vec_in,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
