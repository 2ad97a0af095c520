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
// (three int32 columns) per slot: 88 MB at C = 6,291,456, 0.026 ms. Short
// rows are bound by neither: a launch of (500, 192) moves 1.3 MB, 0.4 us
// at 3.35 TB/s, against a few microseconds to launch and drain a grid, so
// there the design counts device operations per call and idle lanes.
//
// The look-back form of every kernel here: one single-pass launch, a
// chained scan with decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016). The TPU
// kernels carry their running totals across a grid that runs in order;
// Hopper blocks run in no order, so each block here
//   1. takes its tile from a ticket (an atomic counter in the scratch), so
//      every tile before it has already started and the look-back below
//      never waits on a block that was never scheduled;
//   2. loads its tile once with 16-byte loads (multi_scan: int4 loads in
//      striped order, moved through shared memory to BLOCKED order, kItems
//      consecutive values per thread; segment scans: two uint4 of 16 bools
//      per column per thread, packed into one 32-bit mask per column);
//   3. scans in registers: a serial scan over the thread's items (for the
//      segment scans, popcounts and a count-leading-zeros on the masks), a
//      warp-shuffle scan of the thread totals, one cross-warp step in
//      shared memory;
//   4. publishes its aggregate, lets warp 0 fold the status words of its
//      predecessors 32 at a time until the first inclusive prefix, then
//      publishes its own inclusive prefix;
//   5. adds its exclusive prefix and moves the results to striped order
//      (multi_scan through shared memory; the segment scans by shuffles
//      inside each warp, each lane fetching the masks and prefix of the
//      lane whose slots it stores), so each warp stores whole contiguous
//      int4 vectors.
// A status word is one 64-bit {tag, value}, written and read whole with
// ld/st.relaxed.gpu, so a reader never sees a tag without its value. Sums
// run in unsigned arithmetic (wrap-around defined, equal to
// torch.cumsum(..., dtype=torch.int32)); the max of the segment heads has
// identity 0 because its candidates are global slot numbers >= 1, or 0.
//
// Both kernels take (rows, n) matrices, every row scanned on its own
// (multi_scan's (K, N) channels; for the segment scans one column or the
// DocSet's per-document rows, each with its own element count, a shard's
// block of rows). The host picks one of three forms from the row length n
// (ops/scan_kernels.py ms_geometry and fs_geometry; the entry points
// refuse another):
//   warp form,     n <= 1,024 (kMsWarpRow = 32 lanes x kMsItems int32;
//                  kFsWarpRow = 32 lanes x one 32-slot mask): one warp a
//                  row, 8 rows a 256-thread block. No ticket, no
//                  look-back, no shared memory, no scratch. The segment
//                  scans' lane holds 32 consecutive slots as a mask, scans
//                  by shuffles and stores by the transpose of step 5.
//                  multi_scan's warp scans its row in striped rounds of
//                  128 columns instead: in round j lane L loads the int4 of
//                  columns 4 (32 j + L) .. + 3, scans its 4 values
//                  serially and the lane totals by shuffles, adds the
//                  carry of the rounds before and stores the int4 where it
//                  loaded it, so every load and store instruction of the
//                  warp covers 512 contiguous bytes. 32 int32 a lane do not
//                  fold into one word as 32 bools do, and a transpose by
//                  shuffles would index registers by lane. A row of 256
//                  columns takes 2 rounds, all loads issued before the
//                  first scan.
//   block form,    n <= the tile (8,192): one block a row, the tile steps
//                  2-5 above without the ticket and the look-back. No
//                  scratch.
//   look-back form, longer rows: tpr = ceil(n / tile) tiles a row, the
//                  ticket running row after row, the look-back inside the
//                  row. The scratch below.
// A short row in a tile of its own would idle most of a block (97% of
// the slots at the mesh DocSet's per-shard (500, 192) and of the lanes at
// the (6, 256) per-object rounds) and pay a ticket and a look-back. A
// small launch is bound by its latency: each form issues its count,
// carry-in and column loads together before it uses any of them.
//
// The sharded form (an element column cut into shards, each scanned at its
// own global base) is reduce, exchange, then scan. fs_totals reduces one
// shard's live slots to (segment starts, last segment-start slot or 0,
// visible count) per row, written with plain stores: a warp or a block
// reduces a row of the warp or block form; a row longer than a tile has
// each block write its partial to the scratch and count itself in on the
// row's counter, and the row's last block folds the partials (sums and a
// max: the result does not depend on their order). The caller gathers
// every shard's totals onto each shard's device, (n_shards, rows, 3),
// without a host sync; fs_scan then takes them as a carry-in, folded by a
// warp into each row's start (warp and block forms) or into the inclusive
// prefix tile 0 publishes (look-back form, so the look-back carries it to
// every later tile), rank and vis summed and heads maxed as
// scan_pallas.py:251-258 does. The pair reads the two bool columns twice
// and writes the three int32 columns once: 16 bytes a slot against the 14
// of one pass, plus 12 bytes a row and shard of totals.
//
// The look-back scratch persists across launches: one buffer per (device,
// stream, kernel family: multi_scan, or the segment scans), owned by
// ops/scan_kernels.py, zeroed once when it is allocated, laid out as two
// int64 header words, [one u32 counter a row, for fs_totals], [status
// words]. Every launch is one kernel and nothing else (no memset, no
// fill), and all state from one launch to the next lives on the device,
// so a replayed CUDA graph stays right:
//   - the ticket and every counter reset themselves: atomicInc(c, k - 1)
//     wraps to 0 on the k-th increment, and a launch takes exactly k;
//   - a status word carries the launch's tag (epoch + 1) in its upper
//     half (fs_scan: the tag, with an aggregate and a prefix triple a
//     tile; multi_scan: tag << 1, its low bit set for an inclusive prefix,
//     one word a tile). Blocks read the epoch when they take their ticket.
//     A word left by an earlier launch carries an older tag and never
//     reads as published;
//   - fs_scan's header is u32 {ticket, arrivals, epoch}: the last block of
//     the launch to arrive (a second self-resetting counter, counted after
//     each block's look-back: a fence and an atomic a block) advances the
//     epoch. multi_scan's is one u64 {epoch, ticket} that one 64-bit
//     atomic draws from, and the launch's last draw advances the epoch and
//     resets the ticket in one store: it counts no arrivals (a trial that
//     did slowed its merge shape by a few percent) but in the launch whose
//     tag is the last;
//   - the tag runs 1 .. 2^32 - 1 (multi_scan 1 .. 2^31 - 1); the launch
//     whose next tag would wrap to 0 counts arrivals, and its last block
//     clears every status word of the buffer before the epoch starts again
//     at 0, so a stale word can never carry a live tag: wrap-around is
//     excluded, not made unlikely;
//   - fs_totals' partials keep upper halves of 0, which no tag equals.
// The two families tag their words differently, so each keeps its own
// buffer: a multi_scan launch between two fs_scan launches on one stream
// (a commit's expansion, then its self-contained read) leaves no epoch or
// word that an fs_scan reads.
// Launches on one stream run one after another, so they share its buffers
// safely; two streams never share one. A graph replays its kernels with
// the scratch of the stream that captured it, so it must not run while
// other work on that stream does. The buffer grows (a new zeroed one) when
// a launch needs more, outside any capture; the old one is kept, since a
// captured graph may still replay its pointer (were it freed, the caching
// allocator would reuse it only on its own stream, so growing stays
// stream-ordered either way).
//
// Inputs the 16-byte path cannot take (multi_scan with N % 4 != 0, so that
// a row does not start on 16 bytes; any pointer off 16-byte alignment,
// such as a bool view t[1:] or an int32 view 4 bytes in; bool rows of a
// length off a multiple of 16) take a scalar path inside the same kernel,
// chosen by the entry point from the pointers and lengths. The ragged edge
// of a row is masked on either path, in every form.
//
// Sizes, from one run of scripts/sweep_scan_tiles.py at the merge shapes
// on an H100 80GB HBM3 at 700 W, each call reading its input from HBM
// (PERF.md has the table). multi_scan: 256 threads x 32 int32 (an
// 8,192-column tile, 32 KB of loads in flight per block, 60 registers,
// 4 blocks per SM) took 0.129 ms; 128 x 32 tied (0.130 ms); 512 x 16 took
// 0.138 ms, 256 x 16 0.145 ms and 256 x 8 0.173 ms, because fewer bytes
// in flight per SM leave HBM latency uncovered. Segment scans: 256
// threads x 32 slots (one 32-bit mask per column per thread, 8,192 slots
// per tile; at the time with a shared-memory transpose, 80 registers, 3
// blocks per SM) took 0.038 ms, 128 threads 0.039 ms and 64 threads
// 0.044 ms. With the shuffle transpose the look-back form takes 48
// registers and 116 bytes of shared memory (5 blocks per SM), the other
// forms 40 (ptxas -v); chip_smoke.py's phase 7 reads it at 0.0384 ms on
// the same card. multi_scan's forms (ptxas -v): the look-back 64
// registers and 32,812 bytes of shared memory (4 blocks per SM, as the
// single form had), the block form 76 registers, the warp form 47 and no
// shared memory. Evict-first 16-byte stores (__stcs) beat plain ones in
// both kernels (0.129 vs 0.133 ms, 0.038 vs 0.039 ms). TMA bulk copies
// were not taken: the plain 16-byte loads already pass half the bound.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kMsThreads = 256;
constexpr int kMsItems = 32;                      // int32 per thread
constexpr int kMsTile = kMsThreads * kMsItems;    // columns per tile
constexpr int kMsWarps = kMsThreads / 32;
constexpr int kMsWarpRow = 32 * kMsItems;         // columns of a warp-form row
constexpr int kMsStatusWords = 1;                 // status words per tile
constexpr int kFsThreads = 256;
constexpr int kFsItems = 32;                      // slots per thread: one mask
constexpr int kFsTile = kFsThreads * kFsItems;    // slots per tile
constexpr int kFsWords = 6;                       // status words per tile
constexpr int kFsWarps = kFsThreads / 32;
constexpr int kFsWarpRow = 32 * kFsItems;         // slots of a warp-form row
constexpr int kHeaderWords = 2;                   // ticket, arrivals, epoch
constexpr int kWarpForm = 0, kBlockForm = 1, kLookbackForm = 2;
constexpr unsigned kEpochWrap = 0xffffffffu;      // an epoch never stored
constexpr unsigned kMsTagMax = 0x7fffffffu;       // (tag << 1) | 1 fits u32
constexpr unsigned kFull = 0xffffffffu;

static_assert(kMsItems % 4 == 0 && kMsItems >= 4 && kMsItems <= 32,
              "multi_scan items per thread: a multiple of 4, at most 32");
static_assert(kMsThreads % 32 == 0 && kFsThreads % 32 == 0,
              "whole warps");
static_assert(kMsThreads / 32 <= 32 && kFsThreads / 32 <= 32,
              "one warp scans the warp totals");
static_assert(kFsItems == 32, "one 32-bit mask per column per thread");
static_assert(kFsWarpRow <= kFsTile && kMsWarpRow <= kMsTile,
              "a warp-form row fits a tile");

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

// The 4 int32 of w to out[e .. e + 3], those below n: one 16-byte store
// when the caller allows it (vec_out) and all 4 are in the row.
__device__ __forceinline__ void store_int4(int* out, int e, int n,
                                           int vec_out, int4 w) {
  if (vec_out && e + 4 <= n) {
    store4(out + e, w);
  } else {
    if (e < n) out[e] = w.x;
    if (e + 1 < n) out[e + 1] = w.y;
    if (e + 2 < n) out[e + 2] = w.z;
    if (e + 3 < n) out[e + 3] = w.w;
  }
}

// The 4 int32 at in[e .. e + 3], 0 past n: one 16-byte load when allowed.
__device__ __forceinline__ int4 load_int4(const int* in, int e, int n,
                                          int vec_in) {
  if (vec_in && e + 4 <= n)
    return __ldg(reinterpret_cast<const int4*>(in + e));
  int4 v;
  v.x = e < n ? in[e] : 0;
  v.y = e + 1 < n ? in[e + 1] : 0;
  v.z = e + 2 < n ? in[e + 2] : 0;
  v.w = e + 3 < n ? in[e + 3] : 0;
  return v;
}

__device__ __forceinline__ unsigned ld_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_u32(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// One block of a look-back launch is done with the status words: true in
// the thread of the launch's last block to say so (the counter wraps to 0
// behind it), once every block's words are visible. Run by one thread a
// block, after the block's look-back.
__device__ bool last_to_arrive(unsigned* counter) {
  __threadfence();
  if (atomicInc(counter, gridDim.x - 1) != gridDim.x - 1) return false;
  __threadfence();
  return true;
}

__device__ void clear_words(u64* words, long long n) {
  for (long long k = 0; k < n; ++k) st_status(words + k, 0ull);
}

// fs_scan's epoch: the last block to arrive (counter hdr[1]) advances the
// epoch hdr[2], so the next launch on this scratch tags its words anew;
// when the next epoch would be kEpochWrap it first clears every status
// word and starts again from 0, so a stale word never carries a live tag.
__device__ void arrive(unsigned* hdr, u64* words, long long word_cap) {
  if (!last_to_arrive(hdr + 1)) return;
  unsigned next = ld_u32(hdr + 2) + 1u;
  if (next == kEpochWrap) {
    clear_words(words, word_cap);
    next = 0;
  }
  st_u32(hdr + 2, next);
}

// fs_scan's ticket (the tile this block scans, in the order blocks
// started; hdr[0] resets itself after the launch's last block) and the
// launch's tag, epoch + 1, both in every thread.
__device__ __forceinline__ void take_ticket(unsigned* hdr, int* sh_tile,
                                            unsigned* sh_tag, int* tile,
                                            unsigned* tag) {
  if (threadIdx.x == 0) {
    *sh_tile = static_cast<int>(atomicInc(hdr, gridDim.x - 1));
    *sh_tag = ld_u32(hdr + 2) + 1u;
  }
  __syncthreads();
  *tile = *sh_tile;
  *tag = *sh_tag;
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

// ---------------------------------------------------------------- multi_scan

// Everything one multi_scan launch reads.
struct MsArgs {
  const int* x;
  int* y;
  int n, tpr, rows;            // row length, tiles per row, rows
  int vec_in, vec_out;         // 16-byte loads / stores allowed
  u64* hdr;                    // look-back scratch: {epoch, ticket}, arrivals
  u64* words;                  // look-back scratch: one status word a tile
  long long word_cap;
};

// Decoupled look-back of one row, run by one whole warp. `st` is the row's
// status words, `idx` this tile's index in the row, `agg` its aggregate,
// `tag` this launch's. A word's upper half is (tag << 1) | P: P set for an
// inclusive prefix, clear for an aggregate. Returns the sum of every tile
// before it in the row.
__device__ unsigned lookback_sum(u64* st, int idx, unsigned agg, int lane,
                                 unsigned tag) {
  const u64 flag_a = static_cast<u64>(tag << 1) << 32;
  const u64 flag_p = flag_a | (1ull << 32);
  if (idx == 0) {
    if (lane == 0) st_status(st, flag_p | agg);
    return 0;
  }
  if (lane == 0) st_status(st + idx, flag_a | agg);
  unsigned excl = 0;
  for (int p = idx - 1 - lane;; p -= 32) {
    u64 s = flag_p;                            // before the row: P, value 0
    if (p >= 0) {
      do {
        s = ld_status(st + p);
      } while (static_cast<unsigned>(s >> 33) != tag);
    }
    const unsigned pm = __ballot_sync(kFull, (s >> 32) & 1u);
    const int last = pm ? __ffs(pm) - 1 : 31;  // nearest tile with P
    excl += warp_sum(lane <= last ? static_cast<unsigned>(s) : 0u);
    if (pm) break;
  }
  if (lane == 0) st_status(st + idx, flag_p | (excl + agg));
  return excl;
}

// multi_scan's look-back header is one u64 {epoch (upper half), ticket},
// then a u32 arrival counter. One 64-bit atomic gives a block its ticket
// (its tile, in the order blocks started) and the launch's tag, epoch + 1,
// both in every thread. The launch's last draw sets the header to ticket 0
// under the next epoch: every block of the launch already holds its tag,
// and the next launch starts only after this one has ended. So a launch
// pays one atomic a block, no fence, and no arrival, except the launch
// whose tag is kMsTagMax: its last block to arrive clears every status
// word and sets the header to 0 (ms_scan), so the tags start again at 1
// and no stale word carries one.
__device__ __forceinline__ void ms_take_ticket(u64* hdr, int* sh_tile,
                                               unsigned* sh_tag, int* tile,
                                               unsigned* tag) {
  if (threadIdx.x == 0) {
    const u64 old = atomicAdd(hdr, 1ull);
    const unsigned ticket = static_cast<unsigned>(old);
    const unsigned launch_tag = static_cast<unsigned>(old >> 32) + 1u;
    *sh_tile = static_cast<int>(ticket);
    *sh_tag = launch_tag;
    if (ticket == gridDim.x - 1 && launch_tag != kMsTagMax)
      st_status(hdr, static_cast<u64>(launch_tag) << 32);
  }
  __syncthreads();
  *tile = *sh_tile;
  *tag = *sh_tag;
}

// One row of at most kMsWarpRow columns, scanned by one warp in striped
// rounds of 128 columns: lane L of round j holds columns 4 (32 j + L) ..
// + 3. Every round's loads are issued first; a round past the row's end
// loads and stores nothing (the test is the same for the whole warp).
__device__ __forceinline__ void ms_warp_row(const MsArgs& a, int row,
                                            int lane) {
  constexpr int kRounds = kMsItems / 4;
  const size_t off = static_cast<size_t>(row) * a.n;
  const int* xr = a.x + off;
  int* yr = a.y + off;
  int4 v[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j)
    if (128 * j < a.n) v[j] = load_int4(xr, 4 * (32 * j + lane), a.n,
                                        a.vec_in);
  unsigned carry = 0;                          // the rounds before
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    if (128 * j >= a.n) break;
    const unsigned s0 = v[j].x, s1 = s0 + v[j].y, s2 = s1 + v[j].z,
                   s3 = s2 + v[j].w;
    const unsigned incl = warp_incl_sum(s3, lane);
    const unsigned add = carry + incl - s3;
    int4 w;
    w.x = static_cast<int>(s0 + add);
    w.y = static_cast<int>(s1 + add);
    w.z = static_cast<int>(s2 + add);
    w.w = static_cast<int>(s3 + add);
    store_int4(yr, 4 * (32 * j + lane), a.n, a.vec_out, w);
    carry += __shfl_sync(kFull, incl, 31);
  }
}

// The inclusive prefix sums of `rows` rows of n int32, each on its own.
// kWarpForm: one warp a row (n <= kMsWarpRow), kMsWarps rows a block.
// kBlockForm: one block a row (n <= kMsTile). kLookbackForm: tpr tiles a
// row, taken from the self-resetting ticket row after row, the look-back
// inside the row.
template <int kForm>
__global__ void __launch_bounds__(kMsThreads) ms_scan(MsArgs a) {
  constexpr int kVecs = kMsItems / 4;            // int4 per thread
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;

  if constexpr (kForm == kWarpForm) {
    const int row = blockIdx.x * kMsWarps + wid;
    if (row >= a.rows) return;                   // the whole warp leaves
    ms_warp_row(a, row, lane);
  } else {
    __shared__ int4 sh_v[kMsTile / 4];
    __shared__ unsigned sh_w[kMsWarps];
    __shared__ int sh_tile;
    __shared__ unsigned sh_tag;
    __shared__ unsigned sh_prefix;
    int tile = blockIdx.x;
    unsigned tag = 0;
    if constexpr (kForm == kLookbackForm)
      ms_take_ticket(a.hdr, &sh_tile, &sh_tag, &tile, &tag);
    const int row = tile / a.tpr;
    const int ct = tile - row * a.tpr;           // tile index in the row
    const int c0 = ct * kMsTile;
    const size_t off = static_cast<size_t>(row) * a.n + c0;
    const int* xr = a.x + off;
    int* yr = a.y + off;
    const int valid = min(kMsTile, a.n - c0);

    // striped loads: vector q = j * threads + t covers columns 4q .. 4q + 3
    int4 v[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      v[j] = load_int4(xr, 4 * (j * kMsThreads + t), valid, a.vec_in);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) sh_v[swz(j * kMsThreads + t)] = v[j];
    __syncthreads();

    // blocked: this thread's kMsItems consecutive columns, scanned serially
    unsigned s[kMsItems];
#pragma unroll
    for (int m = 0; m < kVecs; ++m) {
      const int4 w = sh_v[swz(t * kVecs + m)];
      s[4 * m] = w.x;
      s[4 * m + 1] = w.y;
      s[4 * m + 2] = w.z;
      s[4 * m + 3] = w.w;
    }
#pragma unroll
    for (int k = 1; k < kMsItems; ++k) s[k] += s[k - 1];
    const unsigned total = s[kMsItems - 1];

    const unsigned incl = warp_incl_sum(total, lane);
    if (lane == 31) sh_w[wid] = incl;
    __syncthreads();
    unsigned woff = 0, agg = 0;
#pragma unroll
    for (int w = 0; w < kMsWarps; ++w) {
      const unsigned sw = sh_w[w];
      woff += w < wid ? sw : 0u;
      agg += sw;
    }
    unsigned pre = 0;
    if constexpr (kForm == kLookbackForm) {
      if (wid == 0) {
        const unsigned p = lookback_sum(
            a.words + static_cast<size_t>(row) * a.tpr * kMsStatusWords, ct,
            agg, lane, tag);
        if (lane == 0) sh_prefix = p;
      }
      __syncthreads();
      if (tag == kMsTagMax && t == 0 &&
          last_to_arrive(reinterpret_cast<unsigned*>(a.hdr + 1))) {
        clear_words(a.words, a.word_cap);
        st_status(a.hdr, 0ull);
      }
      pre = sh_prefix;
    }
    const unsigned add = pre + woff + incl - total;

#pragma unroll
    for (int m = 0; m < kVecs; ++m) {
      int4 w;
      w.x = static_cast<int>(s[4 * m] + add);
      w.y = static_cast<int>(s[4 * m + 1] + add);
      w.z = static_cast<int>(s[4 * m + 2] + add);
      w.w = static_cast<int>(s[4 * m + 3] + add);
      sh_v[swz(t * kVecs + m)] = w;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int q = j * kMsThreads + t;
      store_int4(yr, 4 * q, valid, a.vec_out, sh_v[swz(q)]);
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

__device__ __forceinline__ Tri warp_incl(Tri v, int lane) {
  return {warp_incl_sum(v.rank, lane), warp_incl_max(v.head, lane),
          warp_incl_sum(v.vis, lane)};
}

// The lane before this one's inclusive value: an exclusive scan.
__device__ __forceinline__ Tri shfl_up1(Tri v, int lane) {
  const Tri e = {__shfl_up_sync(kFull, v.rank, 1),
                 __shfl_up_sync(kFull, v.head, 1),
                 __shfl_up_sync(kFull, v.vis, 1)};
  return lane == 0 ? Tri{0, 0, 0} : e;
}

__device__ __forceinline__ unsigned tri_get(Tri v, int c) {
  return c == 0 ? v.rank : (c == 1 ? v.head : v.vis);
}

// Everything one segment-scan launch reads: the columns, the counts, the
// carry-in, the persistent scratch and the outputs.
struct FsArgs {
  const unsigned char* chain;
  const unsigned char* has;
  int n, tpr, rows;            // row length, tiles per row, rows
  const int* n_elems;          // row r's count at n_elems[r * ne_stride],
  int ne_stride;               // or ne_imm for every row when ne_stride < 0
  long long ne_imm;
  int base;                    // global slot of each row's slot 0
  const int* carry;            // (n_shards, rows, 3) totals, or null
  int shard;
  int vec_in, vec_out;         // 16-byte loads / stores allowed
  unsigned* hdr;               // scratch: ticket, arrivals, epoch
  unsigned* row_done;          // scratch: one arrival counter per row
  u64* words;                  // scratch: status words or partials
  long long word_cap;
  int* rank;                   // fs_scan's outputs
  int* head;
  int* vis;
  int* totals;                 // fs_totals' (rows, 3) output
};

__device__ __forceinline__ long long row_count(const FsArgs& a, int row) {
  return a.ne_stride < 0 ? a.ne_imm
                         : a.n_elems[static_cast<size_t>(row) * a.ne_stride];
}

// This lane's part of the carry-in of `row`: the totals of shards lane,
// lane + 32, ... before this one (sums and a max, 0 for none). Loaded
// before the columns, so both reads are in flight together; warp_reduce
// folds the parts of a whole warp.
__device__ __forceinline__ Tri carry_part(const FsArgs& a, int row,
                                          int lane) {
  Tri c = {0, 0, 0};
  if (a.carry != nullptr) {
    for (int s = lane; s < a.shard; s += 32) {
      const int* p = a.carry + (static_cast<size_t>(s) * a.rows + row) * 3;
      c = combine(c, {static_cast<unsigned>(p[0]), static_cast<unsigned>(p[1]),
                      static_cast<unsigned>(p[2])});
    }
  }
  return c;
}

// Reads a triple of this launch: its three words must all carry `tag`.
__device__ __forceinline__ bool load_tri(const u64* w, unsigned tag,
                                         Tri* out) {
  const u64 r = ld_status(w), h = ld_status(w + 1), v = ld_status(w + 2);
  if (static_cast<unsigned>(r >> 32) != tag ||
      static_cast<unsigned>(h >> 32) != tag ||
      static_cast<unsigned>(v >> 32) != tag)
    return false;
  *out = {static_cast<unsigned>(r), static_cast<unsigned>(h),
          static_cast<unsigned>(v)};
  return true;
}

// Look-back over (rank, head, vis); per tile, words 0-2 hold the aggregate
// and words 3-5 the inclusive prefix, each tagged with this launch's epoch
// tag in its upper half. Tile 0 starts from `cin`, the carry-in of the
// shards before this one ({0, 0, 0} unsharded).
__device__ Tri lookback_tri(u64* st, int idx, Tri agg, Tri cin, int lane,
                            unsigned tag) {
  const u64 flag = static_cast<u64>(tag) << 32;
  u64* me = st + static_cast<size_t>(kFsWords) * idx;
  if (idx == 0) {
    if (lane < 3) st_status(me + 3 + lane, flag | tri_get(combine(cin, agg),
                                                          lane));
    return cin;
  }
  if (lane < 3) st_status(me + lane, flag | tri_get(agg, lane));
  Tri excl = {0, 0, 0};
  for (int p = idx - 1 - lane;; p -= 32) {
    Tri s = {0, 0, 0};
    bool is_p = true;                          // before the first tile
    if (p >= 0) {
      const u64* w = st + static_cast<size_t>(kFsWords) * p;
      while (true) {
        if (load_tri(w + 3, tag, &s)) break;
        if (load_tri(w, tag, &s)) {
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
    st_status(me + 3 + lane, flag | tri_get(combine(excl, agg), lane));
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

// One output value of slot k (0-31) of a thread with segment-start and
// visible masks (sm, vm), first global slot f0 and prefix `start`. The
// head is a max, not a choice: a carry-in head may lie past the slots.
__device__ __forceinline__ void scan_values(unsigned sm, unsigned vm,
                                            long long f0, Tri start, int k,
                                            int* r, int* h, int* v) {
  const unsigned upto = sm & ((2u << k) - 1u);
  *r = static_cast<int>(start.rank + __popc(upto));
  *h = static_cast<int>(max(
      upto ? static_cast<unsigned>(f0 + 31 - __clz(upto)) : 0u, start.head));
  *v = static_cast<int>(start.vis + __popc(vm & ((2u << k) - 1u)));
}

// The three output columns of one warp's 32 x 32 slots from w0 on (lane l
// owns the 32 from w0 + 32 l: masks sm, vm and prefix `start`), of a row
// of length n, in striped order: in round j, lane L writes slots 4 q ..
// 4 q + 3 (q = 32 j + L) of lane q / 8, whose masks and prefix it fetches
// by shuffles, so each store instruction of the warp covers 512
// contiguous bytes. No shared memory, no barrier.
__device__ __forceinline__ void store_scans(const FsArgs& a, size_t roff,
                                            int w0, int lane, unsigned sm,
                                            unsigned vm, Tri start) {
#pragma unroll
  for (int j = 0; j < kFsItems / 4; ++j) {
    const int q = 32 * j + lane;
    const int src = q >> 3;
    const unsigned s_sm = __shfl_sync(kFull, sm, src);
    const unsigned s_vm = __shfl_sync(kFull, vm, src);
    const Tri s_start = {__shfl_sync(kFull, start.rank, src),
                         __shfl_sync(kFull, start.head, src),
                         __shfl_sync(kFull, start.vis, src)};
    const long long f0 = static_cast<long long>(a.base) + w0 + 32 * src;
    const int k0 = 4 * (q & 7);
    int4 r, h, v;
    scan_values(s_sm, s_vm, f0, s_start, k0, &r.x, &h.x, &v.x);
    scan_values(s_sm, s_vm, f0, s_start, k0 + 1, &r.y, &h.y, &v.y);
    scan_values(s_sm, s_vm, f0, s_start, k0 + 2, &r.z, &h.z, &v.z);
    scan_values(s_sm, s_vm, f0, s_start, k0 + 3, &r.w, &h.w, &v.w);
    const int e = w0 + 4 * q;
    store_int4(a.rank + roff, e, a.n, a.vec_out, r);
    store_int4(a.head + roff, e, a.n, a.vec_out, h);
    store_int4(a.vis + roff, e, a.n, a.vec_out, v);
  }
}

// One thread's 32 slots from i0 on, of a row of length n whose first slot
// is global slot `base`: the segment-start and visible bits (sm, vm) of
// its live slots (global slot in [1, ne], i < n). Slots at or past n read
// nothing and give no bits.
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

// The block's aggregate of the threads' triples, in every thread. The
// caller separates two uses of sh_w with a __syncthreads.
__device__ __forceinline__ Tri block_reduce(Tri v, int lane, int wid,
                                            unsigned (*sh_w)[kFsWarps]) {
  const Tri w = warp_reduce(v);
  if (lane == 0) {
    sh_w[0][wid] = w.rank;
    sh_w[1][wid] = w.head;
    sh_w[2][wid] = w.vis;
  }
  __syncthreads();
  Tri agg = {0, 0, 0};
#pragma unroll
  for (int k = 0; k < kFsWarps; ++k)
    agg = combine(agg, {sh_w[0][k], sh_w[1][k], sh_w[2][k]});
  return agg;
}

// Exclusive scan of the threads' triples across the block: *ex gets this
// thread's prefix inside the block; returns the block's aggregate.
__device__ __forceinline__ Tri block_scan(Tri mine, int lane, int wid,
                                          unsigned (*sh_w)[kFsWarps],
                                          Tri* ex) {
  const Tri incl = warp_incl(mine, lane);
  if (lane == 31) {
    sh_w[0][wid] = incl.rank;
    sh_w[1][wid] = incl.head;
    sh_w[2][wid] = incl.vis;
  }
  const Tri ex_lane = shfl_up1(incl, lane);
  __syncthreads();
  Tri woff = {0, 0, 0}, agg = {0, 0, 0};
#pragma unroll
  for (int w = 0; w < kFsWarps; ++w) {
    const Tri s = {sh_w[0][w], sh_w[1][w], sh_w[2][w]};
    if (w < wid) woff = combine(woff, s);
    agg = combine(agg, s);
  }
  *ex = combine(woff, ex_lane);
  return agg;
}

// The segment scans of `rows` rows of length n, each on its own, starting
// from the carry-in of the earlier shards when `carry` is set. kWarpForm:
// one warp a row (n <= kFsWarpRow), kFsWarps rows a block. kBlockForm: one
// block a row (n <= kFsTile). kLookbackForm: tpr tiles a row, taken from
// the self-resetting ticket row after row; the look-back stays inside the
// row and tile 0 folds the carry-in into the prefix it publishes.
template <int kForm>
__global__ void __launch_bounds__(kFsThreads) fs_scan(FsArgs a) {
  __shared__ unsigned sh_w[3][kFsWarps];
  __shared__ int sh_tile;
  __shared__ unsigned sh_tag;
  __shared__ Tri sh_prefix;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;

  if constexpr (kForm == kWarpForm) {
    const int row = blockIdx.x * kFsWarps + wid;
    if (row >= a.rows) return;                   // the whole warp leaves
    const size_t roff = static_cast<size_t>(row) * a.n;
    const int i0 = lane * kFsItems;
    const long long f0 = static_cast<long long>(a.base) + i0;
    const long long ne = row_count(a, row);
    const Tri cpart = carry_part(a, row, lane);
    unsigned sm, vm;
    slot_masks(a.chain + roff, a.has + roff, a.n, i0, f0, ne, a.vec_in, &sm,
               &vm);
    const Tri ex = shfl_up1(warp_incl(thread_tri(sm, vm, f0), lane), lane);
    store_scans(a, roff, 0, lane, sm, vm, combine(warp_reduce(cpart), ex));
  } else {
    int row = blockIdx.x, ct = 0;
    unsigned tag = 0;
    if constexpr (kForm == kLookbackForm) {
      int tile;
      take_ticket(a.hdr, &sh_tile, &sh_tag, &tile, &tag);
      row = tile / a.tpr;
      ct = tile - row * a.tpr;
    }
    const size_t roff = static_cast<size_t>(row) * a.n;
    const int s0 = ct * kFsTile;                 // first slot of the tile
    const int i0 = s0 + t * kFsItems;            // first slot of the thread
    const long long f0 = static_cast<long long>(a.base) + i0;
    const long long ne = row_count(a, row);
    const Tri cpart = wid == 0 && ct == 0 ? carry_part(a, row, lane)
                                          : Tri{0, 0, 0};
    unsigned sm, vm;
    slot_masks(a.chain + roff, a.has + roff, a.n, i0, f0, ne, a.vec_in, &sm,
               &vm);
    Tri ex;
    const Tri agg = block_scan(thread_tri(sm, vm, f0), lane, wid, sh_w, &ex);
    if (wid == 0) {
      const Tri cin = warp_reduce(cpart);
      Tri pre = cin;
      if constexpr (kForm == kLookbackForm)
        pre = lookback_tri(
            a.words + static_cast<size_t>(row) * a.tpr * kFsWords, ct, agg,
            cin, lane, tag);
      if (lane == 0) sh_prefix = pre;
    }
    __syncthreads();
    if constexpr (kForm == kLookbackForm) {
      if (t == 0) arrive(a.hdr, a.words, a.word_cap);
    }
    store_scans(a, roff, s0 + wid * 32 * kFsItems, lane, sm, vm,
                combine(sh_prefix, ex));
  }
}

// Per row, the totals of its live slots: (segment starts, the latest
// segment-start slot or 0, visible count) into the int32 (rows, 3)
// `totals`, with plain stores. kWarpForm and kBlockForm: a warp or a block
// a row, as fs_scan cuts them. kLookbackForm (rows longer than a tile): a
// block a tile writes its partial (three words, upper halves 0, so that no
// fs_scan launch ever reads one as tagged) and counts itself in on the
// row's self-resetting counter; the row's last block folds the partials.
// No ticket, no look-back, no zeroed output.
template <int kForm>
__global__ void __launch_bounds__(kFsThreads) fs_totals(FsArgs a) {
  __shared__ unsigned sh_w[3][kFsWarps];
  __shared__ int sh_last;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;

  if constexpr (kForm == kWarpForm) {
    const int row = blockIdx.x * kFsWarps + wid;
    if (row >= a.rows) return;
    const size_t roff = static_cast<size_t>(row) * a.n;
    const int i0 = lane * kFsItems;
    const long long f0 = static_cast<long long>(a.base) + i0;
    unsigned sm, vm;
    slot_masks(a.chain + roff, a.has + roff, a.n, i0, f0, row_count(a, row),
               a.vec_in, &sm, &vm);
    const Tri tot = warp_reduce(thread_tri(sm, vm, f0));
    if (lane < 3)
      a.totals[static_cast<size_t>(row) * 3 + lane] =
          static_cast<int>(tri_get(tot, lane));
  } else {
    const int row = blockIdx.x / a.tpr;
    const int ct = blockIdx.x - row * a.tpr;
    const size_t roff = static_cast<size_t>(row) * a.n;
    const int i0 = ct * kFsTile + t * kFsItems;
    const long long f0 = static_cast<long long>(a.base) + i0;
    unsigned sm, vm;
    slot_masks(a.chain + roff, a.has + roff, a.n, i0, f0, row_count(a, row),
               a.vec_in, &sm, &vm);
    Tri agg = block_reduce(thread_tri(sm, vm, f0), lane, wid, sh_w);
    int* out = a.totals + static_cast<size_t>(row) * 3;
    if constexpr (kForm == kBlockForm) {
      if (t < 3) out[t] = static_cast<int>(tri_get(agg, t));
    } else {
      u64* part = a.words + static_cast<size_t>(row) * a.tpr * 3;
      if (t < 3) {
        st_status(part + ct * 3 + t, tri_get(agg, t));
        __threadfence();
      }
      __syncthreads();
      if (t == 0)
        sh_last = atomicInc(a.row_done + row, a.tpr - 1) == a.tpr - 1u;
      __syncthreads();
      if (!sh_last) return;
      __threadfence();
      Tri mine = {0, 0, 0};
      for (int k = t; k < a.tpr; k += kFsThreads) {
        const u64* w = part + k * 3;
        mine = combine(mine, {static_cast<unsigned>(ld_status(w)),
                              static_cast<unsigned>(ld_status(w + 1)),
                              static_cast<unsigned>(ld_status(w + 2))});
      }
      agg = block_reduce(mine, lane, wid, sh_w);
      if (t < 3) out[t] = static_cast<int>(tri_get(agg, t));
    }
  }
}

inline int num_tiles(int n, int tile) { return (n + tile - 1) / tile; }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The form a row of n slots (columns) takes (the host chooses the same).
inline int fs_form_of(int n) {
  return n <= kFsWarpRow ? kWarpForm : (n <= kFsTile ? kBlockForm
                                                     : kLookbackForm);
}

inline int ms_form_of(int n) {
  return n <= kMsWarpRow ? kWarpForm : (n <= kMsTile ? kBlockForm
                                                     : kLookbackForm);
}

// Where a look-back scratch of `counter_cap` row counters keeps its
// status words.
inline u64* status_words(void* scratch, int counter_cap) {
  return static_cast<u64*>(scratch) + kHeaderWords + (counter_cap + 1) / 2;
}

// The launch's arguments; returns false when the scratch cannot hold what
// the form needs (`counters` row counters, `words` 64-bit words).
bool fs_args(FsArgs* a, const void* chain, const void* has, int rows, int n,
             const void* n_elems, int ne_stride, long long ne_imm, int base,
             void* scratch, int counter_cap, long long word_cap,
             long long counters, long long words) {
  *a = FsArgs{};
  a->chain = static_cast<const unsigned char*>(chain);
  a->has = static_cast<const unsigned char*>(has);
  a->n = n;
  a->tpr = num_tiles(n, kFsTile);
  a->rows = rows;
  a->n_elems = static_cast<const int*>(n_elems);
  a->ne_stride = ne_stride;
  a->ne_imm = ne_imm;
  a->base = base;
  // every row must start on 16 bytes too: bool rows of a multiple of 16
  // slots
  a->vec_in = aligned16(chain) && aligned16(has) &&
              (rows == 1 || n % 16 == 0);
  if (ne_stride >= 0 && n_elems == nullptr) return false;
  if (counters > 0 || words > 0) {
    if (scratch == nullptr || counter_cap < counters || word_cap < words)
      return false;
    a->hdr = static_cast<unsigned*>(scratch);
    a->row_done = a->hdr + 4;
    a->words = status_words(scratch, counter_cap);
    a->word_cap = word_cap;
  }
  return true;
}

unsigned fs_blocks(int form, int rows, int tpr) {
  if (form == kWarpForm) return (rows + kFsWarps - 1) / kFsWarps;
  return static_cast<unsigned>(form == kBlockForm ? rows : rows * tpr);
}

}  // namespace

extern "C" {

// Columns of one multi_scan tile and slots of one segment-scan tile, and
// the longest warp-form rows: rows of at most amt_ms_warp_row() columns or
// amt_fs_warp_row() slots take a warp each, rows of at most a tile a block
// each, longer rows the look-back (amt_ms_form, amt_fs_form).
int amt_multi_scan_tile() { return kMsTile; }
int amt_fused_scan_tile() { return kFsTile; }
int amt_ms_warp_row() { return kMsWarpRow; }
int amt_fs_warp_row() { return kFsWarpRow; }
int amt_ms_form(int n) { return ms_form_of(n); }
int amt_fs_form(int n) { return fs_form_of(n); }

// y[r, :] = inclusive prefix sum of x[r, :], int32 (rows, n) row-major, in
// form `form` (amt_ms_form(n); anything else is refused). The look-back
// form needs the persistent scratch: int64 words [2 header]
// [ceil(counter_cap / 2) counters, unused here][word_cap status words],
// zeroed once when it was allocated, with word_cap >= rows * ceil(n /
// tile); the other forms take none (null). One launch, nothing else on
// the stream.
int amt_multi_scan(const void* x, void* y, int rows, int n, int form,
                   void* scratch, int counter_cap, long long word_cap,
                   void* stream) {
  if (rows <= 0 || n <= 0 || form != ms_form_of(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpr = num_tiles(n, kMsTile);
  const long long tiles = static_cast<long long>(rows) * tpr;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  MsArgs a{};
  a.x = static_cast<const int*>(x);
  a.y = static_cast<int*>(y);
  a.n = n;
  a.tpr = tpr;
  a.rows = rows;
  // every row must start on 16 bytes too: a multiple of 4 columns
  a.vec_in = n % 4 == 0 && aligned16(x);
  a.vec_out = n % 4 == 0 && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == kWarpForm) {
    ms_scan<kWarpForm><<<(rows + kMsWarps - 1) / kMsWarps, kMsThreads, 0,
                         s>>>(a);
  } else if (form == kBlockForm) {
    ms_scan<kBlockForm><<<rows, kMsThreads, 0, s>>>(a);
  } else {
    if (scratch == nullptr || counter_cap < 0 ||
        word_cap < kMsStatusWords * tiles)
      return static_cast<int>(cudaErrorInvalidValue);
    a.hdr = static_cast<u64*>(scratch);
    a.words = status_words(scratch, counter_cap);
    a.word_cap = word_cap;
    ms_scan<kLookbackForm><<<static_cast<unsigned>(tiles), kMsThreads, 0,
                             s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// (rank_incl, seg_head, cumvis) of `rows` rows of bool chain/has_value
// columns, each row n long and scanned on its own, in form `form`
// (amt_fs_form(n); anything else is refused). Row r's element count is
// n_elems[r * ne_stride] on the device, or ne_imm for every row when
// ne_stride < 0 (n_elems may then be null). `carry` (may be null): the
// int32 (n_shards, rows, 3) totals of every shard of a sharded column
// (amt_fs_totals), this shard at index `shard`; row r then starts from
// shards 0 .. shard - 1. The look-back form needs the persistent scratch:
// int64 words [2 header][ceil(counter_cap / 2) counters][word_cap status
// words], zeroed once when it was allocated, with word_cap >= 6 * rows *
// ceil(n / tile); the other forms take none (null). One launch, nothing
// else on the stream.
int amt_fused_segment_scans(const void* chain, const void* has, int rows,
                            int n, const void* n_elems, int ne_stride,
                            long long ne_imm, int base, const void* carry,
                            int shard, int form, void* scratch,
                            int counter_cap, long long word_cap, void* rank,
                            void* head, void* cumvis, void* stream) {
  if (rows <= 0 || n <= 0 || form != fs_form_of(n) || shard < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      static_cast<long long>(rows) * num_tiles(n, kFsTile);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  FsArgs a;
  if (!fs_args(&a, chain, has, rows, n, n_elems, ne_stride, ne_imm, base,
               scratch, counter_cap, word_cap, 0,
               form == kLookbackForm ? kFsWords * tiles : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  a.carry = static_cast<const int*>(carry);
  a.shard = shard;
  a.rank = static_cast<int*>(rank);
  a.head = static_cast<int*>(head);
  a.vis = static_cast<int*>(cumvis);
  // int32 rows must start on 16 bytes too: a multiple of 4 slots
  a.vec_out = aligned16(rank) && aligned16(head) && aligned16(cumvis) &&
              (rows == 1 || n % 4 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = fs_blocks(form, rows, a.tpr);
  if (form == kWarpForm)
    fs_scan<kWarpForm><<<blocks, kFsThreads, 0, s>>>(a);
  else if (form == kBlockForm)
    fs_scan<kBlockForm><<<blocks, kFsThreads, 0, s>>>(a);
  else
    fs_scan<kLookbackForm><<<blocks, kFsThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The int32 (rows, 3) totals (segment starts, latest segment-start slot
// or 0, visible count) of the live slots of `rows` rows of bool
// chain/has_value columns, each n long with first global slot `base`;
// element counts and the form as amt_fused_segment_scans takes them. Rows
// longer than a tile need the persistent scratch with counter_cap >= rows
// and word_cap >= 3 * rows * ceil(n / tile). Every total is written with a
// plain store: `out` needs no zeroing. One launch, nothing else.
int amt_fs_totals(const void* chain, const void* has, int rows, int n,
                  const void* n_elems, int ne_stride, long long ne_imm,
                  int base, int form, void* scratch, int counter_cap,
                  long long word_cap, void* out, void* stream) {
  if (rows <= 0 || n <= 0 || form != fs_form_of(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      static_cast<long long>(rows) * num_tiles(n, kFsTile);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool parts = form == kLookbackForm;
  FsArgs a;
  if (!fs_args(&a, chain, has, rows, n, n_elems, ne_stride, ne_imm, base,
               scratch, counter_cap, word_cap, parts ? rows : 0,
               parts ? 3 * tiles : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  a.totals = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = fs_blocks(form, rows, a.tpr);
  if (form == kWarpForm)
    fs_totals<kWarpForm><<<blocks, kFsThreads, 0, s>>>(a);
  else if (form == kBlockForm)
    fs_totals<kBlockForm><<<blocks, kFsThreads, 0, s>>>(a);
  else
    fs_totals<kLookbackForm><<<blocks, kFsThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
