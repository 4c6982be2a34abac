// The serial tail (K2) for Hopper (sm_90a).
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/superstep/csr_kernel.py. Every array is int32. A kernel
// launches on the caller's stream, never synchronises and allocates nothing;
// each launcher returns cudaGetLastError() so the wrapper can raise.
//
// K1, the CSR-resident superstep, is the same function as K3 over CSR rows
// of packed words: it runs as tile_kernels.cu's superstep_rows_kernel over
// source (e) (repro_superstep_csr there), whose header says what bounds it
// and how its design answers that.
//
// ---------------------------------------------------------------------------
// K2 serial_tail_csr_kernel
//   Replaces src/repro/kernels/superstep/csr_kernel.py:serial_tail_csr_kernel
//   (the Pallas grid=1 sequential tail).
//   The function: clear the colours of every tail entry, then, in tail
//   order (wl, order_tail: degree descending, ids ascending), give each
//   entry the smallest colour in [1, W+1] absent from its row's current
//   colours, later entries seeing earlier writes. Sentinels (v >= n) write
//   slot n = 0. `colors` (colors_ext, n+1) is updated in place, as the
//   Pallas kernel updates it through input_output_aliases.
//
//   That is greedy colouring in a fixed order, so entry r's colour depends
//   only on the fixed colours of its neighbours outside the tail and the
//   final colours of its neighbours of smaller rank (its position in wl).
//   K2 computes it as Jones-Plassmann with the rank as priority: every
//   entry runs at once and waits only for its earlier-ranked neighbours.
//   Read rule, for entry r (vertex v) and a lane's neighbour u, with
//   rank[u] built by the wrapper (-1 outside the tail and for slot n):
//     rank[u] <  0      colors[u], fixed for the whole launch;
//     0 <= rank[u] < r  wait until colors[u] != 0 (a real tail vertex
//                       always ends with a colour >= 1), then take it;
//     rank[u] >= r      0: u == v (self lanes of composed rows) or a later
//                       entry, whose slot is never read: rows need not be
//                       symmetric, so a later entry may already be done.
//   This is the sequential walk's view exactly, so the colours are bit for
//   bit the walk's. The wrapper clears the tail's colours and builds rank
//   before the launch. Precondition: the tail's real ids are distinct
//   (every caller passes a compacted worklist).
//
//   Bound on the card: max(bytes / HBM rate, depth x one L2 round trip).
//   The bytes are T * 20 B plus 8 B per neighbour read; depth is the
//   longest chain of "waits for" in the DAG the order puts on the rows
//   (32 on rmat-er's stall tail, 6,630 on thermal2's), not T. A level
//   costs a store, a poll and the poll's sleep, not one bare L2 hit, so
//   deep tails stay well above the depth bound; a tail whose depth is
//   about T (a banded Jacobian's columns in order) is a chain, slower than
//   a single warp walking it (PERF.md).
//
//   Schedule and forward progress: tail positions are handed out by a
//   ticket counter (one atomicAdd a block), not by blockIdx, since blocks
//   are not scheduled in order. An entry waits only on smaller ranks, which
//   were handed out earlier to threads that are running or done, so the
//   smallest unfinished rank can always proceed: no deadlock. Each wait is
//   bounded: after kMaxPolls polls the kernel traps, so a broken
//   precondition fails the launch instead of hanging it.
//
//   Memory model: a colour is stored with st.release.gpu and waited for
//   with volatile loads, which read L2 (never a stale L1 line). A block
//   holds consecutive ranks and keeps its entries' colours in shared memory
//   too (written before the store to L2), where its own later entries read
//   them: a link inside a block skips the round trip through L2. The ids in
//   wl, starts, degs, col and rank do not depend on colours and take the
//   read-only path. A row is read kChunk lanes at a time, all loads of a
//   chunk in flight together; an entry that waits polls only the slots it
//   still awaits, sleeping 32 ns, doubling to 256 ns, between polls.
//
//   Design: two layouts, chosen by the wrapper from W (the same colours
//   either way). Rows of up to 32 lanes: one thread per entry, 256
//   consecutive ranks a block, FirstFit in a register mask of colours
//   1..32 (W <= 32 needs nothing else); wider colours re-walk the row one
//   window of 32 at a time. Threads of one warp may wait on each other (a
//   grid row's left neighbour), so a thread never blocks: each pass walks
//   as far as its row is ready, stores the colour inside the pass that
//   finishes it, and otherwise sleeps and retries. No warp-wide operation
//   sits in that loop. Wider rows: one warp per entry, 8 a block, lanes
//   striding over the row; its lanes wait only on other warps, then
//   reduce and take common.cuh's FirstFit (register mask, then a per-warp
//   shared bitset of (W+1+31)/32 words).
// ---------------------------------------------------------------------------

#include "common.cuh"

namespace {

using repro::first_fit;
using repro::kFull;
using repro::low_bit;

// ---- K2 ----------------------------------------------------------------

constexpr int kTailThreads = 256;  // per-thread layout: entries a block
constexpr int kChunk = 8;          // lanes of a row whose loads fly together
constexpr int kTailWarps = 8;      // warp layout: entries a block
constexpr unsigned kPollNs = 32;      // first sleep of a waiting entry
constexpr unsigned kPollMaxNs = 256;  // sleeps double up to this
constexpr int kMaxPolls = 1 << 26;  // then trap: tens of seconds, never legitimate

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Where an entry reads the colour of an earlier entry u (rank ru): a
// block holds consecutive ranks from `lo`, and an entry of the same block is
// read from the block's shared copy (set before the store to L2); any
// other from u's slot in L2.
struct Links {
  int lo;
  const volatile int* s;  // the block's colours, 0 until set
  __device__ __forceinline__ int read(const int* colors, int u, int ru) const {
    return ru >= lo ? s[ru - lo] : load_volatile(colors + u);
  }
};

// What entry r sees of neighbour u once u is settled (the read rule with
// the wait already over): fixed colour, final colour, or 0.
__device__ __forceinline__ int settled_color(int u, int r, const int* __restrict__ rank,
                                             const int* colors, const Links& links) {
  const int ru = __ldg(rank + u);
  if (ru < 0) return colors[u];
  return ru < r ? links.read(colors, u, ru) : 0;
}

// One entry's walk over the lanes j, j + step, ... < d of its row, kChunk
// lanes at a time, their loads in flight together. The state lives in the
// caller's registers, so a walk that has to wait can be resumed.
struct RowWalk {
  int j;          // first lane of the current chunk
  bool open;      // the chunk is loaded and some colour is still awaited
  int u[kChunk];  // its neighbours (n past the row)
  int ru[kChunk];
  int c[kChunk];  // the colours read so far (0 while awaited)
};

// Advances `w` as far as the row is ready, calling f(c) with the colour each
// lane reads under the read rule. Never waits: returns false while a
// neighbour of smaller rank is not coloured yet (its slot is polled again
// by the next call, and nothing else), true once the whole row is read.
template <class F>
__device__ __forceinline__ bool advance(RowWalk& w, const int* __restrict__ row, int d,
                                        int step, int r, const int* __restrict__ rank,
                                        const int* colors, int n, const Links& links,
                                        const F& f) {
  for (;;) {
    if (!w.open) {
      if (w.j >= d) return true;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) w.u[k] = w.j + k * step < d ? row[w.j + k * step] : n;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) w.ru[k] = __ldg(rank + w.u[k]);  // rank[n] = -1
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        w.c[k] = w.ru[k] < 0 ? colors[w.u[k]]
                             : (w.ru[k] < r ? links.read(colors, w.u[k], w.ru[k]) : 0);
      w.open = true;
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (w.ru[k] >= 0 && w.ru[k] < r && w.c[k] == 0)
          w.c[k] = links.read(colors, w.u[k], w.ru[k]);
    }
    bool ready = true;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) ready = ready && !(w.ru[k] >= 0 && w.ru[k] < r && w.c[k] == 0);
    if (!ready) return false;
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (w.j + k * step < d) f(w.c[k]);
    w.j += kChunk * step;
    w.open = false;
  }
}

// Sleeps before the next poll of a waiting entry (doubling, up to a cap)
// and traps once it has polled kMaxPolls times.
__device__ __forceinline__ void backoff(int& polls, unsigned& sleep_ns) {
  if (++polls == kMaxPolls) __trap();
  __nanosleep(sleep_ns);
  sleep_ns = min(2 * sleep_ns, kPollMaxNs);
}

// Colours lo+1 .. lo+32 that are FirstFit candidates (<= W+1), as bits.
__device__ __forceinline__ unsigned window_bits(int W, int lo) {
  const int count = W + 1 - lo;
  return count >= 32 ? kFull : ((1u << count) - 1u);
}

template <bool kPerThread>
__global__ void __launch_bounds__(kPerThread ? kTailThreads : kTailWarps * 32)
serial_tail_csr_kernel(const int* __restrict__ wl, const int* __restrict__ starts,
                       const int* __restrict__ degs, const int* __restrict__ col,
                       const int* __restrict__ rank, int* colors, int* ticket,
                       int T, int W, int n) {
  constexpr int kEntries = kPerThread ? kTailThreads : kTailWarps;  // a block's
  extern __shared__ unsigned smem[];
  __shared__ int base;
  __shared__ volatile int s_c[kEntries];  // the block's colours, 0 until set
  if (threadIdx.x == 0) base = atomicAdd(ticket, kEntries);
  if (threadIdx.x < kEntries) s_c[threadIdx.x] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = base + (kPerThread ? threadIdx.x : warp);
  if (r >= T) return;
  const int v = wl[r];
  if (v >= n) return;  // a sentinel: slot n was cleared before the launch
  const int* row = col + starts[r];
  const int d = min(degs[r], W);
  const Links links{base, s_c};
  unsigned m = 0;
  auto mask_low = [&](int c) { m |= low_bit(c); };
  RowWalk w;
  w.j = kPerThread ? 0 : lane;
  w.open = false;
  int polls = 0;
  unsigned sleep_ns = kPollNs;

  if constexpr (kPerThread) {
    // a thread may wait on another thread of its warp: it never blocks, and
    // stores its colour inside the pass that finishes its row
    for (;;) {
      if (advance(w, row, d, 1, r, rank, colors, n, links, mask_low)) {
        int lo = 0;
        unsigned free = ~m & window_bits(W, 0);
        while (!free) {  // colours 1..lo+32 all taken: the next window
          lo += 32;
          m = 0;
          RowWalk again;
          again.j = 0;
          again.open = false;
          advance(again, row, d, 1, r, rank, colors, n, links, [&](int c) {
            const unsigned k = unsigned(c - lo - 1);
            if (k < 32u) m |= 1u << k;
          });  // every earlier neighbour is settled: one pass
          free = ~m & window_bits(W, lo);
        }
        s_c[threadIdx.x] = lo + __ffs(free);
        store_release(colors + v, lo + __ffs(free));
        return;
      }
      backoff(polls, sleep_ns);
    }
  } else {
    // lanes wait only on other warps' entries
    while (!advance(w, row, d, 32, r, rank, colors, n, links, mask_low)) backoff(polls, sleep_ns);
    m = __reduce_or_sync(kFull, m);
    const int ff = first_fit(
        m, [&](int j) { return settled_color(row[j], r, rank, colors, links); }, d, W,
        smem + warp * repro::bitset_words(W));
    if (lane == 0) {
      s_c[warp] = ff;
      store_release(colors + v, ff);
    }
  }
}

}  // namespace

extern "C" {

// K2. Updates colors (n+1) in place; rank (n+1) and a zeroed ticket come
// from the wrapper, which has cleared the tail's colours. per_thread picks
// the layout (see K2's header). Returns a cudaError_t.
int repro_serial_tail_csr(const void* wl, const void* starts, const void* degs,
                          const void* col, const void* rank, void* colors, void* ticket,
                          int T, int W, int n, int per_thread, void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(wl);
  const int* s = static_cast<const int*>(starts);
  const int* d = static_cast<const int*>(degs);
  const int* c = static_cast<const int*>(col);
  const int* r = static_cast<const int*>(rank);
  int* out = static_cast<int*>(colors);
  int* t = static_cast<int*>(ticket);
  if (per_thread) {
    serial_tail_csr_kernel<true><<<(T + kTailThreads - 1) / kTailThreads, kTailThreads, 0,
                                    st>>>(a, s, d, c, r, out, t, T, W, n);
  } else {
    const size_t smem = size_t(kTailWarps) * repro::bitset_words(W) * sizeof(unsigned);
    if (const int e = repro::allow_smem(serial_tail_csr_kernel<false>, smem)) return e;
    serial_tail_csr_kernel<false><<<(T + kTailWarps - 1) / kTailWarps, kTailWarps * 32, smem,
                                     st>>>(a, s, d, c, r, out, t, T, W, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
