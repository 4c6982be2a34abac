// CSR-resident superstep (K1) and serial tail (K2) for Hopper (sm_90a).
//
// Plain C interface, loaded with ctypes by
// repro_torch/kernels/superstep/csr_kernel.py. Every array is int32. A kernel
// launches on the caller's stream, never synchronises and allocates nothing;
// each launcher returns cudaGetLastError() so the wrapper can raise.
//
// ---------------------------------------------------------------------------
// K1 superstep_csr_kernel
//   Replaces src/repro/kernels/superstep/csr_kernel.py:superstep_csr_kernel
//   (the Pallas CSR-resident rotated superstep).
//   For each worklist id v: read v's row of C straight from CSR storage,
//   decide conflicts on the packed words (color | deg << 16) of v and its
//   neighbours, treat the neighbours v beats as colour 0, and FirstFit the
//   smallest colour in [1, W+1] (W = the class width, not v's degree).
//   Writes (need ? ff : color(v), need). It reads `packed` and never writes
//   it: every class of a superstep reads the same iteration-start snapshot.
//
//   Bound on the card: bytes. Per worklist entry it reads wl, R[v], R[v+1]
//   and packed[v] and writes two words (24 B); per neighbour it reads C and
//   packed[u] (8 B), scattered. Operations per byte are a handful of
//   integer ops, far below the card's ratio.
//
//   Design: one warp per worklist vertex, lanes striding over the row, so a
//   row's C reads coalesce and the packed[u] gathers of a row are in flight
//   together. The loser test runs per lane and __any_sync reduces `need`.
//   FirstFit is common.cuh's (shared with K2, K3 and K4): colours 1..32
//   in a per-lane register mask OR-reduced across the warp
//   (__reduce_or_sync), __ffs on its complement, and only when all 32 are
//   taken (W >= 32) a per-warp bitset of (W+1+31)/32 words in shared
//   memory. So any W up to PACKED_GATHER_MAX_DEG - 1 = 32766 works (at
//   most 1024 words a warp).
//
//   Sentinels: worklists are padded with n; packed[n] == 0, so a sentinel
//   has degree 0 and colour 0 and reads no row. The caller masks
//   need &= v < n and writes 0 to slot n, as repro's caller does.
//   v's row is C[R[v] : R[v+1]], cut to W lanes; lanes past it are inert in
//   the reference (their colour is 0: never equal to a nonzero colour,
//   never forbidden), so looping the lanes up to min(R[v+1] - R[v], W)
//   computes the same thing. The row's length comes from R, not from the
//   packed degree: over G^2 (distance-2, precomputed) the packed degree is
//   the original graph's, which the loser rule reads, and the row is G^2's.
//   (src/repro's Pallas kernel masks at the packed degree and so reads only
//   the first deg_G(v) lanes of a G^2 row.)
//
// ---------------------------------------------------------------------------
// K2 serial_tail_csr_kernel
//   Replaces src/repro/kernels/superstep/csr_kernel.py:serial_tail_csr_kernel
//   (the Pallas grid=1 sequential tail).
//   Clears the colours of every worklist vertex, then, in worklist order
//   (order_tail: degree descending, ids ascending), gives each vertex the
//   smallest colour in [1, W+1] that none of its neighbours' current
//   colours holds. Later vertices see earlier writes. Sentinels write slot
//   n = 0. `colors` (colors_ext, n+1) is updated in place, as the Pallas
//   kernel updates it through input_output_aliases.
//
//   Bound on the card: the dependent chain, not bytes. The bytes are
//   T * 20 B plus 8 B per neighbour, but vertex i+1 may read the colour
//   vertex i writes, so T steps run one after another, each at least one
//   round trip to L1/L2 for the neighbours' colours.
//
//   Design: one block of one warp (32 threads), so a vertex's step needs
//   only __syncwarp, not a block barrier. wl, starts and degs do not depend
//   on the colours, so they are read two vertices ahead and the first 32
//   neighbour ids one vertex ahead; the chain per vertex is one colour read
//   per lane, a warp OR-reduce, __ffs and one store. The Pallas kernel's
//   (W+1) x W candidate compare is not carried over: the same register
//   mask / shared bitset FirstFit as K1 finds the colour in O(deg) work.
//   After lane 0 stores colors[v], __syncwarp orders that store before the
//   warp's next reads.
// ---------------------------------------------------------------------------

#include "common.cuh"

namespace {

using repro::first_fit;
using repro::kFull;
using repro::low_bit;

constexpr int kWarpsPerBlock = 8;  // K1: one worklist vertex per warp

template <bool kDegreeRule>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
superstep_csr_kernel(const int* __restrict__ wl, const int* __restrict__ row_starts,
                     const int* __restrict__ col, const int* __restrict__ packed,
                     int* __restrict__ newc, int* __restrict__ need_out,
                     int w, int W, int n) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= w) return;  // whole warps leave together
  unsigned* words = smem + warp * repro::bitset_words(W);

  const int v = wl[i];
  const int mypk = packed[v];  // sentinel n -> 0: colour 0, degree 0
  const int my_c = mypk & 0xFFFF;
  const int my_d = mypk >> 16;
  const int start = row_starts[min(v, n - 1)];
  const int d = v < n ? min(row_starts[v + 1] - start, W) : 0;

  // colour this lane's neighbour shows to FirstFit: neighbours v beats
  // (same colour, v wins the rule) count as cleared
  auto refit_color = [&](int u, int upk, bool* lose) {
    const int nc = upk & 0xFFFF;
    if (my_c > 0 && nc == my_c) {
      const int nd = upk >> 16;
      const bool l = repro::beats<kDegreeRule>(u, nd, v, my_d);
      *lose = *lose || l;
      return l ? nc : 0;
    }
    return nc;
  };

  bool lose = false;
  unsigned m = 0;
  for (int j = lane; j < d; j += 32) {
    const int u = col[start + j];
    m |= low_bit(refit_color(u, packed[u], &lose));
  }
  const bool need = __any_sync(kFull, lose) || my_c == 0;
  int out = my_c;
  if (need) {
    m = __reduce_or_sync(kFull, m);
    bool unused = false;
    out = first_fit(m, [&](int j) {
      const int u = col[start + j];
      return refit_color(u, packed[u], &unused);
    }, d, W, words);
  }
  if (lane == 0) {
    newc[i] = out;
    need_out[i] = need ? 1 : 0;
  }
}

__global__ void __launch_bounds__(32)
serial_tail_csr_kernel(const int* __restrict__ wl, const int* __restrict__ starts,
                       const int* __restrict__ degs, const int* __restrict__ col,
                       int* colors, int T, int W, int n) {
  extern __shared__ unsigned words[];
  const int lane = threadIdx.x;

  for (int i = lane; i < T; i += 32) colors[wl[i]] = 0;  // sentinels: slot n
  __syncwarp();

  // pipeline: (v, s, d, u) of vertex i; (v1, s1, d1) of vertex i+1
  int v = wl[0], s = starts[0], d = min(degs[0], W);
  int u = lane < d ? col[s + lane] : n;
  int v1 = n, s1 = 0, d1 = 0;
  if (T > 1) { v1 = wl[1]; s1 = starts[1]; d1 = min(degs[1], W); }
  for (int i = 0; i < T; ++i) {
    // reads for later vertices first: they do not wait on colours
    const int u1 = lane < d1 ? col[s1 + lane] : n;
    int v2 = n, s2 = 0, d2 = 0;
    if (i + 2 < T) { v2 = wl[i + 2]; s2 = starts[i + 2]; d2 = min(degs[i + 2], W); }

    unsigned m = lane < d ? low_bit(colors[u]) : 0u;
    for (int j = lane + 32; j < d; j += 32) m |= low_bit(colors[col[s + j]]);
    m = __reduce_or_sync(kFull, m);
    const int ff = first_fit(m, [&](int j) { return colors[col[s + j]]; }, d, W, words);
    if (lane == 0) colors[v] = v < n ? ff : 0;
    __syncwarp();

    v = v1; s = s1; d = d1; u = u1;
    v1 = v2; s1 = s2; d1 = d2;
  }
}

}  // namespace

extern "C" {

// K1. heuristic: 0 = id rule, 1 = degree rule. Returns a cudaError_t.
int repro_superstep_csr(const void* wl, const void* row_starts, const void* col,
                        const void* packed, void* newc, void* need, int w, int W,
                        int n, int degree_rule, void* stream) {
  if (w <= 0) return 0;
  const size_t smem = size_t(kWarpsPerBlock) * repro::bitset_words(W) * sizeof(unsigned);
  const dim3 grid((w + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(wl);
  const int* r = static_cast<const int*>(row_starts);
  const int* c = static_cast<const int*>(col);
  const int* p = static_cast<const int*>(packed);
  int* o = static_cast<int*>(newc);
  int* q = static_cast<int*>(need);
  if (degree_rule)
    superstep_csr_kernel<true><<<grid, block, smem, st>>>(a, r, c, p, o, q, w, W, n);
  else
    superstep_csr_kernel<false><<<grid, block, smem, st>>>(a, r, c, p, o, q, w, W, n);
  return static_cast<int>(cudaGetLastError());
}

// K2. Updates colors (n+1) in place. Returns a cudaError_t.
int repro_serial_tail_csr(const void* wl, const void* starts, const void* degs,
                          const void* col, void* colors, int T, int W, int n,
                          void* stream) {
  if (T <= 0) return 0;
  const size_t smem = size_t(repro::bitset_words(W)) * sizeof(unsigned);
  if (const int e = repro::allow_smem(serial_tail_csr_kernel, smem)) return e;
  serial_tail_csr_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wl), static_cast<const int*>(starts),
      static_cast<const int*>(degs), static_cast<const int*>(col),
      static_cast<int*>(colors), T, W, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
