// The row-resident kernels for Hopper (sm_90a): the superstep (K1 and K3,
// one kernel body), FirstFit (K4) and the conflict test (K5), each reading
// its rows where they lie.
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/superstep/
// kernel.py (K3), kernels/superstep/csr_kernel.py (K1), kernels/firstfit/
// kernel.py (K4) and kernels/conflict/kernel.py (K5). Every array is int32;
// row offsets are 64-bit. A kernel launches on the caller's stream, never
// synchronises and allocates nothing; each launcher returns
// cudaGetLastError() so the wrapper can raise.
//
// ---------------------------------------------------------------------------
// K1 and K3 superstep_rows_kernel
//   Replaces src/repro/kernels/superstep/kernel.py:superstep_kernel (K3,
//   over caller-gathered tiles) and src/repro/kernels/superstep/
//   csr_kernel.py:superstep_csr_kernel (K1, over CSR rows of packed
//   color | deg << 16 words). One body computes both functions, which are
//   the same: for row i (vertex v, colour c, degree d), the lanes whose
//   neighbour u holds c > 0 are tested with K5's rule; v loses when some
//   such u beats v, and the lanes v beats count as colour 0 (they recolour
//   too). FirstFit runs in [1, W+1] over the lanes' colours so cleared.
//   Writes newc = need ? ff : c and need = lose || c == 0. Sentinel
//   masking (need &= v < n) is the caller's, as in repro. It reads the
//   colours and never writes them, so every row of a launch sees the same
//   state (the engine's iteration-start snapshot, or the colours before a
//   chunk).
//
// K4 firstfit_rows_kernel
//   Replaces src/repro/kernels/firstfit/kernel.py:firstfit_kernel.
//   out[i] = the smallest colour in [1, W+1] absent from the colours of
//   row i's lanes.
//
// K5 conflict_rows_kernel
//   Replaces src/repro/kernels/conflict/kernel.py:conflict_kernel.
//   lose[i] = row i's vertex v holds a colour c > 0 and some lane's
//   neighbour u holds c and beats v: under the id rule v loses when v < u;
//   under the degree rule when deg(u) > deg(v), or the degrees are equal
//   and u < v.
//
// Lane sources (a row's lanes, and how a lane yields its neighbour's id,
// colour and degree). The Pallas kernels take (c) only; K4 and K5 run over
// (a)-(c), K3 over (a), (c), (d) and (f), K1 over (e). Colours come from
// colors_ext and degrees from deg_ext, n + 1 words with the sentinel's 0
// in slot n, read in place, except where a source says otherwise. Ids >= n
// read no lane.
//   (a) IdLanes<kTable>: row ids[i] of a table of neighbour ids, rows
//       `stride` words apart (the padded engine's (n, Δmax) table, or the
//       classic engine's sliced to a class width W), read up to
//       min(deg[v], W) lanes: the table pads every row past its degree with
//       the sentinel n, so the lanes skipped hold colour 0.
//   (b) IdLanes<kTile>: row i of a (w, W) tile of neighbour ids the caller
//       gathered (d2_sgr_step's composed two-hop rows, which may hold self,
//       duplicate and sentinel lanes), all W lanes.
//   (c) TileLanes: (w, W) tiles of neighbour ids, colours and degrees and
//       per row the vertex, its colour and degree, all gathered by the
//       caller (the Pallas kernels' signature: superstep_tile,
//       firstfit_tile, conflict_tile).
//   (d) IdLanes<kCsr>: row ids[i] of a CSR graph, C[R[v] : R[v] +
//       min(R[v+1] - R[v], W)]: the length comes from R, not from deg_ext,
//       which over G² holds the original graph's degrees for the loser
//       rule. Chunked worklists, degrees past the packed word.
//   (e) IdLanes<kCsr, packed>: as (d), with colour and degree read from
//       one packed word color | deg << 16 per vertex (K1's source).
//   (f) TwoHopLanes: row ids[i] composed of two tables, as repro's
//       TwoHopRows gathers it: local row l = v - start of adj_a (clamped
//       to [0, n_rows), as repro clamps the gather; ids >= n or with
//       v - start >= n_rows read no lane), its hop-1 lanes adj_a[l][k] for
//       k < min(deg_a[l], W1) (themselves lanes when first_hop), and for
//       each such mid id below n_mid the hop-2 lanes adj_b[mid][k2] for
//       k2 < min(deg_b[mid], W2). Lanes past a degree hold the table's
//       sentinel (n_mid in adj_a, n in adj_b) and show colour 0, so every
//       answer is the full composed row's.
//   Which lanes are read, and in what order, changes no answer: each
//   function depends on the multiset of lanes only, and sentinel lanes
//   (colour 0) never clash and are never forbidden.
//
// Bound on the card: bytes. Each word read once and each written once. K3
// and K1 read w ids, w own colours and degrees, the lanes read (table, C or
// the two tables' words, and R's two words a row for CSR rows), each
// distinct neighbour's colour, and the degree of each distinct neighbour on
// a lane that holds its row's nonzero colour, and write 2w words; over (c)
// they read 3w row words, w*W neighbour colours and the ids and degrees of
// the matching lanes. K4 over (a) reads w ids, Σ min(deg, W) table lanes
// and each distinct neighbour's colour, and writes w; K5 adds w own colours
// and degrees and, under the degree rule, the degrees of the neighbours on
// lanes that hold the row's colour; a row of colour 0 needs none of its
// lanes. Over (c) K4 reads w*W words and K5 3*w*W + 3*w. Per word they do a
// few integer operations, far below the card's ratio of operations to
// bytes. What holds them above that bound is each lane's colour: a 4-byte
// read at a random place, served as a 32-byte sector (chip_smoke.py times
// the rate of such reads beside each kernel).
//
// Design. A group of G lanes takes a row (G in 1, 4, 8, 16, 32, chosen by
// the wrapper from W and the source: a thread a row for narrow rows, so no
// lane idles at W = 8; 8 lanes for rows read up to a degree, whose lengths
// are short whatever W; a warp for wide rows read in full, and wherever
// smaller groups' bitsets would not fit a block), so a warp takes 32 / G
// rows at once. The grid is as many 256-thread blocks as are resident on
// the card, and each warp strides over the rows, loading the next pass's
// row id before it works on the current row, so a warp lives long and
// keeps loads in flight. The chain per row is short: the row id; then the
// vertex's colour and degree and the row's first table, C or R words; then
// the lanes' colours (L2-resident: 4 B x (n + 1)); a neighbour's degree is
// read only on lanes whose colour matches the row's, and for K5 a row of
// colour 0 reads no lane. Two-hop rows: the group's lanes load up to G
// hop-1 ids and their hop-2 degrees at once, then walk those mid rows one
// by one, the ids and degrees broadcast by shuffles, the group's lanes
// striding over each mid row, so a mid row's table words coalesce and no
// lane waits on a chain of hop-1 loads. The colours and degrees do not
// change during a launch, so all reads go through the read-only path.
// FirstFit is common.cuh's for a group of G lanes: a register mask of
// colours 1..32 reduced over the group, and only when all 32 are taken a
// per-group shared bitset of (W+1+31)/32 words that the group fills by
// reading its row again, 256 / G bitsets a block (above 48 KB the launcher
// asks for more dynamic shared memory, and the wrappers refuse a layout
// whose bitsets pass the 227 KB a block can have: kkt_power's W = 144,504
// fits with a warp a row, 8 bitsets of 18 KB). K3's superstep reads each
// lane once on its first pass, the FirstFit mask and the loser test
// together; only a row that takes the bitset path reads its lanes again.
// ---------------------------------------------------------------------------

#include <type_traits>

#include "common.cuh"

namespace {

using repro::beats;
using repro::kFull;
using repro::low_bit;

constexpr int kRowThreads = 256;  // threads a block

// One row as a lane group sees it.
struct Row {
  int v;        // the row's vertex
  int c, d;     // its colour and degree
  int len;      // lanes to read (two-hop rows: hop-1 lanes)
  size_t base;  // offset of lane 0
};

// Calls f(u, c, j) for lanes j = glane, glane + G, ... < r.len of a flat
// row: the lane's neighbour u and the colour c it holds.
template <int G, class Src, class F>
__device__ __forceinline__ void each_flat(const Src& src, const Row& r, int glane, const F& f) {
#pragma unroll 4
  for (int j = glane; j < r.len; j += G) {
    int u;
    const int c = src.color(r, j, u);
    f(u, c, j);
  }
}

// Sources (a), (b), (d) and (e): lanes hold neighbour ids.
enum class Rows { kTable, kTile, kCsr };

template <Rows kRows, bool kPacked = false>
struct IdLanes {
  const int* ids;
  const int* rows;    // (a) the table, (b) the gathered id tile, (d, e) C
  const int* starts;  // (d, e) R, n + 1 words
  long long stride;   // (a, b) words between two rows of `rows`
  const int* colors;  // colors_ext, or (e) the packed words, n + 1 each
  const int* deg;     // deg_ext, n + 1 words; (a) bounds the lanes read (K4: may be null)
  int n, W;

  __device__ int key(long long i) const { return __ldg(ids + i); }

  template <bool kOwnColor, bool kOwnDegree>
  __device__ Row row(long long i, int v) const {
    Row r;
    r.v = v;
    const bool real = v < n;
    if constexpr (kRows == Rows::kTable) {
      r.base = size_t(real ? v : 0) * size_t(stride);
      r.len = !real ? 0 : deg ? min(__ldg(deg + v), W) : W;
    } else if constexpr (kRows == Rows::kTile) {
      r.base = size_t(i) * size_t(stride);
      r.len = W;
    } else {
      const int s = __ldg(starts + (real ? v : 0));
      r.base = size_t(s);
      r.len = real ? min(__ldg(starts + v + 1) - s, W) : 0;
    }
    const int own = min(v, n);
    if constexpr (kPacked) {
      const int pk = (kOwnColor || kOwnDegree) ? __ldg(colors + own) : 0;
      r.c = pk & 0xFFFF;
      r.d = pk >> 16;
    } else {
      r.c = kOwnColor ? __ldg(colors + own) : 0;
      r.d = kOwnDegree ? __ldg(deg + own) : 0;
    }
    return r;
  }

  __device__ int color(const Row& r, int j, int& u) const {
    u = __ldg(rows + r.base + j);
    const int c = __ldg(colors + u);
    return kPacked ? c & 0xFFFF : c;
  }
  __device__ int id(const Row&, int, int u) const { return u; }
  __device__ int degree(const Row&, int, int u) const {
    return kPacked ? __ldg(colors + u) >> 16 : __ldg(deg + u);
  }
  template <int G, class F>
  __device__ void each(const Row& r, int glane, unsigned, const F& f) const {
    each_flat<G>(*this, r, glane, f);
  }
};

// Source (c): lanes hold ids, colours and degrees already.
struct TileLanes {
  const int* ids;
  const int* my_c;
  const int* my_d;
  const int* nid;
  const int* nc;
  const int* nd;
  int W;

  __device__ int key(long long) const { return 0; }

  template <bool kOwnColor, bool kOwnDegree>
  __device__ Row row(long long i, int) const {
    Row r{0, 0, 0, W, size_t(i) * size_t(W)};
    if (kOwnColor) {
      r.v = ids[i];
      r.c = my_c[i];
    }
    if (kOwnDegree) r.d = my_d[i];
    return r;
  }

  __device__ int color(const Row& r, int j, int&) const { return nc[r.base + j]; }
  __device__ int id(const Row& r, int j, int) const { return nid[r.base + j]; }
  __device__ int degree(const Row& r, int j, int) const { return nd[r.base + j]; }
  template <int G, class F>
  __device__ void each(const Row& r, int glane, unsigned, const F& f) const {
    each_flat<G>(*this, r, glane, f);
  }
};

// Source (f): composed two-hop rows (see the header).
struct TwoHopLanes {
  const int* ids;
  const int* adj_a;  // (n_rows, W1), rows stride_a words apart
  const int* adj_b;  // (n_mid, W2), rows stride_b words apart
  const int* deg_a;  // n_rows words: lanes of each adj_a row to read
  const int* deg_b;  // n_mid words
  const int* colors;
  const int* deg;
  long long stride_a, stride_b;
  int W1, W2, n_rows, n_mid, start, n;
  bool first_hop;  // hop-1 ids are lanes too (distance-2)

  __device__ int key(long long i) const { return __ldg(ids + i); }

  template <bool kOwnColor, bool kOwnDegree>
  __device__ Row row(long long, int v) const {
    Row r;
    r.v = v;
    const int l = v - start;
    const bool valid = v < n && l < n_rows;
    const int lc = min(max(l, 0), n_rows - 1);
    r.base = size_t(lc) * size_t(stride_a);
    r.len = valid ? min(__ldg(deg_a + lc), W1) : 0;
    const int own = min(v, n);
    r.c = kOwnColor ? __ldg(colors + own) : 0;
    r.d = kOwnDegree ? __ldg(deg + own) : 0;
    return r;
  }

  __device__ int id(const Row&, int, int u) const { return u; }
  __device__ int degree(const Row&, int, int u) const { return __ldg(deg + u); }

  template <int G, class F>
  __device__ void each(const Row& r, int glane, unsigned gmask, const F& f) const {
    for (int k0 = 0; k0 < r.len; k0 += G) {  // group-uniform
      const int k = k0 + glane;
      const int mid = k < r.len ? __ldg(adj_a + r.base + k) : n_mid;
      if (first_hop && k < r.len) f(mid, __ldg(colors + mid), k);
      const int dmid = mid < n_mid ? min(__ldg(deg_b + mid), W2) : 0;
      const int count = min(G, r.len - k0);
      for (int t = 0; t < count; ++t) {  // group-uniform
        int mt = mid, dt = dmid;
        if constexpr (G > 1) {
          mt = __shfl_sync(gmask, mid, t, G);
          dt = __shfl_sync(gmask, dmid, t, G);
        }
        const int* row2 = adj_b + size_t(mt) * size_t(stride_b);
#pragma unroll 4
        for (int j = glane; j < dt; j += G) {
          const int u = __ldg(row2 + j);
          f(u, __ldg(colors + u), j);
        }
      }
    }
  }
};

// A lane's place: G lanes a row, 32 / G rows a warp, the grid striding.
template <int G>
struct Lanes {
  static constexpr int kRowsPerWarp = 32 / G;
  int glane;        // lane in the group
  int group;        // group in the warp
  unsigned mask;    // the group's lanes
  long long first;  // the warp's first row
  long long step;   // rows all warps take in one pass

  __device__ Lanes() {
    const int lane = threadIdx.x & 31;
    glane = lane % G;
    group = lane / G;
    mask = G == 32 ? kFull : (((1u << G) - 1u) << (group * G));
    first = ((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
            kRowsPerWarp;
    step = ((static_cast<long long>(gridDim.x) * blockDim.x) >> 5) * kRowsPerWarp;
  }
};

template <int G>
__device__ __forceinline__ unsigned group_or(unsigned x, unsigned mask) {
  if constexpr (G == 1) return x;
  else return __reduce_or_sync(mask, x);
}

template <int G>
__device__ __forceinline__ bool group_any(bool p, unsigned mask) {
  if constexpr (G == 1) return p;
  else return __any_sync(mask, p);
}

// ---------------------------------------------------------------------------
// K1 and K3: the superstep
// ---------------------------------------------------------------------------

template <int G, bool kDegreeRule, class Src>
__global__ void __launch_bounds__(kRowThreads)
superstep_rows_kernel(const Src src, int* __restrict__ newc, int* __restrict__ need_out,
                      int w, int W) {
  extern __shared__ unsigned smem[];
  const Lanes<G> l;
  unsigned* words = smem + (threadIdx.x / G) * repro::bitset_words(W);
  long long i = l.first + l.group;
  int key = i < w ? src.key(i) : 0;
  for (long long pass = l.first; pass < w; pass += l.step) {  // warp-uniform
    const long long next = i + l.step;
    const int key_next = next < w ? src.key(next) : 0;
    if (i < w) {  // group-uniform
      const Row r = src.template row<true, kDegreeRule>(i, key);
      // the colour a lane shows to FirstFit: neighbours the row beats count
      // as cleared; `lose` gathers the lanes that beat the row
      auto refit = [&](int u, int c, int j, bool& lose) {
        if (r.c > 0 && c == r.c) {
          const bool beaten =
              beats<kDegreeRule>(src.id(r, j, u), kDegreeRule ? src.degree(r, j, u) : 0,
                                 r.v, r.d);
          lose = lose || beaten;
          return beaten ? c : 0;
        }
        return c;
      };
      bool lose = false;
      unsigned m = 0;
      src.template each<G>(r, l.glane, l.mask,
                           [&](int u, int c, int j) { m |= low_bit(refit(u, c, j, lose)); });
      const bool need = group_any<G>(lose, l.mask) || r.c == 0;
      int out = r.c;
      if (need) {  // group-uniform
        m = group_or<G>(m, l.mask);
        out = repro::first_fit_visit<G>(
            m,
            [&](const auto& mark) {
              bool unused = false;
              src.template each<G>(r, l.glane, l.mask, [&](int u, int c, int j) {
                mark(refit(u, c, j, unused));
              });
            },
            W, words, l.glane, l.mask);
      }
      if (l.glane == 0) {
        newc[i] = out;
        need_out[i] = need ? 1 : 0;
      }
    }
    i = next;
    key = key_next;
  }
}

// ---------------------------------------------------------------------------
// K4 and K5
// ---------------------------------------------------------------------------

template <int G, class Src>
__global__ void __launch_bounds__(kRowThreads)
firstfit_rows_kernel(const Src src, int* __restrict__ out, int w, int W) {
  extern __shared__ unsigned smem[];
  const Lanes<G> l;
  unsigned* words = smem + (threadIdx.x / G) * repro::bitset_words(W);
  long long i = l.first + l.group;
  int key = i < w ? src.key(i) : 0;
  for (long long pass = l.first; pass < w; pass += l.step) {  // warp-uniform
    const long long next = i + l.step;
    const int key_next = next < w ? src.key(next) : 0;
    if (i < w) {  // group-uniform
      const Row r = src.template row<false, false>(i, key);
      auto color_of = [&](int j) {
        int u;
        return src.color(r, j, u);
      };
      unsigned m = 0;
#pragma unroll 4
      for (int j = l.glane; j < r.len; j += G) m |= low_bit(color_of(j));
      m = group_or<G>(m, l.mask);
      const int ff =
          repro::first_fit_group<G>(m, color_of, r.len, W, words, l.glane, l.mask);
      if (l.glane == 0) out[i] = ff;
    }
    i = next;
    key = key_next;
  }
}

template <int G, bool kDegreeRule, class Src>
__global__ void __launch_bounds__(kRowThreads)
conflict_rows_kernel(const Src src, int* __restrict__ lose_out, int w) {
  const Lanes<G> l;
  long long i = l.first + l.group;
  int key = i < w ? src.key(i) : 0;
  for (long long pass = l.first; pass < w; pass += l.step) {  // warp-uniform
    const long long next = i + l.step;
    const int key_next = next < w ? src.key(next) : 0;
    if (i < w) {  // group-uniform
      const Row r = src.template row<true, kDegreeRule>(i, key);
      bool lose = false;
      if (r.c > 0) {  // a row of colour 0 cannot lose: it reads no lane
#pragma unroll 4
        for (int j = l.glane; j < r.len; j += G) {
          int u;
          if (src.color(r, j, u) == r.c &&
              beats<kDegreeRule>(src.id(r, j, u), kDegreeRule ? src.degree(r, j, u) : 0,
                                 r.v, r.d))
            lose = true;
        }
      }
      lose = group_any<G>(lose, l.mask);
      if (l.glane == 0) lose_out[i] = lose ? 1 : 0;
    }
    i = next;
    key = key_next;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int sm_count() {
  static const int count = [] {
    int dev = 0, c = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    return c;
  }();
  return count;
}

// Launches `kernel` (G lanes a row) with as many blocks as stay resident,
// and no more than the rows need. bitset: FirstFit's scratch (K1, K3, K4).
template <int G, class Kernel, class... Args>
int launch_rows(Kernel kernel, int w, int W, bool bitset, cudaStream_t st, Args... args) {
  if (w <= 0) return 0;
  constexpr int kRowsPerBlock = kRowThreads / G;  // one bitset each
  const size_t smem =
      bitset && W >= 32 ? size_t(kRowsPerBlock) * repro::bitset_words(W) * sizeof(unsigned) : 0;
  if (const int e = repro::allow_smem(kernel, smem)) return e;
  int per_sm = 0;
  if (const cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, smem))
    return static_cast<int>(e);
  const long long need = (static_cast<long long>(w) + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
  const int grid = static_cast<int>(need < resident ? need : resident);
  kernel<<<grid, kRowThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Calls launch(std::integral_constant<int, G>) for G = lanes.
template <class Launch>
int by_lanes(int lanes, const Launch& launch) {
  switch (lanes) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 8: return launch(std::integral_constant<int, 8>{});
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Src>
int superstep_rows(const Src& src, int* newc, int* need, int w, int W, int degree_rule,
                   int lanes, cudaStream_t st) {
  return by_lanes(lanes, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return degree_rule
               ? launch_rows<G>(superstep_rows_kernel<G, true, Src>, w, W, true, st, src,
                                newc, need, w, W)
               : launch_rows<G>(superstep_rows_kernel<G, false, Src>, w, W, true, st, src,
                                newc, need, w, W);
  });
}

template <class Src>
int firstfit_rows(const Src& src, int* out, int w, int W, int lanes, cudaStream_t st) {
  return by_lanes(lanes, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return launch_rows<G>(firstfit_rows_kernel<G, Src>, w, W, true, st, src, out, w, W);
  });
}

template <class Src>
int conflict_rows_rule(const Src& src, int* lose, int w, int W, int degree_rule, int lanes,
                       cudaStream_t st) {
  return by_lanes(lanes, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return degree_rule
               ? launch_rows<G>(conflict_rows_kernel<G, true, Src>, w, W, false, st, src,
                                lose, w)
               : launch_rows<G>(conflict_rows_kernel<G, false, Src>, w, W, false, st, src,
                                lose, w);
  });
}

const int* in(const void* p) { return static_cast<const int*>(p); }

template <Rows kRows, bool kPacked = false>
IdLanes<kRows, kPacked> id_lanes(const void* ids, const void* rows, const void* starts,
                                 long long stride, const void* colors, const void* deg, int n,
                                 int W) {
  return {in(ids), in(rows), in(starts), stride, in(colors), in(deg), n, W};
}

TileLanes tile_lanes(const void* ids, const void* my_c, const void* my_d, const void* nid,
                     const void* nc, const void* nd, int W) {
  return {in(ids), in(my_c), in(my_d), in(nid), in(nc), in(nd), W};
}

}  // namespace

extern "C" {

// K4 over source (a) (by_id = 1: row ids[i] of `rows`, up to min(deg[v], W)
// lanes; deg may be null: W lanes) or (b) (by_id = 0: row i). lanes: 1, 4,
// 8, 16 or 32 a row. Returns a cudaError_t.
int repro_firstfit_rows(const void* ids, const void* rows, long long stride, int by_id,
                        const void* colors, const void* deg, void* out, int w, int W,
                        int n, int lanes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (by_id)
    return firstfit_rows(id_lanes<Rows::kTable>(ids, rows, nullptr, stride, colors, deg, n, W),
                         o, w, W, lanes, st);
  return firstfit_rows(id_lanes<Rows::kTile>(ids, rows, nullptr, stride, colors, deg, n, W), o,
                       w, W, lanes, st);
}

// K5 over source (a) or (b), as K4. degree_rule: 0 = id rule, 1 = degree
// rule. Returns a cudaError_t.
int repro_conflict_rows(const void* ids, const void* rows, long long stride, int by_id,
                        const void* colors, const void* deg, void* lose, int w, int W,
                        int n, int degree_rule, int lanes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(lose);
  if (by_id)
    return conflict_rows_rule(
        id_lanes<Rows::kTable>(ids, rows, nullptr, stride, colors, deg, n, W), o, w, W,
        degree_rule, lanes, st);
  return conflict_rows_rule(id_lanes<Rows::kTile>(ids, rows, nullptr, stride, colors, deg, n, W),
                            o, w, W, degree_rule, lanes, st);
}

// K4 over source (c): the (w, W) colour tile nc. Returns a cudaError_t.
int repro_firstfit_tile(const void* nc, void* out, int w, int W, int lanes, void* stream) {
  return firstfit_rows(tile_lanes(nullptr, nullptr, nullptr, nullptr, nc, nullptr, W),
                       static_cast<int*>(out), w, W, lanes, static_cast<cudaStream_t>(stream));
}

// K5 over source (c). Returns a cudaError_t.
int repro_conflict_tile(const void* ids, const void* my_c, const void* my_d,
                        const void* nid, const void* nc, const void* nd, void* lose,
                        int w, int W, int degree_rule, int lanes, void* stream) {
  return conflict_rows_rule(tile_lanes(ids, my_c, my_d, nid, nc, nd, W),
                            static_cast<int*>(lose), w, W, degree_rule, lanes,
                            static_cast<cudaStream_t>(stream));
}

// K3 over source (c), the tiles gathered by the caller. degree_rule: 0 = id
// rule, 1 = degree rule. Returns a cudaError_t.
int repro_superstep_tile(const void* ids, const void* my_c, const void* my_d,
                         const void* nid, const void* nc, const void* nd, void* newc,
                         void* need, int w, int W, int degree_rule, int lanes, void* stream) {
  return superstep_rows(tile_lanes(ids, my_c, my_d, nid, nc, nd, W), static_cast<int*>(newc),
                        static_cast<int*>(need), w, W, degree_rule, lanes,
                        static_cast<cudaStream_t>(stream));
}

// K3 over source (a) (csr = 0: row ids[i] of `rows`, `stride` words a row,
// up to min(deg[v], W) lanes) or (d) (csr = 1: `rows` is C, `starts` R).
// Returns a cudaError_t.
int repro_superstep_rows(const void* ids, const void* rows, const void* starts,
                         long long stride, int csr, const void* colors, const void* deg,
                         void* newc, void* need, int w, int W, int n, int degree_rule,
                         int lanes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(newc);
  int* q = static_cast<int*>(need);
  if (csr)
    return superstep_rows(id_lanes<Rows::kCsr>(ids, rows, starts, 0, colors, deg, n, W), o, q,
                          w, W, degree_rule, lanes, st);
  return superstep_rows(id_lanes<Rows::kTable>(ids, rows, nullptr, stride, colors, deg, n, W),
                        o, q, w, W, degree_rule, lanes, st);
}

// K3 over source (f), composed two-hop rows. Returns a cudaError_t.
int repro_superstep_two_hop(const void* ids, const void* adj_a, long long stride_a, int W1,
                            const void* deg_a, int n_rows, const void* adj_b,
                            long long stride_b, int W2, const void* deg_b, int n_mid,
                            int start, int first_hop, const void* colors, const void* deg,
                            void* newc, void* need, int w, int W, int n, int degree_rule,
                            int lanes, void* stream) {
  const TwoHopLanes src{in(ids),   in(adj_a), in(adj_b), in(deg_a), in(deg_b), in(colors),
                        in(deg),   stride_a,  stride_b,  W1,        W2,        n_rows,
                        n_mid,     start,     n,         first_hop != 0};
  return superstep_rows(src, static_cast<int*>(newc), static_cast<int*>(need), w, W,
                        degree_rule, lanes, static_cast<cudaStream_t>(stream));
}

// K1: source (e), CSR rows over the packed color | deg << 16 words (n + 1,
// slot n = 0). Returns a cudaError_t.
int repro_superstep_csr(const void* wl, const void* row_starts, const void* col,
                        const void* packed, void* newc, void* need, int w, int W, int n,
                        int degree_rule, int lanes, void* stream) {
  return superstep_rows(
      id_lanes<Rows::kCsr, true>(wl, col, row_starts, 0, packed, nullptr, n, W),
      static_cast<int*>(newc), static_cast<int*>(need), w, W, degree_rule, lanes,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
