// FirstFit (K4) and conflict (K5) kernels that read their rows where they
// lie, and the gathered-tile superstep (K3), for Hopper (sm_90a).
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/firstfit/
// kernel.py (K4), kernels/conflict/kernel.py (K5) and kernels/superstep/
// kernel.py (K3). Every array is int32; row offsets are 64-bit. A kernel
// launches on the caller's stream, never synchronises and allocates
// nothing; each launcher returns cudaGetLastError() so the wrapper can
// raise.
//
// ---------------------------------------------------------------------------
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
//   Both run over one of three lane sources (the Pallas kernels take the
//   third only):
//   (a) IdLanes<true>: row ids[i] of a table of neighbour ids, rows `stride`
//       words apart (the classic engine's (n, Δmax) table sliced to a class
//       width W, so stride = Δmax), read up to min(deg[v], W) lanes: the
//       table pads every row past its degree with the sentinel n, so the
//       lanes skipped hold colour 0 and change nothing. Ids >= n read no
//       lane. Colours come from colors_ext and degrees from deg_ext, both
//       n + 1 words with the sentinel's 0 in slot n, read in place.
//   (b) IdLanes<false>: row i of a (w, W) tile of neighbour ids the caller
//       gathered (d2_sgr_step's composed two-hop rows, which may hold self,
//       duplicate and sentinel lanes), all W lanes, colours and degrees
//       read as in (a).
//   (c) TileLanes: (w, W) tiles of neighbour ids, colours and degrees and
//       per row the vertex, its colour and degree, all gathered by the
//       caller (firstfit_tile, conflict_tile).
//
// K3 superstep_tile_kernel
//   Replaces src/repro/kernels/superstep/kernel.py:superstep_kernel.
//   K5's test and K4's FirstFit in one pass over the row, with the lanes
//   that row i beats counted as colour 0 (they recolour too). Writes
//   newc = need ? ff : my_c and need = lose || my_c == 0. Sentinel masking
//   (need &= id < n) is the caller's, as in repro. Reads source (c) only.
//
// Bound on the card: bytes. Each word read once and each written once:
// K4 over (a) reads w ids, Σ min(deg, W) table lanes and each distinct
// neighbour's colour, and writes w; K5 adds w own colours and degrees and,
// under the degree rule, the degrees of the neighbours on lanes that hold
// the row's colour; a row of colour 0 needs none of its lanes. Over (c) K4
// reads w*W words and K5 and K3 3*w*W + 3*w. Per word they do a few
// integer operations, far below the card's ratio of operations to bytes.
//
// Design of K4 and K5. A group of G lanes takes a row (G in 1, 4, 8, 16,
// 32, chosen by the wrapper from W: a thread a row for narrow rows, so no
// lane idles at W = 8; 8 lanes for a table read up to each degree, whose
// rows are short whatever W; a warp for wide gathered rows read in full),
// so a warp takes 32 / G rows at once. The grid is as many 256-thread
// blocks as are resident on the card, and each warp strides over the rows,
// loading the next pass's row id before it works on the current row, so a
// warp lives long and keeps loads in flight. The
// chain per row is short: the row id; then the vertex's degree (and K5's
// own colour) and the lanes' table words; then the lanes' colours from
// colors_ext (L2-resident: 4 B x (n + 1)); K5 reads a neighbour's degree
// only on lanes whose colour matches, and a row of colour 0 reads none.
// colors_ext and deg_ext do not change during a launch (K4 writes `out`,
// so a chunk reads the colours from before it), so all reads go through
// the read-only path. FirstFit is common.cuh's for a group of G lanes: a
// register mask of colours 1..32 reduced over the group, and only when all
// 32 are taken a per-group shared bitset of (W+1+31)/32 words, 256 / G
// bitsets a block (W = 4096 with G = 1: 132 KB; above 48 KB the launcher
// asks for more dynamic shared memory, and the wrappers refuse a layout
// whose bitsets pass the 227 KB a block can have).
//
// Design of K3: one warp per row, lanes striding over it, so each step of
// a warp reads 128 contiguous bytes of a tile; 8 warps a block. nid and nd
// are read only on lanes that hold the row's colour, and a row of colour 0
// (which cannot lose) reads neither.
// ---------------------------------------------------------------------------

#include "common.cuh"

namespace {

using repro::beats;
using repro::first_fit;
using repro::kFull;
using repro::low_bit;

// ---------------------------------------------------------------------------
// K4 and K5: rows read where they lie
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;  // threads a block of K4 or K5

// One row as a lane group sees it.
struct Row {
  int v;        // the row's vertex (K5)
  int c, d;     // its colour and degree (K5)
  int len;      // lanes to read
  size_t base;  // offset of lane 0
};

// Sources (a) and (b): lanes hold neighbour ids; colours and degrees are
// read from colors_ext and deg_ext.
template <bool kById>
struct IdLanes {
  const int* ids;
  const int* rows;    // (a) the table, (b) the gathered id tile
  long long stride;   // words between two rows of `rows`
  const int* colors;  // colors_ext, n + 1 words
  const int* deg;     // deg_ext, n + 1 words; (a) bounds the lanes read (K4: may be null)
  int n, W;

  __device__ int key(long long i) const { return __ldg(ids + i); }

  template <bool kOwnColor, bool kOwnDegree>
  __device__ Row row(long long i, int v) const {
    Row r;
    r.v = v;
    if (kById) {
      const bool real = v < n;
      r.base = size_t(real ? v : 0) * size_t(stride);
      r.len = !real ? 0 : deg ? min(__ldg(deg + v), W) : W;
    } else {
      r.base = size_t(i) * size_t(stride);
      r.len = W;
    }
    const int own = min(v, n);
    r.c = kOwnColor ? __ldg(colors + own) : 0;
    r.d = kOwnDegree ? __ldg(deg + own) : 0;
    return r;
  }

  __device__ int color(const Row& r, int j, int& u) const {
    u = __ldg(rows + r.base + j);
    return __ldg(colors + u);
  }
  __device__ int id(const Row&, int, int u) const { return u; }
  __device__ int degree(const Row&, int, int u) const { return __ldg(deg + u); }
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
// and no more than the rows need. bitset: K4's FirstFit scratch.
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

template <class Src>
int firstfit_rows(const Src& src, int* out, int w, int W, int lanes, cudaStream_t st) {
  switch (lanes) {
    case 1: return launch_rows<1>(firstfit_rows_kernel<1, Src>, w, W, true, st, src, out, w, W);
    case 4: return launch_rows<4>(firstfit_rows_kernel<4, Src>, w, W, true, st, src, out, w, W);
    case 8: return launch_rows<8>(firstfit_rows_kernel<8, Src>, w, W, true, st, src, out, w, W);
    case 16:
      return launch_rows<16>(firstfit_rows_kernel<16, Src>, w, W, true, st, src, out, w, W);
    case 32:
      return launch_rows<32>(firstfit_rows_kernel<32, Src>, w, W, true, st, src, out, w, W);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDegreeRule, class Src>
int conflict_rows(const Src& src, int* lose, int w, int W, int lanes, cudaStream_t st) {
  switch (lanes) {
    case 1:
      return launch_rows<1>(conflict_rows_kernel<1, kDegreeRule, Src>, w, W, false, st, src,
                            lose, w);
    case 4:
      return launch_rows<4>(conflict_rows_kernel<4, kDegreeRule, Src>, w, W, false, st, src,
                            lose, w);
    case 8:
      return launch_rows<8>(conflict_rows_kernel<8, kDegreeRule, Src>, w, W, false, st, src,
                            lose, w);
    case 16:
      return launch_rows<16>(conflict_rows_kernel<16, kDegreeRule, Src>, w, W, false, st,
                             src, lose, w);
    case 32:
      return launch_rows<32>(conflict_rows_kernel<32, kDegreeRule, Src>, w, W, false, st,
                             src, lose, w);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Src>
int conflict_rows_rule(const Src& src, int* lose, int w, int W, int degree_rule, int lanes,
                       cudaStream_t st) {
  return degree_rule ? conflict_rows<true>(src, lose, w, W, lanes, st)
                     : conflict_rows<false>(src, lose, w, W, lanes, st);
}

template <bool kById>
IdLanes<kById> id_lanes(const void* ids, const void* rows, long long stride,
                        const void* colors, const void* deg, int n, int W) {
  return {static_cast<const int*>(ids), static_cast<const int*>(rows), stride,
          static_cast<const int*>(colors), static_cast<const int*>(deg), n, W};
}

// ---------------------------------------------------------------------------
// K3: the superstep over gathered tiles, one warp a row
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = 8;  // one tile row per warp

struct WarpRow {
  int i;            // row index
  int lane;
  size_t base;      // offset of the row in the tiles
  unsigned* words;  // the warp's FirstFit bitset
};

// The warp's row, or i >= w when the warp has none (whole warps leave).
__device__ __forceinline__ WarpRow warp_row(int W) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  return {i, static_cast<int>(threadIdx.x & 31), size_t(i) * W,
          smem + warp * repro::bitset_words(W)};
}

template <bool kDegreeRule>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
superstep_tile_kernel(const int* __restrict__ ids, const int* __restrict__ my_c,
                      const int* __restrict__ my_d, const int* __restrict__ nid,
                      const int* __restrict__ nc, const int* __restrict__ nd,
                      int* __restrict__ newc, int* __restrict__ need_out, int w,
                      int W) {
  const WarpRow r = warp_row(W);
  if (r.i >= w) return;
  const int v = ids[r.i], c = my_c[r.i], dv = my_d[r.i];

  // colour lane j shows to FirstFit: neighbours v beats count as cleared
  auto refit_color = [&](int j, bool* lose) {
    const int cj = nc[r.base + j];
    if (c > 0 && cj == c) {
      const bool l = beats<kDegreeRule>(nid[r.base + j], nd[r.base + j], v, dv);
      *lose = *lose || l;
      return l ? cj : 0;
    }
    return cj;
  };

  bool lose = false;
  unsigned m = 0;
  for (int j = r.lane; j < W; j += 32) m |= low_bit(refit_color(j, &lose));
  const bool need = __any_sync(kFull, lose) || c == 0;
  int out = c;
  if (need) {
    m = __reduce_or_sync(kFull, m);
    bool unused = false;
    out = first_fit(m, [&](int j) { return refit_color(j, &unused); }, W, W, r.words);
  }
  if (r.lane == 0) {
    newc[r.i] = out;
    need_out[r.i] = need ? 1 : 0;
  }
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
    return firstfit_rows(id_lanes<true>(ids, rows, stride, colors, deg, n, W), o, w, W,
                         lanes, st);
  return firstfit_rows(id_lanes<false>(ids, rows, stride, colors, deg, n, W), o, w, W, lanes,
                       st);
}

// K5 over source (a) or (b), as K4. degree_rule: 0 = id rule, 1 = degree
// rule. Returns a cudaError_t.
int repro_conflict_rows(const void* ids, const void* rows, long long stride, int by_id,
                        const void* colors, const void* deg, void* lose, int w, int W,
                        int n, int degree_rule, int lanes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(lose);
  if (by_id)
    return conflict_rows_rule(id_lanes<true>(ids, rows, stride, colors, deg, n, W), o, w, W,
                              degree_rule, lanes, st);
  return conflict_rows_rule(id_lanes<false>(ids, rows, stride, colors, deg, n, W), o, w, W,
                            degree_rule, lanes, st);
}

// K4 over source (c): the (w, W) colour tile nc. Returns a cudaError_t.
int repro_firstfit_tile(const void* nc, void* out, int w, int W, int lanes, void* stream) {
  const TileLanes src{nullptr, nullptr, nullptr, nullptr, static_cast<const int*>(nc),
                      nullptr, W};
  return firstfit_rows(src, static_cast<int*>(out), w, W, lanes,
                       static_cast<cudaStream_t>(stream));
}

// K5 over source (c). Returns a cudaError_t.
int repro_conflict_tile(const void* ids, const void* my_c, const void* my_d,
                        const void* nid, const void* nc, const void* nd, void* lose,
                        int w, int W, int degree_rule, int lanes, void* stream) {
  const TileLanes src{static_cast<const int*>(ids), static_cast<const int*>(my_c),
                      static_cast<const int*>(my_d), static_cast<const int*>(nid),
                      static_cast<const int*>(nc),  static_cast<const int*>(nd),
                      W};
  return conflict_rows_rule(src, static_cast<int*>(lose), w, W, degree_rule, lanes,
                            static_cast<cudaStream_t>(stream));
}

// K3. degree_rule: 0 = id rule, 1 = degree rule. Returns a cudaError_t.
int repro_superstep_tile(const void* ids, const void* my_c, const void* my_d,
                         const void* nid, const void* nc, const void* nd, void* newc,
                         void* need, int w, int W, int degree_rule, void* stream) {
  if (w <= 0) return 0;
  const size_t smem = size_t(kWarpsPerBlock) * repro::bitset_words(W) * sizeof(unsigned);
  const dim3 grid((w + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(ids);
  const int* c = static_cast<const int*>(my_c);
  const int* d = static_cast<const int*>(my_d);
  const int* u = static_cast<const int*>(nid);
  const int* uc = static_cast<const int*>(nc);
  const int* ud = static_cast<const int*>(nd);
  int* o = static_cast<int*>(newc);
  int* q = static_cast<int*>(need);
  if (degree_rule) {
    if (const int e = repro::allow_smem(superstep_tile_kernel<true>, smem)) return e;
    superstep_tile_kernel<true><<<grid, block, smem, st>>>(a, c, d, u, uc, ud, o, q, w, W);
  } else {
    if (const int e = repro::allow_smem(superstep_tile_kernel<false>, smem)) return e;
    superstep_tile_kernel<false><<<grid, block, smem, st>>>(a, c, d, u, uc, ud, o, q, w, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
