// Gathered-tile kernels K3 (superstep), K4 (FirstFit) and K5 (conflict)
// for Hopper (sm_90a).
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/superstep/
// kernel.py (K3), kernels/firstfit/kernel.py (K4) and kernels/conflict/
// kernel.py (K5). Every array is int32. A kernel launches on the caller's
// stream, never synchronises and allocates nothing; each launcher returns
// cudaGetLastError() so the wrapper can raise.
//
// The inputs are tiles the caller materialised, (w, W) and row-major: the
// neighbour ids `nid` (the sentinel n in pad lanes), their colours `nc` (0
// in pad lanes) and their degrees `nd` (0 in pad lanes); and per row the
// vertex id `ids`, its colour `my_c` and its degree `my_d`. The Pallas
// kernels take the per-row values stacked as one (w, 3) tile; three vectors
// carry the same values. Pad lanes are inert: colour 0 never equals a
// nonzero colour and is never forbidden.
//
// ---------------------------------------------------------------------------
// K4 firstfit_tile_kernel
//   Replaces src/repro/kernels/firstfit/kernel.py:firstfit_kernel.
//   out[i] = the smallest colour in [1, W+1] absent from row i of nc.
//
// K5 conflict_tile_kernel
//   Replaces src/repro/kernels/conflict/kernel.py:conflict_kernel.
//   lose[i] = some lane holds my_c[i] > 0 and its neighbour beats ids[i]:
//   under the id rule v loses when v < u; under the degree rule when
//   deg(u) > deg(v), or the degrees are equal and u < v.
//
// K3 superstep_tile_kernel
//   Replaces src/repro/kernels/superstep/kernel.py:superstep_kernel.
//   K5's test and K4's FirstFit in one pass over the row, with the lanes
//   that row i beats counted as colour 0 (they recolour too). Writes
//   newc = need ? ff : my_c and need = lose || my_c == 0. Sentinel masking
//   (need &= id < n) is the caller's, as in repro.
//
// Bound on the card: bytes. K4 reads w*W words and writes w; K5 and K3 read
// 3*w*W + 3*w words and write w (K5) or 2*w (K3). Per word they do a few
// integer operations, far below the card's ratio of operations to bytes.
//
// Design: one warp per row, lanes striding over it, so each step of a warp
// reads 128 contiguous bytes of a tile; 8 warps a block keep many rows in
// flight. nid and nd are read only on lanes that hold the row's colour,
// and a row of colour 0 (which cannot lose) reads neither, so where colours
// rarely clash K5 and K3 move little more than the nc tile. FirstFit is
// common.cuh's: a register mask of colours 1..32, and only when all 32 are
// taken a per-warp shared bitset of (W+1+31)/32 words. W = 35,975 (a
// kkt_power class past the packed word) needs 1,126 words a warp, 36 KB a
// block; above 48 KB a block the launcher asks for more dynamic shared
// memory, and the wrappers refuse widths whose bitsets pass the 227 KB a
// block can have (W > 232,447).
// ---------------------------------------------------------------------------

#include "common.cuh"

namespace {

using repro::beats;
using repro::first_fit;
using repro::kFull;
using repro::low_bit;

constexpr int kWarpsPerBlock = 8;  // one tile row per warp

struct Row {
  int i;       // row index
  int lane;
  size_t base;  // offset of the row in the tiles
  unsigned* words;  // the warp's FirstFit bitset
};

// The warp's row, or i >= w when the warp has none (whole warps leave).
__device__ __forceinline__ Row warp_row(int W) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  return {i, static_cast<int>(threadIdx.x & 31), size_t(i) * W,
          smem + warp * repro::bitset_words(W)};
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
firstfit_tile_kernel(const int* __restrict__ nc, int* __restrict__ out, int w, int W) {
  const Row r = warp_row(W);
  if (r.i >= w) return;
  const int* row = nc + r.base;
  unsigned m = 0;
  for (int j = r.lane; j < W; j += 32) m |= low_bit(row[j]);
  m = __reduce_or_sync(kFull, m);
  const int ff = first_fit(m, [&](int j) { return row[j]; }, W, W, r.words);
  if (r.lane == 0) out[r.i] = ff;
}

template <bool kDegreeRule>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
conflict_tile_kernel(const int* __restrict__ ids, const int* __restrict__ my_c,
                     const int* __restrict__ my_d, const int* __restrict__ nid,
                     const int* __restrict__ nc, const int* __restrict__ nd,
                     int* __restrict__ lose_out, int w, int W) {
  const Row r = warp_row(W);
  if (r.i >= w) return;
  const int v = ids[r.i], c = my_c[r.i];
  bool lose = false;
  if (c > 0) {
    const int dv = my_d[r.i];
    for (int j = r.lane; j < W; j += 32) {
      if (nc[r.base + j] == c && beats<kDegreeRule>(nid[r.base + j], nd[r.base + j], v, dv))
        lose = true;
    }
  }
  lose = __any_sync(kFull, lose);
  if (r.lane == 0) lose_out[r.i] = lose ? 1 : 0;
}

template <bool kDegreeRule>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
superstep_tile_kernel(const int* __restrict__ ids, const int* __restrict__ my_c,
                      const int* __restrict__ my_d, const int* __restrict__ nid,
                      const int* __restrict__ nc, const int* __restrict__ nd,
                      int* __restrict__ newc, int* __restrict__ need_out, int w,
                      int W) {
  const Row r = warp_row(W);
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

struct Launch {
  dim3 grid, block;
  size_t smem;
};

Launch launch_for(int w, int W, bool bitset) {
  const size_t smem =
      bitset ? size_t(kWarpsPerBlock) * repro::bitset_words(W) * sizeof(unsigned) : 0;
  return {dim3((w + kWarpsPerBlock - 1) / kWarpsPerBlock), dim3(kWarpsPerBlock * 32), smem};
}

}  // namespace

extern "C" {

// K4. Returns a cudaError_t.
int repro_firstfit_tile(const void* nc, void* out, int w, int W, void* stream) {
  if (w <= 0) return 0;
  const Launch l = launch_for(w, W, true);
  if (const int e = repro::allow_smem(firstfit_tile_kernel, l.smem)) return e;
  firstfit_tile_kernel<<<l.grid, l.block, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nc), static_cast<int*>(out), w, W);
  return static_cast<int>(cudaGetLastError());
}

// K5. degree_rule: 0 = id rule, 1 = degree rule. Returns a cudaError_t.
int repro_conflict_tile(const void* ids, const void* my_c, const void* my_d,
                        const void* nid, const void* nc, const void* nd, void* lose,
                        int w, int W, int degree_rule, void* stream) {
  if (w <= 0) return 0;
  const Launch l = launch_for(w, W, false);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(ids);
  const int* c = static_cast<const int*>(my_c);
  const int* d = static_cast<const int*>(my_d);
  const int* u = static_cast<const int*>(nid);
  const int* uc = static_cast<const int*>(nc);
  const int* ud = static_cast<const int*>(nd);
  int* o = static_cast<int*>(lose);
  if (degree_rule)
    conflict_tile_kernel<true><<<l.grid, l.block, l.smem, st>>>(a, c, d, u, uc, ud, o, w, W);
  else
    conflict_tile_kernel<false><<<l.grid, l.block, l.smem, st>>>(a, c, d, u, uc, ud, o, w, W);
  return static_cast<int>(cudaGetLastError());
}

// K3. degree_rule: 0 = id rule, 1 = degree rule. Returns a cudaError_t.
int repro_superstep_tile(const void* ids, const void* my_c, const void* my_d,
                         const void* nid, const void* nc, const void* nd, void* newc,
                         void* need, int w, int W, int degree_rule, void* stream) {
  if (w <= 0) return 0;
  const Launch l = launch_for(w, W, true);
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
    if (const int e = repro::allow_smem(superstep_tile_kernel<true>, l.smem)) return e;
    superstep_tile_kernel<true><<<l.grid, l.block, l.smem, st>>>(a, c, d, u, uc, ud, o, q, w, W);
  } else {
    if (const int e = repro::allow_smem(superstep_tile_kernel<false>, l.smem)) return e;
    superstep_tile_kernel<false><<<l.grid, l.block, l.smem, st>>>(a, c, d, u, uc, ud, o, q, w, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
