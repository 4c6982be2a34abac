// What the port's kernels share: the loser rule of K1, K3 and K5, the
// FirstFit of K1, K2, K3, K4 and K6, a warp's or a lane group's
// (tile_kernels.cu, superstep_csr.cu, d2_kernels.cu), and the pieces every
// kernel library has. Each csrc/*.cu builds into a library of its own
// (repro_torch/kernels/build.py), so the extern "C" function below is
// defined once per library.
//
// FirstFit: the smallest colour in [1, W+1] absent from a row of colours.
// Colours 1..32 are kept as a per-lane register mask OR-reduced across the
// lanes that share the row (a warp, or a group of G lanes of one); __ffs on
// its complement gives the answer unless all 32 are taken. Only then do
// those lanes read their row again into their own bitset of (W+1+31)/32
// words in shared memory and reduce the first free bit across themselves,
// so any width works whose bitsets fit a block's shared memory.
#pragma once

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFull = 0xffffffffu;

// Does neighbour u (degree du) beat vertex v (degree dv) when both hold the
// same colour? id rule: v loses when v < u. degree rule: the larger degree
// wins, ties to the smaller id.
template <bool kDegreeRule>
__device__ __forceinline__ bool beats(int u, int du, int v, int dv) {
  return kDegreeRule ? (du > dv || (du == dv && u < v)) : (v < u);
}

// bit of colour c in the register mask of colours 1..32 (0 outside it)
__device__ __forceinline__ unsigned low_bit(int c) {
  return (c >= 1 && c <= 32) ? (1u << (c - 1)) : 0u;
}

// 32-bit words of one warp's FirstFit bitset at width W
__host__ __device__ __forceinline__ int bitset_words(int W) {
  return (W + 1 + 31) >> 5;
}

// Smallest colour in [1, W+1] absent from the colours a row's lanes show,
// for a group of G lanes (G divides 32) sharing one row: `glane` is a
// lane's index in the group and `gmask` the group's lanes in the warp. `m`
// is the group-reduced mask of colours 1..32 already seen. `visit(mark)`
// calls mark(c) once for each colour c of this lane's share of the row, in
// any order (the lanes of the group together cover the row). The group's
// lanes call this together and all get the answer; other groups of the
// warp may take other branches. `words` is the group's scratch bitset of
// bitset_words(W) words; only words 1.. are used, and only when colours
// 1..32 are all taken. Needs a row of at most W lanes, so a free colour
// exists.
template <int G, class Visit>
__device__ __forceinline__ int first_fit_visit(unsigned m, const Visit& visit, int W,
                                               unsigned* words, int glane, unsigned gmask) {
  const unsigned cand0 = W >= 31 ? kFull : ((1u << (W + 1)) - 1u);
  const unsigned free0 = ~m & cand0;
  if (free0) return __ffs(free0);
  const int nwords = bitset_words(W);
  for (int k = 1 + glane; k < nwords; k += G) words[k] = 0u;
  __syncwarp(gmask);
  visit([&](int c) {
    if (c > 32 && c <= W + 1) atomicOr(&words[(c - 1) >> 5], 1u << ((c - 1) & 31));
  });
  __syncwarp(gmask);
  int best = INT_MAX;
  for (int k = 1 + glane; k < nwords; k += G) {
    unsigned f = ~words[k];
    const int hi = W - 32 * k;  // last candidate bit in word k (>= 0)
    if (hi < 31) f &= (2u << hi) - 1u;
    if (f) best = min(best, 32 * k + __ffs(f) - 1);
  }
  best = __reduce_min_sync(gmask, best);
  __syncwarp(gmask);  // the scratch words are reused by the next call
  return best + 1;
}

// first_fit_visit over the lanes j = glane, glane + G, ... < d of a flat
// row, lane j showing colour color_of(j).
template <int G, class ColorOf>
__device__ __forceinline__ int first_fit_group(unsigned m, const ColorOf& color_of,
                                               int d, int W, unsigned* words,
                                               int glane, unsigned gmask) {
  return first_fit_visit<G>(
      m,
      [&](const auto& mark) {
        for (int j = glane; j < d; j += G) mark(color_of(j));
      },
      W, words, glane, gmask);
}

// first_fit_group for a whole warp sharing one row (K2, K6).
template <class ColorOf>
__device__ __forceinline__ int first_fit(unsigned m, const ColorOf& color_of,
                                         int d, int W, unsigned* words) {
  return first_fit_group<32>(m, color_of, d, W, words, threadIdx.x & 31, kFull);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (needed above
// 48 KB). Returns a cudaError_t.
template <class Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
