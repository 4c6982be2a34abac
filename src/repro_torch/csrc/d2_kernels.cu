// Distance-2 FirstFit over two neighbour-colour tiles (K6) for Hopper
// (sm_90a).
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/d2/kernel.py.
// Every array is int32. The kernel launches on the caller's stream, never
// synchronises and allocates nothing; the launcher returns cudaGetLastError()
// so the wrapper can raise.
//
// ---------------------------------------------------------------------------
// K6 d2_firstfit_kernel
//   Replaces src/repro/kernels/d2/kernel.py:d2_firstfit_kernel (the Pallas
//   two-tile bitset FirstFit).
//   out[i] = the smallest colour in [1, W1+W2+1] absent from the union of
//   row i of nc1 (w, W1), the hop-1 colours, and row i of nc2 (w, W2), the
//   hop-2 colours. Colour 0 (no neighbour, or uncoloured) is never
//   forbidden. The two tiles are read where they lie: the (w, W1+W2)
//   concatenation is never built, which is the point of the TPU kernel too
//   (W2 grows like W1^2).
//
//   Bound on the card: bytes. It reads w*(W1+W2) words and writes w; per
//   word it does a compare, a shift and an OR, far below the card's ratio of
//   operations to bytes.
//
//   Design: one warp per row, 8 warps a block, lanes striding first over
//   the row of nc1 and then over the row of nc2, so each step of a warp
//   reads 128 contiguous bytes of one tile. FirstFit is common.cuh's (K1-K4
//   share it): colours 1..32 in a per-lane register mask OR-reduced across
//   the warp, __ffs on its complement, and only when all 32 are taken a
//   per-warp shared bitset of (W1+W2+1+31)/32 words, filled by reading the
//   two rows again. The wrapper refuses W1+W2 whose bitsets pass the 227 KB
//   a block can have (check_bitset_width); above 48 KB a block the launcher
//   asks for the larger dynamic shared memory.
// ---------------------------------------------------------------------------

#include "common.cuh"

namespace {

using repro::first_fit;
using repro::kFull;
using repro::low_bit;

constexpr int kWarpsPerBlock = 8;  // one row per warp

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
d2_firstfit_kernel(const int* __restrict__ nc1, const int* __restrict__ nc2,
                   int* __restrict__ out, int w, int W1, int W2) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= w) return;  // whole warps leave together
  const int W = W1 + W2;
  unsigned* words = smem + warp * repro::bitset_words(W);
  const int* row1 = nc1 + size_t(i) * W1;
  const int* row2 = nc2 + size_t(i) * W2;

  unsigned m = 0;
  for (int j = lane; j < W1; j += 32) m |= low_bit(row1[j]);
  for (int j = lane; j < W2; j += 32) m |= low_bit(row2[j]);
  m = __reduce_or_sync(kFull, m);
  // lane j of the union: hop-1 lanes first, then hop-2
  const int ff = first_fit(m, [&](int j) { return j < W1 ? row1[j] : row2[j - W1]; },
                           W, W, words);
  if (lane == 0) out[i] = ff;
}

}  // namespace

extern "C" {

// K6. Returns a cudaError_t.
int repro_d2_firstfit(const void* nc1, const void* nc2, void* out, int w, int W1,
                      int W2, void* stream) {
  if (w <= 0) return 0;
  const size_t smem =
      size_t(kWarpsPerBlock) * repro::bitset_words(W1 + W2) * sizeof(unsigned);
  if (const int e = repro::allow_smem(d2_firstfit_kernel, smem)) return e;
  const dim3 grid((w + kWarpsPerBlock - 1) / kWarpsPerBlock);
  d2_firstfit_kernel<<<grid, kWarpsPerBlock * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nc1), static_cast<const int*>(nc2), static_cast<int*>(out), w,
      W1, W2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
