// Dependent-load latency probe for Hopper (sm_90a). Not a port kernel:
// chip_smoke.py uses it to put a number on K2's depth bound: the longest
// chain of entries each waiting for the colour of the one before, each link
// at least one round trip to L2.
//
// One thread follows a pointer chain p = next[p] for `steps` loads, each
// address depending on the load before it, so the time per step is one
// load's latency. level 1 loads with __ldca (cached in L1 and L2), level 2
// with __ldcg (cached in L2 only, so an L1 hit is impossible). The caller
// sizes the chain to fit the level it measures and warms it first.

#include "common.cuh"

namespace {

template <bool kL1>
__global__ void __launch_bounds__(32) chase_kernel(const int* __restrict__ next, int start,
                                                   int steps, int* __restrict__ out) {
  if (threadIdx.x != 0) return;
  int p = start;
  for (int i = 0; i < steps; ++i) p = kL1 ? __ldca(next + p) : __ldcg(next + p);
  *out = p;
}

}  // namespace

extern "C" {

// level: 1 = L1 (and L2), 2 = L2 only. Returns a cudaError_t.
int repro_chase(const void* next, int start, int steps, int level, void* out,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(next);
  int* o = static_cast<int*>(out);
  if (level == 1)
    chase_kernel<true><<<1, 32, 0, st>>>(p, start, steps, o);
  else
    chase_kernel<false><<<1, 32, 0, st>>>(p, start, steps, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
