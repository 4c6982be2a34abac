// Memory probes for Hopper (sm_90a). Not port kernels: chip_smoke.py uses
// them to put numbers on two bounds that bytes over HBM's rate miss.
//
// Dependent-load latency (chase_kernel), for K2's depth bound: the longest
// chain of entries each waiting for the colour of the one before, each link
// at least one round trip to L2.
//
// One thread follows a pointer chain p = next[p] for `steps` loads, each
// address depending on the load before it, so the time per step is one
// load's latency. level 1 loads with __ldca (cached in L1 and L2), level 2
// with __ldcg (cached in L2 only, so an L1 hit is impossible). The caller
// sizes the chain to fit the level it measures and warms it first.
//
// Random-gather throughput (gather_kernel), for K4 and K5: each lane's
// neighbour colour is a 4-byte read at a random place of colors_ext, which
// L2 serves a 32-byte sector at a time. Every thread of a full grid reads
// `reads` words of a 2^log2 word table at indices from a hash of the thread
// and the step (no index array is read), 8 loads in flight a thread,
// through the read-only path as K4 and K5 read (__ldg) or L2 only
// (__ldcg), and sums them so no load is dropped. The caller warms the
// table into L2 first.

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

// A well-mixed 32-bit hash (the finaliser of MurmurHash3).
__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  return x ^ (x >> 16);
}

template <bool kL1>
__global__ void __launch_bounds__(256) gather_kernel(const int* __restrict__ table,
                                                     unsigned mask, int reads,
                                                     int* __restrict__ out) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  int sum = 0;
  for (int k = 0; k < reads; k += 8) {
    int v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const unsigned idx = mix(t * 0x9e3779b1u + unsigned(k + q)) & mask;
      v[q] = kL1 ? __ldg(table + idx) : __ldcg(table + idx);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) sum += v[q];
  }
  if (sum == 0x7fffffff) *out = sum;  // keeps the loads; never true for the probe's table
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

// reads (a multiple of 8) per thread over blocks x 256 threads from a table
// of 2^log2 words; level: 1 = read-only path (__ldg), 2 = L2 only. Returns a
// cudaError_t.
int repro_gather(const void* table, int log2, int reads, int level, int blocks, void* out,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(table);
  const unsigned mask = (1u << log2) - 1u;
  int* o = static_cast<int*>(out);
  if (level == 1)
    gather_kernel<true><<<blocks, 256, 0, st>>>(p, mask, reads, o);
  else
    gather_kernel<false><<<blocks, 256, 0, st>>>(p, mask, reads, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
