// Two instruments for reading kernel times against the card's floors
// (chip_smoke.py; no solver path launches them, and kernels.LAUNCHES does
// not count them):
//
// * lt_empty: an empty kernel, one warp.  Its device time in a CUDA graph
//   of back-to-back calls is the least a launch costs there, the floor
//   under the small kernels (K2 at r = 1 moves 2.5 MB, 0.0007 ms of bytes).
// * lt_smem_chase: one thread follows `hops` dependent shared-memory
//   loads (each address is the value the last load returned) and writes
//   the nanoseconds (%globaltimer) and cycles (clock64) they took: the
//   latency of one dependent shared-memory step, from which K8c's
//   dependent-step bound (n steps) is formed.
//
// The floor under loop_cond (a WHILE node whose body is its tail launch
// alone, against the same launches in a plain graph) is timed with
// graph_cond.cu's own entry points (chip_smoke.py's `loop_cond floor:`).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int CHASE = 1024;

__global__ void empty_kernel() {}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void smem_chase_kernel(int hops, long long* out) {
  __shared__ int next[CHASE];
  // a single cycle through all CHASE slots (stride 33 is odd)
  for (int i = threadIdx.x; i < CHASE; i += blockDim.x)
    next[i] = (i + 33) % CHASE;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int p = 0;
  const uint64_t g0 = global_ns();
  const long long c0 = clock64();
  for (int h = 0; h < hops; ++h) p = next[p];
  const long long c1 = clock64();
  const uint64_t g1 = global_ns();
  out[0] = (long long)(g1 - g0);
  out[1] = c1 - c0;
  out[2] = p;  // keeps the chain live
}

}  // namespace

extern "C" int lt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// out: int64 [3] on the device: ns, cycles, the last slot reached.
extern "C" int lt_smem_chase(int hops, void* out, void* stream) {
  smem_chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      hops, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
