// P4 scatter_add: unsorted segment sum by f32 atomics.
//
// Replaces tools/probes/microbench_gather9.py fC: a serial
// read-modify-write loop that walks K unsorted ids and adds each [r] row
// of values into a VMEM-resident [n, r] output (the TPU has no scatter
// unit, so it is one scalar loop on one core).  Here every value is one
// thread and one atomicAdd into an output the wrapper zeroed:
//
//   out[ids[k], c] += vals[k, c]            vals [K, r], out [n, r]
//
// The lanes run over the flattened (k, c) index: coalesced reads of the
// values, and atomics into the r consecutive floats of each target row.
// The order of the additions is not fixed, so the result may differ
// between runs in the last bits (held to 4 eps32 * sum |values| against
// the plain version's f64 sum).
//
// What bounds it: device memory for the values; the atomics resolve in
// L2 (the output, n * r * 4 bytes, fits its 50 MB at the probes' shapes).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void scatter_add_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ ids,
                                   float* __restrict__ out, long total,
                                   int r) {
  const long e = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long k = e / r;
  const int c = (int)(e - k * r);
  atomicAdd(out + (long)__ldg(ids + k) * r + c, __ldg(vals + e));
}

}  // namespace

// vals float32 [K, r] (r = 1: [K]); ids int32 [K] in [0, n); out float32
// [n, r], zeroed by the caller; all contiguous.  Returns
// cudaGetLastError().
extern "C" int lt_scatter_add(const void* vals, const void* ids, void* out,
                              int K, int r, void* stream) {
  const long total = (long)K * r;
  if (total > 0) {
    scatter_add_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                         0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(ids),
        static_cast<float*>(out), total, r);
  }
  return (int)cudaGetLastError();
}
