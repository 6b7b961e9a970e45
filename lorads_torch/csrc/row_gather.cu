// P3 row_gather: unsorted row gather X[ids] on the CUDA cores.
//
// Replaces the in-kernel dynamic gathers of tools/probes/:
// microbench_pallas_gather.py gA-gD (X[n, r] rows by a [T] id block),
// microbench_pallas_gather2.py g, microbench_gather.py pallas_gather and
// microbench_gather9.py fA/fB (scalar-prefetch loops over a VMEM table);
// the transposed layout of microbench_pallas_gather3/4.py gT ([R, n] ->
// [R, K] along the lanes); and the scalar gathers gE/gE2 (r = 1).  The
// TPU gathers by a scalar loop or a lane shuffle inside VMEM; Hopper
// gathers rows straight from device memory through L2.
//
//   row layout:        out[k, c] = X[ids[k], c]       X [n, r], out [K, r]
//   transposed layout: out[c, k] = X[c, ids[k]]       X [r, n], out [r, K]
//
// Row layout: the lanes of a warp run over the flattened (row, vector)
// index of the output, so a warp covers a group of consecutive output
// rows, writes 32 consecutive vectors and reads each source row as
// contiguous vectors: 16-byte float4 loads when r % 4 == 0 (and the
// pointers allow), else 4-byte loads.  r = 1 is the 1-D gather.
// Transposed layout: a thread per id; the lanes run over K (coalesced
// writes of each output row) and read X through the read-only path.
//
// What bounds it: device memory (or L2, for a table that fits its 50 MB)
// -- each gathered row is read once and written once; the ids are read
// once.  Ids are checked against [0, n) by the wrapper, not here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ X,
                                   const int* __restrict__ ids,
                                   V* __restrict__ out, long total, int rv) {
  const long e = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long k = e / rv;
  const int c = (int)(e - k * rv);
  out[e] = __ldg(X + (long)__ldg(ids + k) * rv + c);
}

__global__ void gather_cols_kernel(const float* __restrict__ X,
                                   const int* __restrict__ ids,
                                   float* __restrict__ out, int n, int K,
                                   int r) {
  const long k = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long id = __ldg(ids + k);
  for (int c = 0; c < r; ++c)
    out[(long)c * K + k] = __ldg(X + (long)c * n + id);
}

unsigned blocks_for(long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

}  // namespace

// transposed: 0 for X [n, r] -> out [K, r] (r = 1: 1-D), 1 for X [r, n]
// -> out [r, K]; ids int32 [K] in [0, n); all contiguous float32.
// Returns cudaGetLastError().
extern "C" int lt_row_gather(int transposed, const void* X, const void* ids,
                             void* out, int n, int K, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (K <= 0 || r <= 0) return (int)cudaGetLastError();
  if (transposed) {
    gather_cols_kernel<<<blocks_for(K), THREADS, 0, s>>>(
        static_cast<const float*>(X), id, static_cast<float*>(out), n, K, r);
  } else if (r % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
             (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const long total = (long)K * (r / 4);
    gather_rows_kernel<float4><<<blocks_for(total), THREADS, 0, s>>>(
        static_cast<const float4*>(X), id, static_cast<float4*>(out), total,
        r / 4);
  } else {
    const long total = (long)K * r;
    gather_rows_kernel<float><<<blocks_for(total), THREADS, 0, s>>>(
        static_cast<const float*>(X), id, static_cast<float*>(out), total, r);
  }
  return (int)cudaGetLastError();
}
