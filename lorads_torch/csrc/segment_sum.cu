// K1 segment_sum_csr: sorted segment sums over CSR bounds.
//
// Replaces lorads_tpu/ops/pattern.py: comp_segment_sum (with its
// _pair_scan / _twosum helpers) and single_segment_sum.  The TPU version
// computes a compensated TwoSum prefix scan over the whole [B, N] array
// and differences it at the segment boundaries, because the TPU has no
// fast scatter and no native f64.  Here the bounds are CSR row pointers,
// so each segment is summed directly and no prefix error exists:
//
//   out[b, j, c] = sum_{k in [bounds[b, j], bounds[b, j+1])} data[b, k, c]
//
// Layout: one warp per segment.  With r > 1 the lanes run over the r
// columns (coalesced 8- or 4-byte loads along a row of data) and walk the
// segment in order; with r == 1 (2-D input) the lanes stride over the
// segment's entries and combine by warp shuffles.
//
// Precision: f64 is summed directly in f64.  f32 is summed with a
// Neumaier (Kahan-Babuska) compensated accumulator, written with
// __fadd_rn/__fsub_rn so no compiler contraction can fold the error term
// away (build without --use_fast_math); that keeps the eps32 * |segment|
// contract of pattern.py:143-148.
//
// What bounds it: the card's memory bandwidth -- every input value is
// read once and each output written once; the bounds are read twice.

#include <cuda_runtime.h>

#include "warp_acc.cuh"

namespace {

using lt::Acc;
constexpr int WARPS_PER_BLOCK = 8;

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ data,
                                   const int* __restrict__ bounds,
                                   T* __restrict__ out, int B, int N, int S,
                                   int r) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * S) return;  // uniform across the warp
  const int b = (int)(warp / S), j = (int)(warp % S);
  const int* bb = bounds + (long)b * (S + 1);
  const int lo = bb[j], hi = bb[j + 1];
  const T* d = data + (long)b * N * r;
  T* o = out + ((long)b * S + j) * r;
  if (r == 1) {
    Acc<T> acc;
    for (int k = lo + lane; k < hi; k += 32) acc.add(d[k]);
    for (int off = 16; off > 0; off >>= 1) acc.merge_down(off);
    if (lane == 0) o[0] = acc.value();
  } else {
    for (int c = lane; c < r; c += 32) {
      Acc<T> acc;
      for (int k = lo; k < hi; ++k) acc.add(d[(long)k * r + c]);
      o[c] = acc.value();
    }
  }
}

template <typename T>
int launch(const void* data, const void* bounds, void* out, int B, int N,
           int S, int r, cudaStream_t stream) {
  const long warps = (long)B * S;
  if (warps > 0) {
    const long blocks = (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    segment_sum_kernel<T><<<(unsigned)blocks, 32 * WARPS_PER_BLOCK, 0,
                            stream>>>(
        static_cast<const T*>(data), static_cast<const int*>(bounds),
        static_cast<T*>(out), B, N, S, r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// data [B, N, r] (r = 1 for 2-D data), bounds int32 [B, S+1]
// nondecreasing within [0, N], out [B, S, r]; all contiguous.
// is_f64: 1 for float64, 0 for float32.  Returns cudaGetLastError().
extern "C" int lt_segment_sum(int is_f64, const void* data,
                              const void* bounds, void* out, int B, int N,
                              int S, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(data, bounds, out, B, N, S, r, s)
                : launch<float>(data, bounds, out, B, N, S, r, s);
}
