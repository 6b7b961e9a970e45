// Warp-level accumulators shared by the lorads_torch kernels.
//
// Acc<double> sums directly.  Acc<float> is a Neumaier (Kahan-Babuska)
// compensated sum written with __fadd_rn/__fsub_rn, so no compiler
// contraction can fold its error term away (the kernels are built
// without --use_fast_math).  merge_down(off) adds the accumulator of
// lane + off (warp shuffle), for tree reductions across a warp.

#pragma once
#include <cuda_runtime.h>

namespace lt {

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Acc {
  T s = 0;
  __device__ void add(T x) { s += x; }
  __device__ void merge_down(int off) { s += __shfl_down_sync(FULL, s, off); }
  __device__ T value() const { return s; }
};

template <>
struct Acc<float> {
  float s = 0.f, c = 0.f;
  __device__ void add(float x) {
    float t = __fadd_rn(s, x);
    if (fabsf(s) >= fabsf(x)) {
      c = __fadd_rn(c, __fadd_rn(__fsub_rn(s, t), x));
    } else {
      c = __fadd_rn(c, __fadd_rn(__fsub_rn(x, t), s));
    }
    s = t;
  }
  __device__ void merge_down(int off) {
    float s2 = __shfl_down_sync(FULL, s, off);
    float c2 = __shfl_down_sync(FULL, c, off);
    add(s2);
    c = __fadd_rn(c, c2);
  }
  __device__ float value() const { return __fadd_rn(s, c); }
};

template <typename T>
__device__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

}  // namespace lt

