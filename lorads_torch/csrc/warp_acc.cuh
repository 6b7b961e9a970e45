// Warp-level accumulators shared by the lorads_torch kernels.
//
// Acc<double> sums directly, and Direct<T> at either type.  Acc<float>
// is a Neumaier (Kahan-Babuska) compensated sum written with
// __fadd_rn/__fsub_rn, so no compiler contraction can fold its error
// term away (the kernels are built without --use_fast_math).
// merge_down(off) adds the accumulator of lane + off (warp shuffle), for
// tree reductions across a warp; merge(o) adds the accumulator o.

#pragma once
#include <cuda_runtime.h>

namespace lt {

constexpr unsigned FULL = 0xffffffffu;

// a direct sum in T at either type (K3's sums)
template <typename T>
struct Direct {
  T s = 0;
  __device__ void add(T x) { s += x; }
  __device__ void merge_down(int off) { s += __shfl_down_sync(FULL, s, off); }
  __device__ void merge(const Direct& o) { s += o.s; }
  __device__ T value() const { return s; }
};

template <typename T>
struct Acc : Direct<T> {};

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
  // the same merge with an accumulator at hand (K1's entry groups)
  __device__ void merge(const Acc& o) {
    add(o.s);
    c = __fadd_rn(c, o.c);
  }
  __device__ float value() const { return __fadd_rn(s, c); }
};

// the accumulator's value in f64: a compensated f32 sum keeps its
// error term (one rounding less than value())
__device__ __forceinline__ double wide(const Acc<double>& a) { return a.s; }
__device__ __forceinline__ double wide(const Acc<float>& a) {
  return (double)a.s + (double)a.c;
}

}  // namespace lt

