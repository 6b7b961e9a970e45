// The segment-sum schedule of K4 (gather_segsum.cu, whose header says
// why it is shaped so), shared with K2's r = 1 matvec (cmul.cu):
//
//   sum[b, s] = sum_{k in [bnd[b, s], bnd[b, s+1])} val[b, k] * x[b, idx[b, k]]
//
// with G lanes per segment (lanes_per_segment, from the shapes alone),
// segments longer than 8 G entries taken by the whole warp after the
// group pass, loads issued ahead.  Each caller's Store functor writes
// the output: store(t, b, sum) with t = b * S + s.  The values are an
// array val [B, N], or (K5 at r = 1, wmul.cu) SlotVal: val[b, k] =
// W_o[b, slot[b, k]], 0 where the slot is -1.

#pragma once
#include <climits>

#include <cuda_runtime.h>

#include "warp_acc.cuh"

namespace lt {

constexpr int SEGSUM_THREADS = 256;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// the values of the entries read through their off slots
template <typename T>
struct SlotVal {
  const T* w;     // W_o [B, Ko]
  const int* s;   // slots [B, N], -1: padding
  int Ko;
  __device__ __forceinline__ T operator[](int k) const {
    const int q = s[k];
    return q >= 0 ? w[q] : T(0);
  }
};

// a value array stays __restrict__ as a kernel parameter
template <typename V>
struct restrict_ptr {
  using type = V;
};
template <typename T>
struct restrict_ptr<const T*> {
  using type = const T* __restrict__;
};

// block b's values
template <typename T>
__device__ __forceinline__ const T* block_vals(const T* v, int b, int N) {
  return v + (long)b * N;
}
template <typename T>
__device__ __forceinline__ SlotVal<T> block_vals(SlotVal<T> v, int b, int N) {
  return {v.w + (long)b * v.Ko, v.s + (long)b * N, v.Ko};
}

// out[t] = diag[t] * x[t] + sum (diag == nullptr: sum), each operation
// rounded once (_rn): K2's and K5's r = 1 outputs
template <typename T>
struct StoreDiag {
  const T* x;
  const T* diag;
  T* out;
  __device__ __forceinline__ void operator()(long t, int, T sum) const {
    T v = sum;
    if (diag != nullptr) v = add_rn(mul_rn(diag[t], x[t]), v);
    out[t] = v;
  }
};

// acc += sum_{k = lo + first, step apart, below hi} vb[k] * xb[ib[k]], in
// order of k, U entries' loads in flight at a time; PRED: the last,
// partial batch too.  V: const T* or SlotVal<T>.
template <typename T, int U, bool PRED = false, typename V>
__device__ __forceinline__ void walk(Acc<T>& acc, const T* __restrict__ xb,
                                     const int* __restrict__ ib, V vb, int lo,
                                     int hi, int first, int step) {
  int k = lo + first;
  if constexpr (PRED) {
    for (; k < hi; k += U * step) {
      int i[U];
      T v[U], g[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool in = k + u * step < hi;
        i[u] = in ? ib[k + u * step] : 0;
        v[u] = in ? vb[k + u * step] : T(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) g[u] = k + u * step < hi ? xb[i[u]] : T(0);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u * step < hi) acc.add(v[u] * g[u]);
    }
  } else {
    for (; k + (U - 1) * step < hi; k += U * step) {
      int i[U];
      T v[U], g[U];
#pragma unroll
      for (int u = 0; u < U; ++u) i[u] = ib[k + u * step];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = vb[k + u * step];
#pragma unroll
      for (int u = 0; u < U; ++u) g[u] = xb[i[u]];
#pragma unroll
      for (int u = 0; u < U; ++u) acc.add(v[u] * g[u]);
    }
    for (; k < hi; k += step) acc.add(vb[k] * xb[ib[k]]);
  }
}

template <typename T, int G, typename Store, typename V>
__global__ void segsum_kernel(const T* __restrict__ x,
                              const int* __restrict__ idx,
                              typename restrict_ptr<V>::type val,
                              const int* __restrict__ bnd, int B, int Nx,
                              int N, int S, int long_min, Store store) {
  constexpr int SPW = 32 / G;  // segments per warp
  // batch sizes of the group and warp passes: with G = 1 a lane walks
  // the one or two entries of its own segment
  constexpr int UG = G == 1 ? 1 : 4, UW = 8;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;     // lane within the segment's group
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const long segs = (long)B * S;
  const long seg0 = warp * SPW;
  const long t = seg0 + lane / G;
  int b = 0, lo = 0, hi = 0;
  if (t < segs) {
    b = (int)(t / S);
    const int* bb = bnd + (long)b * (S + 1) + (t - (long)b * S);
    lo = bb[0];
    hi = bb[1];
  }
  const bool is_long = hi - lo > long_min;
  // the warp's long segments, taken before the group pass so that the
  // lanes of a warp without one (every warp when G = 32) retire one by
  // one after it
  unsigned longs =
      G == 32 ? 0u : __ballot_sync(FULL, gl == 0 && t < segs && is_long);
  // group pass: every segment of at most long_min entries
  Acc<T> acc;
  if (!is_long)
    walk<T, UG, G == 32>(acc, x + (long)b * Nx, idx + (long)b * N,
                         block_vals(val, b, N), lo, hi, gl, G);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) acc.merge_down(off);
  if (gl == 0 && t < segs && !is_long) store(t, b, acc.value());
  // warp pass: the long segments, one at a time, all 32 lanes on each
  while (longs != 0u) {
    const int src = __ffs(longs) - 1;
    longs &= longs - 1u;
    const int lb = __shfl_sync(FULL, b, src);
    const int llo = __shfl_sync(FULL, lo, src);
    const int lhi = __shfl_sync(FULL, hi, src);
    Acc<T> w;
    walk<T, UW>(w, x + (long)lb * Nx, idx + (long)lb * N,
                block_vals(val, lb, N), llo, lhi, lane, 32);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w.merge_down(off);
    if (lane == 0) store(seg0 + src / G, lb, w.value());
  }
}

// Lanes per segment from the mean segment length: 1 up to two entries
// on average, else the power of two at or above the mean, at most 32.
inline int lanes_per_segment(long N, long S) {
  if (S <= 0 || N <= 2 * S) return 1;
  int G = 2;
  while (G < 32 && (long)G * S < N) G <<= 1;
  return G;
}

template <typename T, int G, typename Store, typename V>
void launch_segsum_g(const T* x, const int* idx, V val, const int* bnd,
                     int B, int Nx, int N, int S, Store store,
                     cudaStream_t stream) {
  const long segs = (long)B * S;
  const long warps = (segs + 32 / G - 1) / (32 / G);
  const long blocks = (warps * 32 + SEGSUM_THREADS - 1) / SEGSUM_THREADS;
  // a group of 32 lanes is the warp: nothing is left for the warp pass
  const int long_min = G == 32 ? INT_MAX : 8 * G;
  segsum_kernel<T, G, Store, V><<<(unsigned)blocks, SEGSUM_THREADS, 0,
                                  stream>>>(
      x, idx, val, bnd, B, Nx, N, S, long_min, store);
}

// x [B, Nx], idx [B, N] into x, val [B, N], bnd [B, S+1]: one launch of
// the instance for lanes_per_segment(N, S); nothing when B * S == 0.
template <typename T, typename Store, typename V>
void launch_segsum(const T* x, const int* idx, V val, const int* bnd,
                   int B, int Nx, int N, int S, Store store,
                   cudaStream_t stream) {
  if ((long)B * S <= 0) return;
  switch (lanes_per_segment(N, S)) {
    case 1: launch_segsum_g<T, 1>(x, idx, val, bnd, B, Nx, N, S, store, stream);
      break;
    case 2: launch_segsum_g<T, 2>(x, idx, val, bnd, B, Nx, N, S, store, stream);
      break;
    case 4: launch_segsum_g<T, 4>(x, idx, val, bnd, B, Nx, N, S, store, stream);
      break;
    case 8: launch_segsum_g<T, 8>(x, idx, val, bnd, B, Nx, N, S, store, stream);
      break;
    case 16: launch_segsum_g<T, 16>(x, idx, val, bnd, B, Nx, N, S, store,
                                    stream);
      break;
    default: launch_segsum_g<T, 32>(x, idx, val, bnd, B, Nx, N, S, store,
                                    stream);
  }
}

}  // namespace lt
