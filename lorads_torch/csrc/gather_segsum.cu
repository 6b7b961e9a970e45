// K4 gather_segsum: a gather fused with a sorted segment sum.
//
// Replaces, in lorads_tpu/ops/pattern.py, constr_vals (:1140: A(.) on the
// pattern values, split and dense), the W_d / W_o / dense sums of
// build_w (:1250-1304), the dd sums of the dense CG operator
// (:1466-1470) and scatter_constr (:1189), and in lorads_tpu/ops/lp.py
// the LP's constr_vals and adjoint_cols (:113, :128).  The TPU version
// gathers x at the entries into a [B, N] product, multiplies by the entry
// values and reduces it with the compensated prefix scan comp_segment_sum
// (K1) -- or, when every segment holds one entry, an exact masked gather
// (single_segment_sum).  Here the segment bounds are CSR pointers and one
// pass does all of it:
//
//   out[b, s] = base[b, s]
//             + alpha * sum_{k in [bnd[b, s], bnd[b, s+1])} val[b, k] * x[b, idx[b, k]]
//
// with base == nullptr read as 0.  x has any length Nx (the diagonal of
// sym(UV^T), its off-pattern values, a flat [n^2] matrix, or a
// constraint-space vector).
//
// What bounds it: not bytes (theta800's dense A(.) moves 0.1 MB, 0.00004
// ms at 3.35 TB/s) but the latency of the dependent loads bnd -> idx ->
// x, an L2 round trip each.  A schedule that walks a segment in one
// thread pays that latency once per entry: theta's trace constraint (800
// entries among 3200 one-entry constraints) took 800 serial gathers.  So
// the schedule spends the card's parallelism on the entries of a segment
// and keeps several loads in flight per lane:
//
// * G lanes per segment, G a power of two from 1 to 32 picked on the host
//   from the mean segment length N / S (shapes only: reading bnd on the
//   host would sync every call).  A warp takes 32 / G consecutive
//   segments; the G lanes of a segment stride over its entries and
//   combine by a shuffle tree.  Layouts of one- or two-entry segments
//   (matcomp's A(.), C + A^*(w), the dense dd sums, scatter_constr) keep
//   G = 1; the LP's K8a / K8b (60-200 entries per segment) take G = 32.
// * A segment longer than 8 G entries is left by its group; after the
//   group pass the warp takes each such segment in turn (__ballot_sync)
//   with all 32 lanes, so no lane walks more than ceil(len / 32) entries
//   of it: theta800's trace is 25 strided steps per lane, not 800.
// * Each lane loop issues its idx / val loads and x gathers ahead of the
//   accumulation, U entries at a time (U = 4 in the group pass, 1 with
//   G = 1, 8 in the warp pass).  With G = 32 (K8a, K8b: a few entries per
//   lane) the last batch is predicated, so a lane's entries are one round
//   of loads; elsewhere the remainder is walked one by one (predicated
//   batches there took 48-62 registers and cost the one-entry layouts and
//   theta's trace 10-30 %).
// * No __launch_bounds__: with it ptxas held the G = 1 instances to 32 or
//   40 registers and spilled 4-8 bytes, which cost the one-entry layouts
//   5-10 % against the parent's thread-per-segment kernel.
//
// Segments of many thousand entries (a theta of n >= 4096 has a trace of
// that length) would be better served by a block per segment and a
// second pass over the blocks' sums; no path of today has one, and a
// warp walks them correctly.
//
// Exactness: a one-entry segment is summed exactly (0 + p == p, the other
// lanes add zeros), as the reference's single_segment_sum is; alpha and
// base are applied with _rn intrinsics, one rounding each, so one-entry
// outputs equal the plain version's bit for bit.  f32 sums are
// Neumaier-compensated (warp_acc.cuh), f64 sums direct.  No atomics: each
// output's order of summation is fixed from run to run.

#include <climits>

#include <cuda_runtime.h>

#include "warp_acc.cuh"

namespace {

using lt::Acc;
using lt::FULL;
constexpr int THREADS = 256;

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

// acc += sum_{k = lo + first, step apart, below hi} vb[k] * xb[ib[k]], in
// order of k, U entries' loads in flight at a time; PRED: the last,
// partial batch too.
template <typename T, int U, bool PRED = false>
__device__ __forceinline__ void walk(Acc<T>& acc, const T* __restrict__ xb,
                                     const int* __restrict__ ib,
                                     const T* __restrict__ vb, int lo, int hi,
                                     int first, int step) {
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
    return;
  }
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

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ out,
                                      const T* __restrict__ base, long t,
                                      T sum, T alpha) {
  T v = mul_rn(alpha, sum);
  if (base != nullptr) v = add_rn(base[t], v);
  out[t] = v;
}

template <typename T, int G>
__global__ void segsum_kernel(const T* __restrict__ x,
                              const int* __restrict__ idx,
                              const T* __restrict__ val,
                              const int* __restrict__ bnd,
                              const T* __restrict__ base, T* __restrict__ out,
                              int B, int Nx, int N, int S, T alpha,
                              int long_min) {
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
                val + (long)b * N, lo, hi, gl, G);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) acc.merge_down(off);
  if (gl == 0 && t < segs && !is_long) store(out, base, t, acc.value(), alpha);
  // warp pass: the long segments, one at a time, all 32 lanes on each
  while (longs != 0u) {
    const int src = __ffs(longs) - 1;
    longs &= longs - 1u;
    const int lb = __shfl_sync(FULL, b, src);
    const int llo = __shfl_sync(FULL, lo, src);
    const int lhi = __shfl_sync(FULL, hi, src);
    Acc<T> w;
    walk<T, UW>(w, x + (long)lb * Nx, idx + (long)lb * N,
                val + (long)lb * N, llo, lhi, lane, 32);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w.merge_down(off);
    if (lane == 0) store(out, base, seg0 + src / G, w.value(), alpha);
  }
}

// Lanes per segment from the mean segment length: 1 up to two entries
// on average, else the power of two at or above the mean, at most 32.
int lanes_per_segment(long N, long S) {
  if (S <= 0 || N <= 2 * S) return 1;
  int G = 2;
  while (G < 32 && (long)G * S < N) G <<= 1;
  return G;
}

template <typename T, int G>
void launch_g(const T* x, const int* idx, const T* val, const int* bnd,
              const T* base, T* out, int B, int Nx, int N, int S, T alpha,
              cudaStream_t stream) {
  const long segs = (long)B * S;
  const long warps = (segs + 32 / G - 1) / (32 / G);
  const long blocks = (warps * 32 + THREADS - 1) / THREADS;
  // a group of 32 lanes is the warp: nothing is left for the warp pass
  const int long_min = G == 32 ? INT_MAX : 8 * G;
  segsum_kernel<T, G><<<(unsigned)blocks, THREADS, 0, stream>>>(
      x, idx, val, bnd, base, out, B, Nx, N, S, alpha, long_min);
}

template <typename T>
int launch(const void* x, const void* idx, const void* val, const void* bnd,
           const void* base, void* out, int B, int Nx, int N, int S,
           double alpha, cudaStream_t stream) {
  if ((long)B * S > 0) {
    const T* xs = static_cast<const T*>(x);
    const int* is = static_cast<const int*>(idx);
    const T* vs = static_cast<const T*>(val);
    const int* bs = static_cast<const int*>(bnd);
    const T* ba = static_cast<const T*>(base);
    T* o = static_cast<T*>(out);
    const T a = (T)alpha;
    switch (lanes_per_segment(N, S)) {
      case 1: launch_g<T, 1>(xs, is, vs, bs, ba, o, B, Nx, N, S, a, stream);
        break;
      case 2: launch_g<T, 2>(xs, is, vs, bs, ba, o, B, Nx, N, S, a, stream);
        break;
      case 4: launch_g<T, 4>(xs, is, vs, bs, ba, o, B, Nx, N, S, a, stream);
        break;
      case 8: launch_g<T, 8>(xs, is, vs, bs, ba, o, B, Nx, N, S, a, stream);
        break;
      case 16: launch_g<T, 16>(xs, is, vs, bs, ba, o, B, Nx, N, S, a, stream);
        break;
      default: launch_g<T, 32>(xs, is, vs, bs, ba, o, B, Nx, N, S, a, stream);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, Nx], idx int32 [B, N] into x, val [B, N], bnd int32 [B, S+1]
// nondecreasing within [0, N], base [B, S] or NULL, out [B, S]; all
// contiguous.  is_f64: 1 for float64, 0 for float32.
// Returns cudaGetLastError().
extern "C" int lt_gather_segsum(int is_f64, const void* x, const void* idx,
                                const void* val, const void* bnd,
                                const void* base, void* out, int B, int Nx,
                                int N, int S, double alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(x, idx, val, bnd, base, out, B, Nx, N, S,
                                 alpha, s)
                : launch<float>(x, idx, val, bnd, base, out, B, Nx, N, S,
                                alpha, s);
}
