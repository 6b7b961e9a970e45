// K4 gather_segsum: a gather fused with a sorted segment sum.
//
// Replaces the split branches of lorads_tpu/ops/pattern.py: constr_vals
// (A(.) on the diagonal and off-diagonal pattern values), the W_d / W_o
// sums of build_w (A^*(w) on the pattern slots) and the constraint-space
// round trip of a_adj_a.  The TPU version gathers x at the entries into a
// [B, N] product, multiplies by the entry values and reduces it with the
// compensated prefix scan comp_segment_sum (K1) -- or, when every segment
// holds one entry, an exact masked gather (single_segment_sum).  Here the
// segment bounds are CSR pointers and one pass does all of it:
//
//   out[b, s] = base[b, s]
//             + alpha * sum_{k in [bnd[b, s], bnd[b, s+1])} val[b, k] * x[b, idx[b, k]]
//
// with base == nullptr read as 0.  x has any length Nx (the diagonal of
// sym(UV^T), its off-pattern values, or a constraint-space vector).
//
// Layout: with short segments (at most 2 entries on average, the matrix
// completion shape where every segment holds exactly one) one thread
// owns one segment and walks it in order; otherwise one warp owns a
// segment, the lanes stride over its entries and combine by shuffles.
// A one-entry segment is summed exactly (0 + p == p), as the reference's
// single_segment_sum is.  f32 sums are Neumaier-compensated
// (warp_acc.cuh), f64 sums direct.
//
// What bounds it: memory traffic -- one (idx, val) pair and one gathered
// x value per entry, one output per segment; at matcomp2000 478843
// entries of 12 bytes and an x of 3.8 MB that stays in the 50 MB L2.

#include <cuda_runtime.h>

#include "warp_acc.cuh"

namespace {

using lt::Acc;
constexpr int THREADS = 256;

template <typename T>
__global__ void segsum_thread_kernel(const T* __restrict__ x,
                                     const int* __restrict__ idx,
                                     const T* __restrict__ val,
                                     const int* __restrict__ bnd,
                                     const T* __restrict__ base,
                                     T* __restrict__ out, int B, int Nx,
                                     int N, int S, T alpha) {
  const long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (t >= (long)B * S) return;
  const int b = (int)(t / S), s = (int)(t % S);
  const int* bb = bnd + (long)b * (S + 1);
  const T* xb = x + (long)b * Nx;
  const int* ib = idx + (long)b * N;
  const T* vb = val + (long)b * N;
  Acc<T> acc;
  for (int k = bb[s]; k < bb[s + 1]; ++k) acc.add(vb[k] * xb[ib[k]]);
  T v = alpha * acc.value();
  if (base != nullptr) v = base[t] + v;
  out[t] = v;
}

template <typename T>
__global__ void segsum_warp_kernel(const T* __restrict__ x,
                                   const int* __restrict__ idx,
                                   const T* __restrict__ val,
                                   const int* __restrict__ bnd,
                                   const T* __restrict__ base,
                                   T* __restrict__ out, int B, int Nx, int N,
                                   int S, T alpha) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * S) return;  // uniform across the warp
  const int b = (int)(warp / S), s = (int)(warp % S);
  const int* bb = bnd + (long)b * (S + 1);
  const T* xb = x + (long)b * Nx;
  const int* ib = idx + (long)b * N;
  const T* vb = val + (long)b * N;
  Acc<T> acc;
  for (int k = bb[s] + lane; k < bb[s + 1]; k += 32)
    acc.add(vb[k] * xb[ib[k]]);
  for (int off = 16; off > 0; off >>= 1) acc.merge_down(off);
  if (lane == 0) {
    T v = alpha * acc.value();
    if (base != nullptr) v = base[warp] + v;
    out[warp] = v;
  }
}

template <typename T>
int launch(const void* x, const void* idx, const void* val, const void* bnd,
           const void* base, void* out, int B, int Nx, int N, int S,
           double alpha, cudaStream_t stream) {
  const long segs = (long)B * S;
  if (segs > 0) {
    const T* xs = static_cast<const T*>(x);
    const int* is = static_cast<const int*>(idx);
    const T* vs = static_cast<const T*>(val);
    const int* bs = static_cast<const int*>(bnd);
    const T* ba = static_cast<const T*>(base);
    T* o = static_cast<T*>(out);
    if ((long)N <= 2L * S) {
      const long blocks = (segs + THREADS - 1) / THREADS;
      segsum_thread_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
          xs, is, vs, bs, ba, o, B, Nx, N, S, (T)alpha);
    } else {
      const long blocks = (segs * 32 + THREADS - 1) / THREADS;
      segsum_warp_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
          xs, is, vs, bs, ba, o, B, Nx, N, S, (T)alpha);
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
