// K5 wmul_csr: W @ X for a split bucket whose W changes every call.
//
// Replaces the split branches of lorads_tpu/ops/pattern.py: w_mul and
// w_mul_cached.  W = C + A^*(w) is symmetric with the diagonal W_d and
// the strictly-lower pattern values W_o (build_w).  The TPU version runs
// two sorted segment sums, a lower pass over the row-sorted off entries
// (a [Ko] gather of W_o through off_row_perm first) and an upper pass
// over a column-sorted mirror of the pattern whose W values build_w
// writes a second time, because unsorted TPU scatters run at random-
// access latency.  Here the pattern is stored once as a full-symmetric,
// row-sorted entry list (every lower entry and its mirror), each entry
// carrying the off slot it reads, and one warp owns one row i:
//
//   out[b, i, c] = W_d[b, i] * X[b, i, c]
//                + sum_{k in [bnd[b, i], bnd[b, i+1])} W_o[b, slot[b, k]] * X[b, cols[b, k], c]
//
// so one pass replaces both passes, the row-perm gather and the mirror
// write.  A slot of -1 (padding) reads 0.
//
// Layout (as K2 cmul_csr): with r > 1 the lanes run over the r columns
// (one coalesced row of X per entry; the entry's column and slot are
// broadcast loads) and walk the row's entries in order; with r == 1 (the
// certificate's Lanczos SpMV) the lanes stride over the row's entries
// and combine by shuffles.  f32 sums are Neumaier-compensated
// (warp_acc.cuh), f64 sums direct.
//
// What bounds it: memory traffic -- per entry a (col, slot) pair and one
// W_o value read at random from L2 (W_o is 3.8 MB at matcomp2000's
// Ko = 478843 in f64) and an r-wide row of X from L2 (X is 0.5 MB at
// n = 4000, r = 17); rows hold ~240 entries there.

#include <cuda_runtime.h>

#include "warp_acc.cuh"

namespace {

using lt::Acc;
constexpr int WARPS_PER_BLOCK = 8;

template <typename T>
__device__ __forceinline__ T slot_value(const T* __restrict__ W_o, int s) {
  return s >= 0 ? W_o[s] : T(0);
}

template <typename T>
__global__ void wmul_kernel(const T* __restrict__ X,
                            const T* __restrict__ W_d,
                            const T* __restrict__ W_o,
                            const int* __restrict__ slots,
                            const int* __restrict__ cols,
                            const int* __restrict__ bnd, T* __restrict__ out,
                            int B, int n, int Ko, int Ks, int r) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * n) return;  // uniform across the warp
  const int b = (int)(warp / n), i = (int)(warp % n);
  const int lo = bnd[(long)b * (n + 1) + i];
  const int hi = bnd[(long)b * (n + 1) + i + 1];
  const T* Xb = X + (long)b * n * r;
  const T* Wb = W_o + (long)b * Ko;
  const int* sb = slots + (long)b * Ks;
  const int* cb = cols + (long)b * Ks;
  T* ob = out + (long)b * n * r;
  const T wd = W_d[(long)b * n + i];
  if (r == 1) {
    Acc<T> acc;
    for (int k = lo + lane; k < hi; k += 32)
      acc.add(slot_value(Wb, sb[k]) * Xb[cb[k]]);
    for (int off = 16; off > 0; off >>= 1) acc.merge_down(off);
    if (lane == 0) ob[i] = wd * Xb[i] + acc.value();
  } else {
    for (int c = lane; c < r; c += 32) {
      Acc<T> acc;
      for (int k = lo; k < hi; ++k)
        acc.add(slot_value(Wb, sb[k]) * Xb[(long)cb[k] * r + c]);
      ob[(long)i * r + c] = wd * Xb[(long)i * r + c] + acc.value();
    }
  }
}

template <typename T>
int launch(const void* X, const void* W_d, const void* W_o,
           const void* slots, const void* cols, const void* bnd, void* out,
           int B, int n, int Ko, int Ks, int r, cudaStream_t stream) {
  const long warps = (long)B * n;
  if (warps > 0) {
    const long blocks = (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    wmul_kernel<T><<<(unsigned)blocks, 32 * WARPS_PER_BLOCK, 0, stream>>>(
        static_cast<const T*>(X), static_cast<const T*>(W_d),
        static_cast<const T*>(W_o), static_cast<const int*>(slots),
        static_cast<const int*>(cols), static_cast<const int*>(bnd),
        static_cast<T*>(out), B, n, Ko, Ks, r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// X [B, n, r], W_d [B, n], W_o [B, Ko], slots and cols int32 [B, Ks]
// sorted by row, bnd int32 [B, n+1] row pointers, out [B, n, r]; all
// contiguous.  is_f64: 1 for float64, 0 for float32.
// Returns cudaGetLastError().
extern "C" int lt_wmul(int is_f64, const void* X, const void* W_d,
                       const void* W_o, const void* slots, const void* cols,
                       const void* bnd, void* out, int B, int n, int Ko,
                       int Ks, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(X, W_d, W_o, slots, cols, bnd, out, B, n,
                                 Ko, Ks, r, s)
                : launch<float>(X, W_d, W_o, slots, cols, bnd, out, B, n,
                                Ko, Ks, r, s);
}
