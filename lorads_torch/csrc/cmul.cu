// K2 cmul_csr: C @ X for a split bucket, as one fused CSR SpMM.
//
// Replaces lorads_tpu/ops/pattern.py: cmul.  The TPU version gathers
// X at the full-symmetric entry columns into a [B, Ks, r] product,
// scales it by C's values and reduces it with the compensated prefix
// scan comp_segment_sum (K1), slicing the entry list into chunks when it
// exceeds 8M entries to bound that transient in HBM.  Here one warp owns
// one row i and fuses the gather, the multiply and the segment sum:
//
//   out[b, i, c] = c_diag[b, i] * X[b, i, c]
//                + sum_{k in [bnd[b, i], bnd[b, i+1])} vals[b, k] * X[b, cols[b, k], c]
//
// so the [Ks, r] product is never written and no chunking is needed.
// c_diag == nullptr drops the diagonal term (the certificate matvec,
// include_diag=False).
//
// Layout: with r > 1 the lanes run over the r columns (one coalesced
// row of X per entry; the entry's column and value are broadcast loads)
// and walk the row's entries in order; with r == 1 (the Lanczos SpMV)
// the lanes stride over the row's entries and combine by shuffles.
// f32 sums are Neumaier-compensated (warp_acc.cuh), f64 sums are direct.
//
// What bounds it: memory traffic.  At maxcut n=20000, Ks=160000, r=20
// in f64, X is 3.2 MB and stays in the 50 MB L2; the kernel streams the
// 160k (col, val) entries (1.9 MB) and the gathered X rows come from L2.
// Max-Cut rows hold ~16 entries, so a warp per row keeps loads short and
// needs no cross-warp reduction.

#include <cuda_runtime.h>

#include "warp_acc.cuh"

namespace {

using lt::Acc;
constexpr int WARPS_PER_BLOCK = 8;

template <typename T>
__global__ void cmul_kernel(const T* __restrict__ X,
                            const T* __restrict__ c_diag,
                            const int* __restrict__ cols,
                            const T* __restrict__ vals,
                            const int* __restrict__ bnd, T* __restrict__ out,
                            int B, int n, int Ks, int r) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * n) return;  // uniform across the warp
  const int b = (int)(warp / n), i = (int)(warp % n);
  const int lo = bnd[(long)b * (n + 1) + i];
  const int hi = bnd[(long)b * (n + 1) + i + 1];
  const T* Xb = X + (long)b * n * r;
  const int* cb = cols + (long)b * Ks;
  const T* vb = vals + (long)b * Ks;
  T* ob = out + (long)b * n * r;
  if (r == 1) {
    Acc<T> acc;
    for (int k = lo + lane; k < hi; k += 32) acc.add(vb[k] * Xb[cb[k]]);
    for (int off = 16; off > 0; off >>= 1) acc.merge_down(off);
    if (lane == 0) {
      T v = acc.value();
      if (c_diag != nullptr) v = c_diag[(long)b * n + i] * Xb[i] + v;
      ob[i] = v;
    }
  } else {
    for (int c = lane; c < r; c += 32) {
      Acc<T> acc;
      for (int k = lo; k < hi; ++k) acc.add(vb[k] * Xb[(long)cb[k] * r + c]);
      T v = acc.value();
      if (c_diag != nullptr)
        v = c_diag[(long)b * n + i] * Xb[(long)i * r + c] + v;
      ob[(long)i * r + c] = v;
    }
  }
}

template <typename T>
int launch(const void* X, const void* c_diag, const void* cols,
           const void* vals, const void* bnd, void* out, int B, int n,
           int Ks, int r, cudaStream_t stream) {
  const long warps = (long)B * n;
  if (warps > 0) {
    const long blocks = (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    cmul_kernel<T><<<(unsigned)blocks, 32 * WARPS_PER_BLOCK, 0, stream>>>(
        static_cast<const T*>(X), static_cast<const T*>(c_diag),
        static_cast<const int*>(cols), static_cast<const T*>(vals),
        static_cast<const int*>(bnd), static_cast<T*>(out), B, n, Ks, r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// X [B, n, r], c_diag [B, n] or NULL, cols int32 [B, Ks], vals [B, Ks],
// bnd int32 [B, n+1] (row pointers into the row-sorted entry list),
// out [B, n, r]; all contiguous.  is_f64: 1 for float64, 0 for float32.
// Returns cudaGetLastError().
extern "C" int lt_cmul(int is_f64, const void* X, const void* c_diag,
                       const void* cols, const void* vals, const void* bnd,
                       void* out, int B, int n, int Ks, int r,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(X, c_diag, cols, vals, bnd, out, B, n, Ks,
                                 r, s)
                : launch<float>(X, c_diag, cols, vals, bnd, out, B, n, Ks,
                                r, s);
}
