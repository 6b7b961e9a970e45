// K3 uvt_split: sym(U V^T) on a split sparsity pattern (an SDDMM).
//
// Replaces the split branch of lorads_tpu/ops/pattern.py: uvt.  The TPU
// version gathers four [B, Ko, r] row blocks (U and V at the off rows and
// off columns) into HBM and reduces their products along r.  Here:
//
//   d[b, i] = <U[b, i], V[b, i]>                                (diag kernel)
//   o[b, k] = (<U[b, i_k], V[b, j_k]> + <U[b, j_k], V[b, i_k]>) / 2   (off kernel)
//
// with i_k = rows[b, k], j_k = cols[b, k].  One warp per output entry:
// the lanes run over r (coalesced row reads; the four rows of an off
// entry come from L2, since U and V together are 6.4 MB at n=20000,
// r=20, f64) and a shuffle tree sums them.  Both kernels launch on the
// same stream from one entry point.  Sums are direct in the input type
// (the path runs it at f64).
//
// What bounds it: memory traffic -- per off entry four r-wide row reads
// from L2 and one write; Ko=80000 at maxcut n=20000.

#include <cuda_runtime.h>

#include "warp_acc.cuh"

namespace {

using lt::warp_sum;
constexpr int WARPS_PER_BLOCK = 8;

template <typename T>
__global__ void uvt_diag_kernel(const T* __restrict__ U,
                                const T* __restrict__ V, T* __restrict__ d,
                                int B, int n, int r) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * n) return;  // uniform across the warp
  const T* u = U + warp * r;
  const T* v = V + warp * r;
  T s = 0;
  for (int c = lane; c < r; c += 32) s += u[c] * v[c];
  s = warp_sum(s);
  if (lane == 0) d[warp] = s;
}

template <typename T>
__global__ void uvt_off_kernel(const T* __restrict__ U,
                               const T* __restrict__ V,
                               const int* __restrict__ rows,
                               const int* __restrict__ cols,
                               T* __restrict__ o, int B, int n, int Ko,
                               int r) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * Ko) return;  // uniform across the warp
  const int b = (int)(warp / Ko);
  const long i = rows[warp], j = cols[warp];
  const T* Ub = U + (long)b * n * r;
  const T* Vb = V + (long)b * n * r;
  T s1 = 0, s2 = 0;
  for (int c = lane; c < r; c += 32) {
    s1 += Ub[i * r + c] * Vb[j * r + c];
    s2 += Ub[j * r + c] * Vb[i * r + c];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) o[warp] = T(0.5) * (s1 + s2);
}

long blocks_for(long warps) {
  return (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
}

template <typename T>
int launch(const void* U, const void* V, const void* rows, const void* cols,
           void* d, void* o, int B, int n, int Ko, int r,
           cudaStream_t stream) {
  const T* u = static_cast<const T*>(U);
  const T* v = static_cast<const T*>(V);
  if ((long)B * n > 0) {
    uvt_diag_kernel<T><<<(unsigned)blocks_for((long)B * n),
                         32 * WARPS_PER_BLOCK, 0, stream>>>(
        u, v, static_cast<T*>(d), B, n, r);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if ((long)B * Ko > 0) {
    uvt_off_kernel<T><<<(unsigned)blocks_for((long)B * Ko),
                        32 * WARPS_PER_BLOCK, 0, stream>>>(
        u, v, static_cast<const int*>(rows), static_cast<const int*>(cols),
        static_cast<T*>(o), B, n, Ko, r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// U, V [B, n, r]; rows, cols int32 [B, Ko]; d [B, n]; o [B, Ko]; all
// contiguous.  is_f64: 1 for float64, 0 for float32.
// Returns cudaGetLastError().
extern "C" int lt_uvt_split(int is_f64, const void* U, const void* V,
                            const void* rows, const void* cols, void* d,
                            void* o, int B, int n, int Ko, int r,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(U, V, rows, cols, d, o, B, n, Ko, r, s)
                : launch<float>(U, V, rows, cols, d, o, B, n, Ko, r, s);
}
