// K3p uvt_pair_split: (sym(R D^T), sym(D D^T)) on a split pattern in
// one pass (an SDDMM pair).
//
// Replaces the split branches of lorads_tpu/ops/pattern.py: uvt_pair and
// uvt_pair_cached, the ALM line search's pair evaluation (ALMCalq12p12,
// lorads_alm.c:540-560).  The TPU version gathers four [B, Ko, r] row
// blocks (R and D at the off rows and the off columns) into HBM -- or
// keeps R's two of them as an incrementally updated cache -- and reduces
// their products along r.  Here:
//
//   rd_d[b, i] = <R_i, D_i>,   dd_d[b, i] = <D_i, D_i>            (diag kernel)
//   rd_o[b, k] = (<R_i, D_j> + <R_j, D_i>) / 2,
//   dd_o[b, k] = <D_i, D_j>,   i = rows[b, k], j = cols[b, k]      (off kernel)
//
// One warp per output entry, the lanes over r (a loop when r > 32): each
// off warp reads the four rows R_i, R_j, D_i, D_j once, from L2 (R and D
// are 0.5 MB each at n = 4000, r = 17 in f64), and writes two values, so
// the gathered [Ko, r] blocks never exist and no cache is needed.  Both
// kernels launch on the same stream from one entry point.  f32 sums are
// Neumaier-compensated (warp_acc.cuh), f64 sums direct.
//
// What bounds it: L2 traffic -- four r-wide row reads per off entry
// (Ko = 478843 at matcomp2000) and two writes.

#include <cuda_runtime.h>

#include "warp_acc.cuh"

namespace {

using lt::Acc;
constexpr int WARPS_PER_BLOCK = 8;

template <typename T>
__global__ void pair_diag_kernel(const T* __restrict__ R,
                                 const T* __restrict__ D,
                                 T* __restrict__ rd_d, T* __restrict__ dd_d,
                                 int B, int n, int r) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * n) return;  // uniform across the warp
  const T* rr = R + warp * r;
  const T* dd = D + warp * r;
  Acc<T> a, c;
  for (int k = lane; k < r; k += 32) {
    a.add(rr[k] * dd[k]);
    c.add(dd[k] * dd[k]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    a.merge_down(off);
    c.merge_down(off);
  }
  if (lane == 0) {
    rd_d[warp] = a.value();
    dd_d[warp] = c.value();
  }
}

template <typename T>
__global__ void pair_off_kernel(const T* __restrict__ R,
                                const T* __restrict__ D,
                                const int* __restrict__ rows,
                                const int* __restrict__ cols,
                                T* __restrict__ rd_o, T* __restrict__ dd_o,
                                int B, int n, int Ko, int r) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * Ko) return;  // uniform across the warp
  const int b = (int)(warp / Ko);
  const long i = rows[warp], j = cols[warp];
  const T* Rb = R + (long)b * n * r;
  const T* Db = D + (long)b * n * r;
  Acc<T> s1, s2, s3;
  for (int k = lane; k < r; k += 32) {
    const T ri = Rb[i * r + k], rj = Rb[j * r + k];
    const T di = Db[i * r + k], dj = Db[j * r + k];
    s1.add(ri * dj);
    s2.add(rj * di);
    s3.add(di * dj);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1.merge_down(off);
    s2.merge_down(off);
    s3.merge_down(off);
  }
  if (lane == 0) {
    rd_o[warp] = T(0.5) * (s1.value() + s2.value());
    dd_o[warp] = s3.value();
  }
}

long blocks_for(long warps) {
  return (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
}

template <typename T>
int launch(const void* R, const void* D, const void* rows, const void* cols,
           void* rd_d, void* rd_o, void* dd_d, void* dd_o, int B, int n,
           int Ko, int r, cudaStream_t stream) {
  const T* rp = static_cast<const T*>(R);
  const T* dp = static_cast<const T*>(D);
  if ((long)B * n > 0) {
    pair_diag_kernel<T><<<(unsigned)blocks_for((long)B * n),
                          32 * WARPS_PER_BLOCK, 0, stream>>>(
        rp, dp, static_cast<T*>(rd_d), static_cast<T*>(dd_d), B, n, r);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if ((long)B * Ko > 0) {
    pair_off_kernel<T><<<(unsigned)blocks_for((long)B * Ko),
                         32 * WARPS_PER_BLOCK, 0, stream>>>(
        rp, dp, static_cast<const int*>(rows), static_cast<const int*>(cols),
        static_cast<T*>(rd_o), static_cast<T*>(dd_o), B, n, Ko, r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// R, D [B, n, r]; rows, cols int32 [B, Ko]; rd_d, dd_d [B, n]; rd_o,
// dd_o [B, Ko]; all contiguous.  is_f64: 1 for float64, 0 for float32.
// Returns cudaGetLastError().
extern "C" int lt_uvt_pair(int is_f64, const void* R, const void* D,
                           const void* rows, const void* cols, void* rd_d,
                           void* rd_o, void* dd_d, void* dd_o, int B, int n,
                           int Ko, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(R, D, rows, cols, rd_d, rd_o, dd_d, dd_o, B,
                                 n, Ko, r, s)
                : launch<float>(R, D, rows, cols, rd_d, rd_o, dd_d, dd_o, B,
                                n, Ko, r, s);
}
