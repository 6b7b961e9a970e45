// K6 adj_a_offdiag: the off plane of A^*(A(sym(X F^T))) for constraints
// that own one pattern slot each, fused with the SDDMM that feeds it.
//
// Replaces lorads_tpu/ops/pattern.py: a_adj_a (its off plane and the
// sym(X F^T) values it is given by uvt_half_cached), the inner
// composition of the ADMM CG operator (linSysProduct,
// lorads_admm.c:376-391).  When every off constraint entry owns a
// distinct slot and a distinct constraint (a_off_unique: matrix
// completion's observations), A^*(A(.)) is the static slot-wise scale
// a2 = 2 a^2 on the off pattern.  The TPU version gathers X and F at the
// off rows and columns (or reads F's from a cache), reduces the products
// along r, scales by a2, and writes a column-order mirror of the result
// for its sorted scatters.  Here one warp per off entry k reads the four
// rows X_i, X_j, F_i, F_j from L2 and stores the scaled value directly:
//
//   W_o[b, k] = a2[b, k] * (<X_i, F_j> + <X_j, F_i>) / 2,  i = rows[b, k], j = cols[b, k]
//
// and, when d != nullptr (constraints on the diagonal also exist), a
// second kernel writes d[b, i] = <X_i, F_i> for the diagonal
// composition, which the caller runs through K4 twice.  f32 sums are
// Neumaier-compensated (warp_acc.cuh), f64 sums direct.
//
// What bounds it: L2 traffic -- four r-wide row reads, one a2 read and
// one write per off entry (Ko = 478843 at matcomp2000); every CG matvec
// of the ADMM runs it once.

#include <cuda_runtime.h>

#include "warp_acc.cuh"

namespace {

using lt::Acc;
constexpr int WARPS_PER_BLOCK = 8;

template <typename T>
__global__ void rowdot_kernel(const T* __restrict__ X,
                              const T* __restrict__ F, T* __restrict__ d,
                              int B, int n, int r) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * n) return;  // uniform across the warp
  const T* x = X + warp * r;
  const T* f = F + warp * r;
  Acc<T> a;
  for (int k = lane; k < r; k += 32) a.add(x[k] * f[k]);
  for (int off = 16; off > 0; off >>= 1) a.merge_down(off);
  if (lane == 0) d[warp] = a.value();
}

template <typename T>
__global__ void adj_off_kernel(const T* __restrict__ X,
                               const T* __restrict__ F,
                               const int* __restrict__ rows,
                               const int* __restrict__ cols,
                               const T* __restrict__ a2,
                               T* __restrict__ W_o, int B, int n, int Ko,
                               int r) {
  const long warp = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long)B * Ko) return;  // uniform across the warp
  const int b = (int)(warp / Ko);
  const long i = rows[warp], j = cols[warp];
  const T* Xb = X + (long)b * n * r;
  const T* Fb = F + (long)b * n * r;
  Acc<T> s1, s2;
  for (int k = lane; k < r; k += 32) {
    s1.add(Xb[i * r + k] * Fb[j * r + k]);
    s2.add(Xb[j * r + k] * Fb[i * r + k]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1.merge_down(off);
    s2.merge_down(off);
  }
  if (lane == 0) W_o[warp] = a2[warp] * (T(0.5) * (s1.value() + s2.value()));
}

long blocks_for(long warps) {
  return (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
}

template <typename T>
int launch(const void* X, const void* F, const void* rows, const void* cols,
           const void* a2, void* d, void* W_o, int B, int n, int Ko, int r,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(X);
  const T* fp = static_cast<const T*>(F);
  if (d != nullptr && (long)B * n > 0) {
    rowdot_kernel<T><<<(unsigned)blocks_for((long)B * n),
                       32 * WARPS_PER_BLOCK, 0, stream>>>(
        xp, fp, static_cast<T*>(d), B, n, r);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if ((long)B * Ko > 0) {
    adj_off_kernel<T><<<(unsigned)blocks_for((long)B * Ko),
                        32 * WARPS_PER_BLOCK, 0, stream>>>(
        xp, fp, static_cast<const int*>(rows), static_cast<const int*>(cols),
        static_cast<const T*>(a2), static_cast<T*>(W_o), B, n, Ko, r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// X, F [B, n, r]; rows, cols int32 [B, Ko]; a2 [B, Ko]; d [B, n] or
// NULL; W_o [B, Ko]; all contiguous.  is_f64: 1 for float64, 0 for
// float32.  Returns cudaGetLastError().
extern "C" int lt_adj_a_offdiag(int is_f64, const void* X, const void* F,
                                const void* rows, const void* cols,
                                const void* a2, void* d, void* W_o, int B,
                                int n, int Ko, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(X, F, rows, cols, a2, d, W_o, B, n, Ko, r,
                                 s)
                : launch<float>(X, F, rows, cols, a2, d, W_o, B, n, Ko, r,
                                s);
}
