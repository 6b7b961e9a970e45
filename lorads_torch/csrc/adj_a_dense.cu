// K7a adj_a_dense: A^*(A(X)) of a dense bucket whose constraints are each
// single-entry or diagonal-only.
//
// Replaces lorads_tpu/ops/pattern.py: a_adj_a_dense (lines 1458-1473), the
// inner composition of the ADMM CG operator (linSysProduct,
// lorads_admm.c:376-391) on dense buckets such as Lovasz theta's.  Every
// single-entry constraint reads one slot of X = sym(x F^T) and its adjoint
// writes the same slot (and its mirror) back, so that part is the static
// elementwise plane a2 (2 a^2 off the diagonal); the diagonal-only
// constraints (theta's trace) compose through constraint space, which the
// caller does with two K4 sums into W_d.  The TPU version writes a2 * X and
// then adds W_d (x) I as a second [n, n] plane.  Here one pass writes
// both:
//
//   out[b, i, j] = a2[b, i, j] * X[b, i, j] + (i == j) * W_d[b, i]
//
// with W_d == nullptr read as 0.  The product and the diagonal sum are
// rounded separately (__dmul_rn / __dadd_rn, __fmul_rn / __fadd_rn), so
// nvcc cannot contract them into one FMA: the kernel agrees bit for bit
// with its plain version a2 * X + diag_embed(W_d), at f64 and f32.
//
// What bounds it: device memory -- X and a2 read once and out written
// once, 3 * 8 * n^2 bytes at f64 (15.4 MB at theta800's n = 800, about
// 4.6 us at 3.35 TB/s).  Design: one block per row (b, i) of the [B * n, n]
// view, its threads striding over the row's columns j with scalar
// coalesced loads, no shared memory; the diagonal is j == i.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T>
__global__ void adj_a_dense_kernel(const T* __restrict__ X,
                                   const T* __restrict__ a2,
                                   const T* __restrict__ wd,
                                   T* __restrict__ out, int n) {
  const long row = blockIdx.x;  // b * n + i
  const int i = (int)(row % n);
  const long off = row * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    T v = mul_rn(a2[off + j], X[off + j]);
    if (j == i && wd != nullptr) v = add_rn(v, wd[row]);
    out[off + j] = v;
  }
}

template <typename T>
int launch(const void* X, const void* a2, const void* wd, void* out, int B,
           int n, cudaStream_t stream) {
  const long rows = (long)B * n;
  if (rows > 0)
    adj_a_dense_kernel<T><<<(unsigned)rows, THREADS, 0, stream>>>(
        static_cast<const T*>(X), static_cast<const T*>(a2),
        static_cast<const T*>(wd), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

// X, a2, out [B, n, n], W_d [B, n] or NULL; all contiguous.  is_f64: 1 for
// float64, 0 for float32.  Returns cudaGetLastError().
extern "C" int lt_adj_a_dense(int is_f64, const void* X, const void* a2,
                              const void* wd, void* out, int B, int n,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(X, a2, wd, out, B, n, s)
                : launch<float>(X, a2, wd, out, B, n, s);
}
