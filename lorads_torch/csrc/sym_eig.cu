// K9 sym_eig_small: the eigenpairs of a batch of small symmetric matrices
// (n <= 64), ascending, with no host synchronisation, so that a CUDA graph
// can hold it inside a device-decided loop (alg/devloop.py).
//
// Replaces the batched jnp.linalg.eigh inside lorads_tpu's two remaining
// device loops: the restarted Lanczos's tridiagonal Ritz problems
// (lorads_tpu/alg/lanczos.py:117, T [B, k, k] at k = min(36, n), f32) and
// the spectral repair's projected slacks (lorads_tpu/alg/spectral_repair.py:
// 124, [b_eff, 48, 48], masked padding on the diagonal, at the solve's
// dtype).  torch.linalg.eigh checks its info on the host, so no graph can
// hold it; XLA's eigh needs no such check.
//
// One CTA a matrix runs the parallel cyclic Jacobi method in round-robin
// (Brent-Luk) order: n is padded to an even N with a zero row and column
// (never rotated: its coupling is 0, and its eigenvalue is left out), and
// each of the N - 1 rounds of a sweep rotates the N / 2 disjoint pairs of
// the circle method at once.  A and V live in shared memory (64 KB at
// f64, n = 64).  A round: one thread a pair computes its rotation
// (Numerical Recipes' t = sgn(theta) / (|theta| + hypot(1, theta))) from
// the pair's diagonal and coupling; then each thread updates whole 2 x 2
// blocks of A (the rows and columns of two pairs, the block and its mirror
// written from one computation, so A stays exactly symmetric) and pairs
// of columns of V; a pair's own coupling is set to 0 and its diagonal to
// a_pp - t a_pq, a_qq + t a_pq.  Every product and sum is an explicitly
// rounded intrinsic: no FMA contraction changes a rotation between
// builds.  Before each sweep the block sums the off-diagonal squares; the
// sweeps stop once off(A) <= eps ||A||_F (||A||_F is kept by the
// rotations) or after MAX_SWEEPS.  The eigenvalues are the diagonal,
// ranked in shared memory (ties by index, NaN last), and written ascending
// with their columns of V (torch.linalg.eigh's convention: column j of
// the eigenvector matrix belongs to eigenvalue j).  The lower triangle of
// the input is read, as torch.linalg.eigh reads it by default.
//
// What bounds it: the chain of sweeps x (N - 1) dependent rounds, each two
// block barriers apart (the rotations read what the last round wrote); the
// bytes (the matrix in, its eigenpairs out) take far less.

#include <cstdint>

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_N = 64;
constexpr int MAX_SWEEPS = 32;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ float hypot(float a, float b) { return hypotf(a, b); }
  static __device__ float abs(float a) { return fabsf(a); }
  static constexpr float eps = 1.1920928955078125e-07f;  // 2^-23
};

template <>
struct Rn<double> {
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ double hypot(double a, double b) { return ::hypot(a, b); }
  static __device__ double abs(double a) { return ::fabs(a); }
  static constexpr double eps = 2.220446049250313e-16;  // 2^-52
};

// the pair k of round r of the circle method over N (even) indices:
// index N - 1 stays, the others turn
__device__ __forceinline__ void pair_of(int r, int k, int N, int& p, int& q) {
  const int M = N - 1;
  if (k == 0) {
    p = M;
    q = r;
  } else {
    p = (r + k) % M;
    q = (r - k + M) % M;
  }
}

// (c x - s y, s x + c y), each operation rounded
template <typename T>
__device__ __forceinline__ void rotate(T c, T s, T& x, T& y) {
  using R = Rn<T>;
  const T nx = R::sub(R::mul(c, x), R::mul(s, y));
  const T ny = R::add(R::mul(s, x), R::mul(c, y));
  x = nx;
  y = ny;
}

// the block's sum of x, the same value in every thread (a fixed order)
template <typename T>
__device__ T block_sum(T x, T* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// smem: a [N*N] | v [N*N] | c, s, t [N/2] | red [THREADS/32] | then ints:
// pp, qq [N/2], inv [N]
template <typename T>
size_t smem_bytes(int N) {
  return (2 * (size_t)N * N + 3 * (N / 2) + THREADS / 32) * sizeof(T) +
         (2 * (N / 2) + N) * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    sym_eig_kernel(const T* __restrict__ A, T* __restrict__ evals,
                   T* __restrict__ evecs, int* __restrict__ sweeps_out,
                   int n, int N) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int half = N / 2;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* v = a + N * N;
  T* rc = v + N * N;
  T* rs = rc + half;
  T* rt = rs + half;
  T* red = rt + half;
  int* pp = reinterpret_cast<int*>(red + THREADS / 32);
  int* qq = pp + half;
  int* inv = qq + half;

  const T* Ab = A + (size_t)blockIdx.x * n * n;
  T fro = 0;
  for (int e = threadIdx.x; e < N * N; e += THREADS) {
    const int i = e / N, j = e - (e / N) * N;
    T x = 0;
    if (i < n && j < n) x = i >= j ? Ab[i * n + j] : Ab[j * n + i];
    a[e] = x;
    v[e] = i == j ? T(1) : T(0);
    fro += x * x;
  }
  fro = block_sum(fro, red);  // (its barrier publishes a and v)
  const T stop = R::mul(R::mul(R::eps, R::eps), fro);

  int sweep = 0;
  for (; sweep < MAX_SWEEPS; ++sweep) {
    T off = 0;
    for (int e = threadIdx.x; e < N * N; e += THREADS)
      if (e / N != e - (e / N) * N) off += a[e] * a[e];
    off = block_sum(off, red);
    if (!(off > stop)) break;  // converged (NaN runs to the cap)
    for (int r = 0; r < N - 1; ++r) {
      // the round's rotations, one thread a pair
      for (int k = threadIdx.x; k < half; k += THREADS) {
        int p, q;
        pair_of(r, k, N, p, q);
        const T apq = a[p * N + q];
        T c = 1, s = 0, t = 0;
        if (apq != T(0)) {
          const T theta = R::div(R::sub(a[q * N + q], a[p * N + p]),
                                 R::mul(T(2), apq));
          t = R::div(T(1), R::add(R::abs(theta), R::hypot(T(1), theta)));
          if (theta < T(0)) t = -t;
          c = R::div(T(1), R::sqrt(R::add(T(1), R::mul(t, t))));
          s = R::mul(t, c);
        }
        rc[k] = c;
        rs[k] = s;
        rt[k] = t;
        pp[k] = p;
        qq[k] = q;
      }
      __syncthreads();
      // A: the 2 x 2 blocks (pair k1, pair k2), k1 <= k2, and mirrors
      for (int e = threadIdx.x; e < half * half; e += THREADS) {
        const int k1 = e / half, k2 = e - (e / half) * half;
        if (k1 > k2) continue;
        const int p1 = pp[k1], q1 = qq[k1];
        if (k1 == k2) {
          const T apq = a[p1 * N + q1], t = rt[k1];
          a[p1 * N + p1] = R::sub(a[p1 * N + p1], R::mul(t, apq));
          a[q1 * N + q1] = R::add(a[q1 * N + q1], R::mul(t, apq));
          a[p1 * N + q1] = T(0);
          a[q1 * N + p1] = T(0);
          continue;
        }
        const int p2 = pp[k2], q2 = qq[k2];
        T m00 = a[p1 * N + p2], m01 = a[p1 * N + q2];
        T m10 = a[q1 * N + p2], m11 = a[q1 * N + q2];
        // rows p1, q1 by pair k1's rotation, then columns p2, q2 by k2's
        rotate(rc[k1], rs[k1], m00, m10);
        rotate(rc[k1], rs[k1], m01, m11);
        rotate(rc[k2], rs[k2], m00, m01);
        rotate(rc[k2], rs[k2], m10, m11);
        a[p1 * N + p2] = m00;
        a[p2 * N + p1] = m00;
        a[p1 * N + q2] = m01;
        a[q2 * N + p1] = m01;
        a[q1 * N + p2] = m10;
        a[p2 * N + q1] = m10;
        a[q1 * N + q2] = m11;
        a[q2 * N + q1] = m11;
      }
      // V: columns p, q of every row by the pair's rotation
      for (int e = threadIdx.x; e < N * half; e += THREADS) {
        const int i = e / half, k = e - (e / half) * half;
        T x = v[i * N + pp[k]], y = v[i * N + qq[k]];
        rotate(rc[k], rs[k], x, y);
        v[i * N + pp[k]] = x;
        v[i * N + qq[k]] = y;
      }
      __syncthreads();
    }
  }

  // ascending ranks of the diagonal (ties by index, NaN last)
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const T di = a[i * N + i];
    const bool ni = di != di;
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const T dj = a[j * N + j];
      const bool nj = dj != dj;
      const bool before = nj ? (ni && j < i)
                             : (ni || dj < di || (dj == di && j < i));
      rank += before;
    }
    inv[rank] = i;
  }
  __syncthreads();
  T* eb = evals + (size_t)blockIdx.x * n;
  T* vb = evecs + (size_t)blockIdx.x * n * n;
  for (int j = threadIdx.x; j < n; j += THREADS)
    eb[j] = a[inv[j] * N + inv[j]];
  for (int e = threadIdx.x; e < n * n; e += THREADS) {
    const int i = e / n, j = e - (e / n) * n;
    vb[e] = v[i * N + inv[j]];
  }
  if (sweeps_out != nullptr && threadIdx.x == 0)
    sweeps_out[blockIdx.x] = sweep;
}

template <typename T>
int launch(const void* A, void* evals, void* evecs, int* sweeps, int B,
           int n, cudaStream_t stream) {
  if (n < 1 || n > MAX_N || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int N = n + (n & 1);
  const size_t smem = smem_bytes<T>(N);
  static lt::SmemLimit limit;
  int err = limit.allow((const void*)sym_eig_kernel<T>, smem);
  if (err != 0) return err;
  sym_eig_kernel<T><<<(unsigned)B, THREADS, smem, stream>>>(
      static_cast<const T*>(A), static_cast<T*>(evals),
      static_cast<T*>(evecs), sweeps, n, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lt_sym_eig(int is_f64, const void* A, void* evals,
                          void* evecs, void* sweeps, int B, int n,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sw = static_cast<int*>(sweeps);
  return is_f64 ? launch<double>(A, evals, evecs, sw, B, n, st)
                : launch<float>(A, evals, evecs, sw, B, n, st);
}
