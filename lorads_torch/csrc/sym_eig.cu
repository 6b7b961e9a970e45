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
// (Brent-Luk) order.  What bounds it is the chain of sweeps x rounds, each
// round's rotations depending on what the round before wrote; the bytes
// (the matrix in, its eigenpairs out) take far less.  So the design cuts
// the rounds and takes the rotations off the updates' path:
//
// * Deflation.  An index whose off-diagonal row is exactly zero in the
//   input (the repair's masked padding, Lanczos breakdown slots) is
//   already an eigenpair (a_ii, e_i), and no rotation of other indices
//   gives it coupling.  The block finds the coupled indices while it
//   loads the matrix and runs the round robin over them alone, in compact
//   coordinates (padded to an even count M with one zero position): M - 1
//   rounds a sweep on an M x M block.  Decoupled indices keep their
//   diagonal and e_i and are ranked with the others.
// * One barrier a round, the rotations a round ahead.  A is
//   double-buffered in shared memory: a round reads A_cur and writes every
//   element of A_next once (the round's pairs cover every position).  Warp
//   0 computes the rotations, lane k pair k (M / 2 <= 32), one round
//   ahead: while warps 1-19 apply round r's rotations, it forms the three
//   entries each pair of round r + 1 rotates on (its diagonal from round
//   r's new diagonals, its coupling from round r's 2 x 2 block with the
//   same rounded operations the updating thread uses, so the same bits)
//   from A_cur and round r's rotations (its neighbours' by shuffles), and
//   writes round r + 1's rotations to the other half of a two-round table.
//   After a sweep's last round it so forms the next sweep's first, used if
//   the sweeps go on (round M - 1 of the circle is round 0).
// * The updates: each thread of warps 1-19 takes at most one of the
//   h (h + 1) / 2 <= 528 blocks (pair k1's rows, pair k2's columns, k1 <=
//   k2), rotates the rows by k1's rotation and the columns by k2's, writes
//   the block with its mirror (A stays exactly symmetric; a pair's own
//   block is its new diagonal a_pp - t a_pq, a_qq + t a_pq and zeros).  V
//   is kept transposed (row j: column j of V) in rows of 16-byte chunks;
//   lane k rotates pair k's two rows a chunk at a time, in place (each
//   chunk belongs to one lane a round).
// * No index arithmetic in a round: every position a thread uses moves one
//   step around the circle each round (pair 0 = (M - 1, r), pair k = (r +
//   k, r - k) mod M - 1), a compare and a select.
// * A's rows padded to a stride of M + 1 (odd), so that a column walk hits
//   32 banks at f32 and 16 bank pairs at f64; V's rows to an odd count of
//   16-byte chunks, so that 8 lanes' chunks fall in 8 bank groups.
// * The rotation in one division: d = a_qq - a_pp, t = sgn(d) 2 a_pq /
//   (|d| + hypot(d, 2 a_pq)) (Numerical Recipes' tan of the angle), c =
//   rsqrt(1 + t^2), s = t c.
//
// Every product and sum is an explicitly rounded intrinsic: no FMA
// contraction changes a rotation between builds.  Before each sweep the
// block sums the off-diagonal squares; the sweeps stop once off(A) <=
// eps^2 ||A||_F^2 (||A||_F is kept by the rotations) or after MAX_SWEEPS.
// The eigenvalues are ranked (ties by index, NaN last) and written
// ascending with their vectors (torch.linalg.eigh's convention: column j
// of the eigenvector matrix belongs to eigenvalue j).  The lower triangle
// of the input is read, as torch.linalg.eigh reads it by default.
//
// What bounds it now: warp 0's chain a round (the four loads, two
// rotations of a 2 x 2 block, the rotation's division, hypot and rsqrt,
// the table store and the barrier) at f32; at f64 and n = 48 the updates'
// shared-memory traffic (PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

// warp 0 computes the rotations, warps 1 .. WARPS - 1 update A and V
constexpr int WARPS = 20;
constexpr int THREADS = 32 * WARPS;
constexpr int UPDATERS = 32 * (WARPS - 1);
constexpr int MAX_N = 64;
constexpr int MAX_SWEEPS = 32;
// the 2 x 2 blocks (k1 <= k2) of at most 32 pairs, per updating thread
// (one at 20 warps)
constexpr int BLOCKS = (32 * 33 / 2 + UPDATERS - 1) / UPDATERS;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ float rsqrt(float a) { return __frsqrt_rn(a); }
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
  static __device__ double rsqrt(double a) { return ::rsqrt(a); }
  static __device__ double hypot(double a, double b) { return ::hypot(a, b); }
  static __device__ double abs(double a) { return ::fabs(a); }
  static constexpr double eps = 2.220446049250313e-16;  // 2^-52
};

// a pair's rotation: cosine, sine and the pair's new diagonal
template <typename T>
struct Rot {
  T c, s, dp, dq;
};

// two values of a pair, loaded as one
template <typename T>
struct alignas(2 * sizeof(T)) Two {
  T a, b;
};

// the rotation that zeroes a_pq: d = a_qq - a_pp, t = sgn(d) 2 a_pq /
// (|d| + hypot(d, 2 a_pq)) (Numerical Recipes' tangent), c = rsqrt(1 +
// t^2), s = t c; the diagonal becomes a_pp - t a_pq, a_qq + t a_pq
template <typename T>
__device__ __forceinline__ Rot<T> rotation(T app, T aqq, T apq) {
  using R = Rn<T>;
  Rot<T> o{T(1), T(0), app, aqq};
  if (apq != T(0)) {
    const T d = R::sub(aqq, app);
    const T two = R::add(apq, apq);
    T t = R::div(two, R::add(R::abs(d), R::hypot(d, two)));
    if (d < T(0)) t = -t;
    o.c = R::rsqrt(R::add(T(1), R::mul(t, t)));
    o.s = R::mul(t, o.c);
    const T tp = R::mul(t, apq);
    o.dp = R::sub(app, tp);
    o.dq = R::add(aqq, tp);
  }
  return o;
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

// 16 bytes of V: rotated element by element, as rotate does
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};
__device__ __forceinline__ void rotate(float c, float s, float4& x,
                                       float4& y) {
  rotate(c, s, x.x, y.x);
  rotate(c, s, x.y, y.y);
  rotate(c, s, x.z, y.z);
  rotate(c, s, x.w, y.w);
}
__device__ __forceinline__ void rotate(double c, double s, double2& x,
                                       double2& y) {
  rotate(c, s, x.x, y.x);
  rotate(c, s, x.y, y.y);
}

// a position one step further around the circle of positions 0 .. M - 2
// (position M - 1 stays): round r's pair k is (r + k, r - k) mod M - 1,
// and (M - 1, r) for k = 0, so every round moves both members of pair k
// one step (pair 0's first stays), and round M - 1 is round 0 again
__device__ __forceinline__ int step(int x, int M) {
  return x == M - 1 ? x : x + 1 == M - 1 ? 0 : x + 1;
}
__device__ __forceinline__ int first_p(int k, int M) {
  return k == 0 ? M - 1 : k;
}
__device__ __forceinline__ int first_q(int k, int M) {
  return k == 0 ? 0 : M - 1 - k;
}

// the block's sum of x, the same value in every thread (the same order
// of additions in every warp); red is read after the barrier, so two
// calls need a barrier between them
template <typename T>
__device__ T block_sum(T x, T* red) {
  using R = Rn<T>;
  for (int o = 16; o > 0; o >>= 1)
    x = R::add(x, __shfl_down_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  T s = (threadIdx.x & 31) < WARPS ? red[threadIdx.x & 31] : T(0);
  for (int o = 16; o > 0; o >>= 1)
    s = R::add(s, __shfl_down_sync(0xffffffffu, s, o));
  return __shfl_sync(0xffffffffu, s, 0);
}

// smem (N = n rounded up to even): the rotations' (c, s) and (dp, dq)
// [2][32] each | a0, a1 [N * (N + 1)] | vt [N * (N + 8)] | diag [N] | red
// [WARPS] | then ints: act [N] (position -> index), pos [N] (index ->
// position or -1), col [N] (column j of the output: V's row, or -1 -
// index for a decoupled index), count [1], mask [2]
template <typename T>
size_t smem_bytes(int N) {
  return 128 * sizeof(Two<T>) +
         (2 * (size_t)N * (N + 1) + (size_t)N * (N + 8) + N + WARPS) *
             sizeof(T) +
         (3 * (size_t)N + 3) * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    sym_eig_kernel(const T* __restrict__ A, T* __restrict__ evals,
                   T* __restrict__ evecs, int* __restrict__ sweeps_out,
                   int n, int N) {
  using R = Rn<T>;
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const int SN = N + 1;
  Two<T>* tcs = reinterpret_cast<Two<T>*>(smem_raw);  // (c, s)
  Two<T>* tdg = tcs + 64;                              // (dp, dq)
  T* a0 = reinterpret_cast<T*>(tdg + 64);
  T* a1 = a0 + N * SN;
  T* vt = a1 + N * SN;
  T* diag = vt + N * (N + 8);
  T* red = diag + N;
  int* act = reinterpret_cast<int*>(red + WARPS);
  int* pos = act + N;
  int* col = pos + N;
  int* count = col + N;
  unsigned* mask = reinterpret_cast<unsigned*>(count + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the lower triangle into a1 at full coordinates with its mirror, the
  // coupled indices (a nonzero off-diagonal entry) into mask; ||A||_F^2
  if (threadIdx.x < 2) mask[threadIdx.x] = 0u;
  __syncthreads();
  const T* Ab = A + (size_t)blockIdx.x * n * n;
  T fro = 0;
  unsigned bits0 = 0u, bits1 = 0u;
  for (int e = threadIdx.x; e < n * n; e += THREADS) {
    const int i = e / n, j = e - i * n;
    if (j > i) continue;
    const T x = Ab[e];
    a1[i * SN + j] = x;
    a1[j * SN + i] = x;
    const T xx = R::mul(x, x);
    fro = R::add(fro, j < i ? R::add(xx, xx) : xx);
    if (j < i && x != T(0)) {
      const unsigned long long ij = (1ull << i) | (1ull << j);
      bits0 |= (unsigned)ij;
      bits1 |= (unsigned)(ij >> 32);
    }
  }
  if (bits0 != 0u) atomicOr(mask, bits0);
  if (bits1 != 0u) atomicOr(mask + 1, bits1);
  fro = block_sum(fro, red);  // (its barrier publishes a1 and mask)
  const T stop = R::mul(R::mul(R::eps, R::eps), fro);

  // the coupled indices in index order: act[0, m) and pos; one zero
  // position pads m to even M
  if (warp == 0) {
    const bool c0 = (mask[0] >> lane) & 1u, c1 = (mask[1] >> lane) & 1u;
    const unsigned below = (1u << lane) - 1u;
    const int k0 = __popc(mask[0] & below);
    const int k1 = __popc(mask[0]) + __popc(mask[1] & below);
    if (lane < n) pos[lane] = c0 ? k0 : -1;
    if (lane + 32 < n) pos[lane + 32] = c1 ? k1 : -1;
    if (c0) act[k0] = lane;
    if (c1) act[k1] = lane + 32;
    if (lane == 0) *count = __popc(mask[0]) + __popc(mask[1]);
  }
  for (int i = threadIdx.x; i < n; i += THREADS) diag[i] = a1[i * SN + i];
  __syncthreads();
  const int m = *count;
  const int M = m + (m & 1);
  const int S = M + 1;  // the compact block's row stride (odd)
  const int h = M / 2;
  // V transposed (row j: column j of V), rows of SV elements in chunks of
  // 16 bytes, SV * sizeof(T) / 16 odd (8 lanes' chunks in 8 bank groups)
  constexpr int VEC = Vec<T>::n;
  const int nch = (M + VEC - 1) / VEC;
  const int SV = (nch | 1) * VEC;

  // the compact M x M block into a0 (the padding position's row and
  // column zero) and V = I
  for (int i = warp; i < M; i += WARPS) {
    const int ai = i < m ? act[i] : -1;
    for (int j = lane; j < M; j += 32) {
      const int aj = j < m ? act[j] : -1;
      a0[i * S + j] = ai >= 0 && aj >= 0 ? a1[ai * SN + aj] : T(0);
    }
  }
  for (int j = warp; j < M; j += WARPS)
    for (int i = lane; i < SV; i += 32) vt[j * SV + i] = i == j ? T(1) : T(0);

  // an updating thread: its blocks (k1, k2), k1 <= k2 (k1 = -1: none)
  // and their positions; the positions of pair k = lane (V's two rows)
  int bk1[BLOCKS], bk2[BLOCKS], bp1[BLOCKS], bq1[BLOCKS], bp2[BLOCKS],
      bq2[BLOCKS];
#pragma unroll
  for (int b = 0; b < BLOCKS; ++b) {
    int e = threadIdx.x - 32 + b * UPDATERS, k1 = 0;
    const bool on = warp > 0 && e < h * (h + 1) / 2;
    if (on)
      while (e >= h - k1) e -= h - k1++;
    bk1[b] = on ? k1 : -1;
    bk2[b] = on ? k1 + e : 0;
    bp1[b] = first_p(on ? k1 : 0, M);
    bq1[b] = first_q(on ? k1 : 0, M);
    bp2[b] = first_p(bk2[b], M);
    bq2[b] = first_q(bk2[b], M);
  }
  int vp = first_p(lane < h ? lane : 0, M);
  int vq = first_q(lane < h ? lane : 0, M);

  // warp 0, lane k < h: pair k of the next round joins a member of this
  // round's pair lo (its second member if qlo) and one of pair hi (its
  // second if qhi), lo < hi: pair 0 the first members of pairs 0 and 1,
  // pair k the second of k - 1 and the first of k + 1, the last pair the
  // second members of h - 2 and h - 1.  Its coupling is the element (lo's
  // member, hi's member) of this round's block (lo, hi), formed as that
  // block's updating thread forms it (rows by lo's rotation, then columns
  // by hi's: the same operations, the same bits)
  const bool last = lane == h - 1 && lane > 0;
  const int lo = lane == 0 ? 0 : lane - 1;
  const int hi = lane == 0 ? 1 : last ? lane : lane + 1;
  const bool qlo = lane != 0, qhi = last;
  int lp = first_p(lo, M), lq = first_q(lo, M);
  int hp = first_p(hi, M), hq = first_q(hi, M);
  __syncthreads();

  // round 0's rotations, from the diagonal and the couplings; warp 0
  // keeps its neighbours' (lane + 1: cu, su, du; lane - 1: cd, sd, dd)
  Rot<T> rot{T(1), T(0), T(0), T(0)};
  T cu, su, du, cd, sd, dd;
  if (warp == 0) {
    if (lane < h) {
      const int p = first_p(lane, M), q = first_q(lane, M);
      rot = rotation(a0[p * S + p], a0[q * S + q], a0[p * S + q]);
      tcs[lane] = Two<T>{rot.c, rot.s};
      tdg[lane] = Two<T>{rot.dp, rot.dq};
    }
    cu = __shfl_down_sync(0xffffffffu, rot.c, 1);
    su = __shfl_down_sync(0xffffffffu, rot.s, 1);
    du = __shfl_down_sync(0xffffffffu, rot.dp, 1);
    cd = __shfl_up_sync(0xffffffffu, rot.c, 1);
    sd = __shfl_up_sync(0xffffffffu, rot.s, 1);
    dd = __shfl_up_sync(0xffffffffu, rot.dq, 1);
  }

  T* cur = a0;
  T* nxt = a1;
  int sweep = 0;
  for (int g = 0; sweep < MAX_SWEEPS; ++sweep) {
    T off = 0;
    for (int i = warp; i < M; i += WARPS)
      for (int j = lane; j < M; j += 32)
        if (j != i) off = R::add(off, R::mul(cur[i * S + j], cur[i * S + j]));
    off = block_sum(off, red);  // (its barrier publishes the rotations)
    if (!(off > stop)) break;  // converged (NaN runs to the cap)
    for (int r = 0; r < M - 1; ++r, ++g) {
      if (warp == 0) {
        // the next round's rotations (after a sweep's last round: the
        // next sweep's first, used if the sweeps go on)
        if (lane < h) {
          T b00 = cur[lp * S + hp], b01 = cur[lp * S + hq];
          T b10 = cur[lq * S + hp], b11 = cur[lq * S + hq];
          lp = step(lp, M);
          lq = step(lq, M);
          hp = step(hp, M);
          hq = step(hq, M);
          const T clo = lane == 0 ? rot.c : cd, slo = lane == 0 ? rot.s : sd;
          const T chi = last ? rot.c : cu, shi = last ? rot.s : su;
          rotate(clo, slo, b00, b10);
          rotate(clo, slo, b01, b11);
          T x = qlo ? b10 : b00, y = qlo ? b11 : b01;
          rotate(chi, shi, x, y);
          // the new diagonal: the first member's, then the second's (one
          // pair: its own, and its block stays diagonal)
          const T app = lane == 0 ? rot.dp : last ? rot.dq : du;
          const T aqq = h == 1 ? rot.dq : lane == 0 ? du : dd;
          rot = rotation(app, aqq, h == 1 ? T(0) : qhi ? y : x);
          const int at = ((g + 1) & 1) * 32 + lane;
          tcs[at] = Two<T>{rot.c, rot.s};
          tdg[at] = Two<T>{rot.dp, rot.dq};
        }
        cu = __shfl_down_sync(0xffffffffu, rot.c, 1);
        su = __shfl_down_sync(0xffffffffu, rot.s, 1);
        du = __shfl_down_sync(0xffffffffu, rot.dp, 1);
        cd = __shfl_up_sync(0xffffffffu, rot.c, 1);
        sd = __shfl_up_sync(0xffffffffu, rot.s, 1);
        dd = __shfl_up_sync(0xffffffffu, rot.dq, 1);
      } else {
        // A's blocks (pair k1's rows by its rotation, then pair k2's
        // columns by its), each written with its mirror (a pair's own
        // block: its new diagonal and zeros); V's rows of pair lane, this
        // warp's chunks
        const Two<T>* cs = tcs + (g & 1) * 32;
        const Two<T>* dg = tdg + (g & 1) * 32;
#pragma unroll
        for (int b = 0; b < BLOCKS; ++b) {
          if (bk1[b] < 0) continue;
          const int k1 = bk1[b], k2 = bk2[b];
          const int p1 = bp1[b], q1 = bq1[b], p2 = bp2[b], q2 = bq2[b];
          const Two<T> r1 = cs[k1], r2 = cs[k2];
          T m00 = cur[p1 * S + p2], m01 = cur[p1 * S + q2];
          T m10 = cur[q1 * S + p2], m11 = cur[q1 * S + q2];
          rotate(r1.a, r1.b, m00, m10);
          rotate(r1.a, r1.b, m01, m11);
          rotate(r2.a, r2.b, m00, m01);
          rotate(r2.a, r2.b, m10, m11);
          if (k1 == k2) {
            const Two<T> d = dg[k1];
            m00 = d.a;
            m01 = T(0);
            m10 = T(0);
            m11 = d.b;
          }
          nxt[p1 * S + p2] = m00;
          nxt[p2 * S + p1] = m00;
          nxt[p1 * S + q2] = m01;
          nxt[q2 * S + p1] = m01;
          nxt[q1 * S + p2] = m10;
          nxt[p2 * S + q1] = m10;
          nxt[q1 * S + q2] = m11;
          nxt[q2 * S + q1] = m11;
        }
        if (lane < h) {
          const Two<T> r = cs[lane];
          using V = typename Vec<T>::type;
          V* xs = reinterpret_cast<V*>(vt + vp * SV);
          V* ys = reinterpret_cast<V*>(vt + vq * SV);
          for (int k = WARPS - 1 - warp; k < nch; k += WARPS - 1) {
            V x = xs[k], y = ys[k];
            rotate(r.a, r.b, x, y);
            xs[k] = x;
            ys[k] = y;
          }
        }
        // the positions of the next round
#pragma unroll
        for (int b = 0; b < BLOCKS; ++b) {
          bp1[b] = step(bp1[b], M);
          bq1[b] = step(bq1[b], M);
          bp2[b] = step(bp2[b], M);
          bq2[b] = step(bq2[b], M);
        }
        vp = step(vp, M);
        vq = step(vq, M);
      }
      __syncthreads();
      T* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }

  // the eigenvalues: the block's diagonal at coupled indices, the input's
  // elsewhere; ascending ranks (ties by index, NaN last), a warp an index
  for (int i = threadIdx.x; i < n; i += THREADS)
    if (pos[i] >= 0) diag[i] = cur[pos[i] * S + pos[i]];
  __syncthreads();
  T* eb = evals + (size_t)blockIdx.x * n;
  for (int i = warp; i < n; i += WARPS) {
    const T di = diag[i];
    const bool ni = di != di;
    int rank = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      bool before = false;
      if (j < n) {
        const T dj = diag[j];
        const bool nj = dj != dj;
        before = nj ? (ni && j < i) : (ni || dj < di || (dj == di && j < i));
      }
      rank += __popc(__ballot_sync(0xffffffffu, before));
    }
    if (lane == 0) {
      eb[rank] = di;
      col[rank] = pos[i] >= 0 ? pos[i] : -1 - i;
    }
  }
  __syncthreads();
  // column j: V's column at the index's position over the coupled rows,
  // or e_index for a decoupled index
  T* vb = evecs + (size_t)blockIdx.x * n * n;
  const int c0 = lane < n ? col[lane] : 0;
  const int c1 = lane + 32 < n ? col[lane + 32] : 0;
  for (int i = warp; i < n; i += WARPS) {
    const int pi = pos[i];
    for (int j = lane, cj = c0; j < n; j += 32, cj = c1)
      vb[i * n + j] = cj >= 0 ? (pi >= 0 ? vt[cj * SV + pi] : T(0))
                              : (i == -1 - cj ? T(1) : T(0));
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
