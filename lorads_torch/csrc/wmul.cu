// K5 wmul_csr: W @ X for a split bucket whose W changes every call.
//
// Replaces the split branches of lorads_tpu/ops/pattern.py: w_mul and
// w_mul_cached.  W = C + A^*(w) is symmetric with the diagonal W_d and
// the strictly-lower pattern values W_o (build_w).  The TPU version runs
// two sorted segment sums, a lower pass over the row-sorted off entries
// (a [Ko] gather of W_o through off_row_perm first) and an upper pass
// over a column-sorted mirror of the pattern whose W values build_w
// writes a second time, because unsorted TPU scatters run at random-
// access latency.  Here the pattern is stored once as a full-symmetric
// entry list (every lower entry and its mirror), each entry carrying the
// off slot it reads:
//
//   out[b, i, c] = W_d[b, i] * X[b, i, c]
//                + sum_{entries k of row i} W_o[b, slot[b, k]] * X[b, col[b, k], c]
//
// so one pass replaces both passes, the row-perm gather and the mirror
// write.  A slot of -1 (padding) reads 0.
//
// What bounds it: the traffic of X rows into the SMs.  The bytes the
// function must move are X, W_d, W_o, out and the entries (about 17 MB
// at matcomp2000: n = 4000, r = 17, Ks = 957686, f64), but a gather of
// one r-wide X row per entry moves 130 MB a call through L2 (the parent
// design: one warp per row walking its ~240 entries, 3.4 TB/s).
//
// The design, r > 1: the entries are scheduled once, at bucket build
// (kernels.wmul_tiles), by row strip of WMUL_STRIP = 32 rows and, within
// a strip, by column tile of WMUL_COLS = 256 rows of X: a tile of at
// least 64 entries is a staged unit, the rest of the strip one unit
// whose X rows are read from L2; a unit's entries come row by row, and
// rowptr says where each of its rows starts.  A strip's units go to P
// CTAs (P from the wrapper: enough CTAs for WMUL_WAVES a SM, at most
// 8); each CTA's threads own the strip's 32 r outputs (M = 1, 2 or 4
// each, in registers across its units; r > 64 runs in launches over
// column blocks of 64).  For a staged unit the CTA stages the tile's X
// rows into shared memory (cp.async, 16-byte copies of the contiguous
// span, tiles.cuh) while its threads load the unit's entries (W_o at the
// slot, the X row's offset: 4 a thread in flight) into shared memory,
// then each thread sums its outputs' terms from shared memory.  A unit
// read from L2 sums straight from the schedule.  Each output is written
// once, with no atomics, in a fixed order: P == 1 writes it directly,
// P > 1 leaves each part's sum in f64 scratch and a second kernel adds
// the parts in order.  At matcomp2000 the units stage ~34 MB of X a
// call instead of gathering 130 MB.  Where a tile of X would not fit
// beside the entries in WM_SMEM_MAX (about r > 40 at f64, r > 80 at
// f32), every unit reads X from L2.  A pattern with no staged tile runs
// wmul_rows_kernel (the parent design, below).
//
// r == 1 (the certificate's Lanczos SpMV): K4's schedule (segsum.cuh,
// as K2 at r = 1) over the row-sorted entry list, its values read
// through the slots (SlotVal), the diagonal term applied after the sum
// with _rn intrinsics.
//
// f32 sums are Neumaier-compensated (warp_acc.cuh), f64 sums direct.

#include <algorithm>

#include <cuda_runtime.h>

#include "segsum.cuh"
#include "tiles.cuh"

namespace {

using lt::Acc;
constexpr int WM_EPT = 4;  // a staged chunk: WM_EPT entries a thread
constexpr int WM_MAX_THREADS = 512;
constexpr size_t WM_SMEM_MAX = 100 * 1024;

// each thread's outputs of the strip: its m-th output sums the chunk's
// entries [a[m], z[m]) (its row's), X rows at xs + eoff in shared
// memory, 4 loads issued before their terms are added in order
template <typename T, int M>
__device__ __forceinline__ void wm_sum(Acc<T> (&acc)[M], const int (&oc)[M],
                                       const int (&a)[M], const int (&z)[M],
                                       const T* xs, const T* ew,
                                       const int* eoff) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const T* x = xs + oc[m];
    int q = a[m];
    for (; q + 3 < z[m]; q += 4) {
      const T x0 = x[eoff[q]], x1 = x[eoff[q + 1]];
      const T x2 = x[eoff[q + 2]], x3 = x[eoff[q + 3]];
      acc[m].add(ew[q] * x0);
      acc[m].add(ew[q + 1] * x1);
      acc[m].add(ew[q + 2] * x2);
      acc[m].add(ew[q + 3] * x3);
    }
    for (; q < z[m]; ++q) acc[m].add(ew[q] * x[eoff[q]]);
  }
}

// a unit whose X rows are read from L2: each thread walks its rows'
// entries [a[m], z[m]) straight from the schedule, 4 at a time (the
// (ij, slot) loads, then W_o and X, then the terms in order)
template <typename T, int M>
__device__ __forceinline__ void wm_sum_l2(Acc<T> (&acc)[M],
                                          const int (&oc)[M],
                                          const int (&a)[M],
                                          const int (&z)[M],
                                          const T* __restrict__ Xb,
                                          const T* __restrict__ Wb,
                                          const int* __restrict__ ij,
                                          const int* __restrict__ sl,
                                          int ld) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const T* x = Xb + oc[m];
    for (int k = a[m]; k < z[m]; k += 4) {
      int q[4], s[4];
      T wv[4], xv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const bool in = k + v < z[m];
        q[v] = in ? ij[k + v] : 0;
        s[v] = in ? sl[k + v] : -1;
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        wv[v] = s[v] >= 0 ? Wb[s[v]] : T(0);
        xv[v] = k + v < z[m] ? x[(long)(q[v] & lt::IJ_MASK) * ld] : T(0);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (k + v < z[m]) acc[m].add(wv[v] * xv[v]);
    }
  }
}

// one CTA per part p of a row strip s (blockIdx.x = (b * NS + s) * P +
// p): the part's share of the strip's units, in order.  A unit's
// entries come row by row; rowptr[b, u, i] is where local row i starts
// in unit u.  A staged unit: the X tile by cp.async and its entries
// (W_o at the slot, the X row's offset) into shared memory, WM_EPT a
// thread at a time, then the sums from shared memory; a unit read from
// L2: the sums straight from the schedule (no shared memory, no
// barrier).  P == 1: the CTA writes out = W_d X + its sum; else its
// sum into part[p] (f64), which wmul_combine_kernel adds in order of p
// (a cluster of the strip's P CTAs adding them through distributed
// shared memory was slower at matcomp2000 on an H100, PERF.md).
// (WM_MAX_THREADS, 1): the bound alone held ptxas to 32-64 registers
// and spilled the M = 2 and 4 instances; M = 8 spilled even so
template <typename T, int M>
__global__ void __launch_bounds__(WM_MAX_THREADS, 1)
    wmul_tiled_kernel(const T* __restrict__ X, const T* __restrict__ W_d,
                      const T* __restrict__ W_o,
                      const int* __restrict__ tslot,
                      const int* __restrict__ tij,
                      const int* __restrict__ tbnd,
                      const int* __restrict__ tcol0,
                      const int* __restrict__ tstrip,
                      const int* __restrict__ trowptr, T* __restrict__ out,
                      double* __restrict__ part, int B, int n, int Ko,
                      int Ks, int U, int w, int ld, int TR, int TC, int P,
                      int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rp = w;  // lanes read along a row: no padding
  const int CH = WM_EPT * blockDim.x;
  T* Xs = reinterpret_cast<T*>(smem);
  T* ew = Xs + (stage ? TC * rp : 0);
  int* eoff = reinterpret_cast<int*>(ew + CH);
  const int NS = (n + TR - 1) / TR;
  const int strip = blockIdx.x / P, p = blockIdx.x - strip * P;
  const int b = strip / NS;
  const int i0 = (strip - b * NS) * TR;
  const int nrow = min(TR, n - i0);
  const T* Xb = X + (long)b * n * ld;
  const T* Wb = W_o + (long)b * Ko;
  const int* sl = tslot + (long)b * Ks;
  const int* ij = tij + (long)b * Ks;
  const int* bb = tbnd + (long)b * (U + 1);
  // the strip's units, and this part's: the p-th of P near-equal runs
  const int* sb = tstrip + (long)b * (NS + 1) + (strip - b * NS);
  const int sa = sb[0], sz = sb[1];
  const int ua = sa + (int)((long)(sz - sa) * p / P);
  const int ub = sa + (int)((long)(sz - sa) * (p + 1) / P);
  int oi[M], oc[M];
  Acc<T> acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int o = threadIdx.x + m * blockDim.x;
    oi[m] = min(o / w, nrow);  // nrow: this slot owns no output
    oc[m] = o - (o / w) * w;
  }
  for (int u = ua; u < ub; ++u) {
    const int lo = bb[u], hi = bb[u + 1];
    const int j0 = tcol0[(long)b * U + u];
    const int* rpu = trowptr + ((long)b * U + u) * (TR + 1);
    int a0[M], z0[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      a0[m] = oi[m] < nrow ? lo + rpu[oi[m]] : lo;
      z0[m] = oi[m] < nrow ? lo + rpu[oi[m] + 1] : lo;
    }
    if (!stage || j0 < 0) {  // uniform across the CTA
      wm_sum_l2<T, M>(acc, oc, a0, z0, Xb, Wb, ij, sl, ld);
      continue;
    }
    __syncthreads();  // the last unit's reads of Xs are done
    lt::stage_rows(Xs, Xb + (long)j0 * ld, min(TC, n - j0), w, ld, rp);
    for (int clo = lo; clo < hi; clo += CH) {
      const int chi = min(hi, clo + CH);
      if (clo > lo) __syncthreads();  // the last chunk's reads are done
#pragma unroll
      for (int v0 = 0; v0 < WM_EPT; v0 += 4) {  // 4 entries in flight
        int q[4], s[4];
        T wv[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = clo + threadIdx.x + (v0 + v) * blockDim.x;
          q[v] = k < chi ? ij[k] : 0;
          s[v] = k < chi ? sl[k] : -1;
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) wv[v] = s[v] >= 0 ? Wb[s[v]] : T(0);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = threadIdx.x + (v0 + v) * blockDim.x;
          if (clo + k < chi) {
            ew[k] = wv[v];
            eoff[k] = ((q[v] & lt::IJ_MASK) - j0) * rp;
          }
        }
      }
      lt::stage_wait();
      __syncthreads();
      int a[M], z[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        a[m] = min(max(a0[m], clo), chi) - clo;
        z[m] = min(max(z0[m], clo), chi) - clo;
      }
      wm_sum<T, M>(acc, oc, a, z, Xs, ew, eoff);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (oi[m] >= nrow) continue;
    const long i = (long)b * n + i0 + oi[m];
    if (P == 1)
      out[i * ld + oc[m]] = W_d[i] * X[i * ld + oc[m]] + acc[m].value();
    else
      part[((long)p * B * n + i) * ld + oc[m]] = lt::wide(acc[m]);
  }
}

// out = W_d X + sum_p part[p], the parts added in order of p in f64
template <typename T>
__global__ void wmul_combine_kernel(const T* __restrict__ X,
                                    const T* __restrict__ W_d,
                                    const double* __restrict__ part,
                                    T* __restrict__ out, long total, int r,
                                    int P) {
  const long e = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  double v = (double)(W_d[e / r] * X[e]);
  for (int p = 0; p < P; ++p) v += part[p * total + e];
  out[e] = (T)v;
}

// The parent design, a warp a row, lanes over r, for a pattern with no
// staged tile at r > 1 (every tile sparse): each lane walks the row's
// entries, X rows from L2; its many small warps keep more rows in
// flight than the tiled kernel's L2 path (PERF.md: maxcut20000's
// pattern).
template <typename T>
__global__ void wmul_rows_kernel(const T* __restrict__ X,
                                 const T* __restrict__ W_d,
                                 const T* __restrict__ W_o,
                                 const int* __restrict__ slots,
                                 const int* __restrict__ cols,
                                 const int* __restrict__ bnd,
                                 T* __restrict__ out, int B, int n, int Ko,
                                 int Ks, int r) {
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
  for (int c = lane; c < r; c += 32) {
    Acc<T> acc;
    for (int k = lo; k < hi; ++k) {
      const int q = sb[k];
      acc.add((q >= 0 ? Wb[q] : T(0)) * Xb[(long)cb[k] * r + c]);
    }
    ob[(long)i * r + c] = wd * Xb[(long)i * r + c] + acc.value();
  }
}

// columns [0, w) of X and out (row stride ld) at M outputs a thread
template <typename T, int M>
int launch_tiled_m(const T* X, const T* W_d, const T* W_o,
                   const int* const* t, T* out, double* part, int B, int n,
                   int Ko, int Ks, int w, int ld, int U, int TR, int TC,
                   int P, cudaStream_t stream) {
  const int rp = w;
  const int outs = TR * w;
  const int threads = std::max(128, ((outs + M - 1) / M + 31) / 32 * 32);
  // an X tile (when staged) and a chunk's entries
  const size_t entries = (size_t)WM_EPT * threads * (sizeof(T) + 4);
  const size_t staged = (size_t)TC * rp * sizeof(T) + entries;
  const int stage = staged <= WM_SMEM_MAX;
  const size_t smem = stage ? staged : entries;
  static lt::SmemLimit limit;
  int err = limit.allow((const void*)wmul_tiled_kernel<T, M>, smem);
  if (err != 0) return err;
  const long NS = (n + TR - 1) / TR;
  wmul_tiled_kernel<T, M><<<(unsigned)(B * NS * P), threads, smem, stream>>>(
      X, W_d, W_o, t[0], t[1], t[2], t[3], t[4], t[5], out, part, B, n, Ko,
      Ks, U, w, ld, TR, TC, P, stage);
  return (int)cudaGetLastError();
}

// r > 1: M, the outputs a thread owns, is the least power of two that
// keeps the threads at WM_MAX_THREADS, at most 4 (8 spills); wider
// rows run in launches over column blocks of at most 4 WM_MAX_THREADS
// / TR columns (64 at TR = 32); P > 1 parts a strip, then one combine
template <typename T>
int launch_tiled(const T* X, const T* W_d, const T* W_o, const int* const* t,
                 T* out, double* part, int B, int n, int Ko, int Ks, int r,
                 int U, int TR, int TC, int P, cudaStream_t stream) {
  const int cw = std::max(1, 4 * WM_MAX_THREADS / TR);
  for (int c0 = 0; c0 < r; c0 += cw) {
    const int w = std::min(cw, r - c0), outs = TR * w;
    double* pc = part != nullptr ? part + c0 : nullptr;
    int err = (int)cudaErrorInvalidValue;
#define LT_WM(MM)                                                            \
  if (outs <= MM * WM_MAX_THREADS)                                           \
    err = launch_tiled_m<T, MM>(X + c0, W_d, W_o, t, out + c0, pc, B, n, Ko, \
                                Ks, w, r, U, TR, TC, P, stream);             \
  else
    LT_WM(1) LT_WM(2) LT_WM(4) {}
#undef LT_WM
    if (err != 0) return err;
  }
  if (P > 1) {
    const long total = (long)B * n * r;
    wmul_combine_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0,
                             stream>>>(X, W_d, part, out, total, r, P);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* X, const void* W_d, const void* W_o,
           const void* slots, const void* cols, const void* bnd, void* out,
           int B, int n, int Ko, int Ks, int r, cudaStream_t stream) {
  const T* x = static_cast<const T*>(X);
  const T* wd = static_cast<const T*>(W_d);
  const T* wo = static_cast<const T*>(W_o);
  const int* sl = static_cast<const int*>(slots);
  const int* cl = static_cast<const int*>(cols);
  const int* bd = static_cast<const int*>(bnd);
  T* o = static_cast<T*>(out);
  if ((long)B * n <= 0 || r <= 0) return (int)cudaGetLastError();
  if (r > 1) {
    const long blocks = ((long)B * n * 32 + 255) / 256;
    wmul_rows_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
        x, wd, wo, sl, cl, bd, o, B, n, Ko, Ks, r);
  } else {
    lt::launch_segsum(x, cl, lt::SlotVal<T>{wo, sl, Ko}, bd, B, n, Ks, n,
                      lt::StoreDiag<T>{x, wd, o}, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// X [B, n, r], W_d [B, n], W_o [B, Ko], slots and cols int32 [B, Ks]
// sorted by row, bnd int32 [B, n+1] row pointers, out [B, n, r]; all
// contiguous.  r == 1: K4's schedule; r > 1: a warp a row (a pattern
// with no staged tile; else lt_wmul_tiled).  is_f64: 1 for float64, 0
// for float32.  Returns cudaGetLastError().
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

// r > 1 over the schedule (kernels.Tiles: slot, ij int32 [B, Ks], bnd
// [B, U+1], col0 [B, U], strip [B, ceil(n / TR) + 1], rowptr
// [B, U (TR + 1)]; strips of TR rows over column tiles of TC, U > 0);
// X, W_d, W_o and out as lt_wmul's; P parts a strip, part float64
// [P, B, n, r] scratch when P > 1 (else NULL); all contiguous.
extern "C" int lt_wmul_tiled(int is_f64, const void* X, const void* W_d,
                             const void* W_o, const void* t_slot,
                             const void* t_ij, const void* t_bnd,
                             const void* t_col0, const void* t_strip,
                             const void* t_rowptr, void* out, void* part,
                             int B, int n, int Ko, int Ks, int r, int U,
                             int TR, int TC, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t[6] = {static_cast<const int*>(t_slot),
                     static_cast<const int*>(t_ij),
                     static_cast<const int*>(t_bnd),
                     static_cast<const int*>(t_col0),
                     static_cast<const int*>(t_strip),
                     static_cast<const int*>(t_rowptr)};
  if ((long)B * n <= 0) return (int)cudaGetLastError();
  if (r <= 1 || U <= 0) return (int)cudaErrorInvalidValue;
  double* pd = static_cast<double*>(part);
  if (is_f64)
    return launch_tiled<double>(
        static_cast<const double*>(X), static_cast<const double*>(W_d),
        static_cast<const double*>(W_o), t, static_cast<double*>(out), pd, B,
        n, Ko, Ks, r, U, TR, TC, P, s);
  return launch_tiled<float>(
      static_cast<const float*>(X), static_cast<const float*>(W_d),
      static_cast<const float*>(W_o), t, static_cast<float*>(out), pd, B, n,
      Ko, Ks, r, U, TR, TC, P, s);
}
