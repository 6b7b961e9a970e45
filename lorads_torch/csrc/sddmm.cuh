// The pattern SDDMMs K3 (uvt.cu), K3p (uvt_pair.cu) and K6 (adj_a.cu):
// per off slot k of a split pattern, a few r-term dots of factor rows
// at the slot's row i and column j, then an epilogue at the slot.
//
// A policy P says which dots and which epilogue:
//
//   using T = float or double;  using A = an accumulator (warp_acc.cuh);
//   static constexpr int NF;    // factor arrays [B, n, r] (1 or 2)
//   static constexpr int ND;    // dots an entry
//   const T* f[NF];             // the factors
//   dots(A (&s)[ND], I, J, c)   // adds term c of every dot, I[f] and
//                               // J[f] the rows of factor f at i and j
//   store(const A (&s)[ND], k)  // the epilogue at element k = b Ko + slot
//   store_diag(s, k)            // the diagonal's at row k = b n + i (its
//                               // dots at j = i)
//
// K6 is "two dots, a2 times their mean", K3 "their mean" (or, when U is
// V, one dot: <R_i, R_j>), K3p "three dots, two stores".
//
// The schedule (kernels.Tiles of the off slots, kernels.adj_tiles):
// square tiles of TR x TC rows and columns; a tile of at least 16
// entries is a staged unit (sddmm_staged_kernel, one CTA a unit): the
// CTA stages the NF factors at its TR rows and TC columns into shared
// memory with cp.async (tiles.cuh), then gives each thread one entry at
// a time, its dots summed term by term from shared memory; slots are
// unique, so no atomics.  The sparser tiles of a row strip form units of
// at most 32 entries that stage nothing (sddmm_l2_kernel, no shared
// memory): a warp takes warp_e() entries at once, lanes over r, their
// rows from L2.  With no staged unit, or staged arrays above
// SDDMM_SMEM_MAX, sddmm_off_kernel takes every entry the same way,
// straight from (rows, cols).  The diagonal rows ride in the warp
// path's launch (the dots at (i, i)): one launch less.
//
// A warp's entries keep the order of sums of a warp per entry: lane l
// sums columns l, l + 32, ... in turn, then a shuffle tree; the entries
// of a warp only put their loads in flight together.  So the warp paths
// give what a warp per entry gives, bit for bit, and, when the factors
// of a two-dot policy are equal, its two dots are equal term for term:
// their mean is then the one dot, bit for bit (K3's U-is-V path).

#pragma once
#include <cuda_runtime.h>

#include "tiles.cuh"
#include "warp_acc.cuh"

namespace lt {

constexpr int SDDMM_THREADS = 256;
constexpr int SDDMM_WARPS = SDDMM_THREADS / 32;
constexpr size_t SDDMM_SMEM_MAX = 100 * 1024;
// entries a warp takes at once on the warp path: 4 where an entry's sums
// take at most 8 bytes (K3's one dot at f64, two at f32), else 1.  More
// entries put more loads in flight on fewer CTAs an SM (more
// registers): on an H100, 4 entries of two f64 dots took K3 at
// maxcut20000's pattern 0.0218 -> 0.0210 ms, but the skewed pattern's
// units of sparse tiles 0.0334 -> 0.0395 and K6 there 0.0344 -> 0.0402.
template <class P>
__host__ __device__ constexpr int warp_e() {
  return P::ND * sizeof(typename P::A) <= 8 ? 4 : 1;
}

// CTAs an SM the warp kernels ask ptxas to fit: 8 (32 registers a
// thread, 64 warps an SM) for one entry of at most 16 bytes of sums,
// where ptxas otherwise took 40 (on an H100, K6 at maxcut20000's
// pattern 0.0200 ms against 0.0222 with no bound, two f64 dots of K3
// 0.0218 against 0.0231, the batch's 0.0877 against 0.0968); 4 (64
// registers) for 4 entries; 6 (40 registers) for K3p's three dots
// (asked for 1, ptxas took 68-69 and the skewed pattern's K3p ran 0.048
// against 0.037 ms with no bound)
template <class P>
__host__ __device__ constexpr int warp_min_ctas() {
  return warp_e<P>() > 1 ? 4
                         : (P::ND * sizeof(typename P::A) <= 16 ? 8 : 6);
}

// shared memory of a staged unit: NF factors at TR rows and TC columns
template <class P>
__host__ __device__ inline size_t sddmm_smem(int r, int TR, int TC) {
  return (size_t)P::NF * (TR + TC) * padded_stride(r) *
         sizeof(typename P::T);
}

// one CTA per staged unit (blockIdx.x = b * U + u; other units return)
template <class P>
__global__ void __launch_bounds__(SDDMM_THREADS)
    sddmm_staged_kernel(P p, const int* __restrict__ tslot,
                        const int* __restrict__ tij,
                        const int* __restrict__ tbnd,
                        const int* __restrict__ trow0,
                        const int* __restrict__ tcol0, int n, int Ko, int U,
                        int r, int TR, int TC) {
  using T = typename P::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / U, u = blockIdx.x - b * U;
  const int lo = tbnd[(long)b * (U + 1) + u];
  const int hi = tbnd[(long)b * (U + 1) + u + 1];
  const int j0 = tcol0[(long)b * U + u];
  if (lo >= hi || j0 < 0) return;  // uniform across the CTA
  const int i0 = trow0[(long)b * U + u];
  const int rp = padded_stride(r);
  const int ni = min(TR, n - i0), nj = min(TC, n - j0);
  T* S = reinterpret_cast<T*>(smem);
  const T* SI[P::NF];
  const T* SJ[P::NF];
#pragma unroll
  for (int f = 0; f < P::NF; ++f) {
    T* si = S + f * TR * rp;
    T* sj = S + P::NF * TR * rp + f * TC * rp;
    const T* fb = p.f[f] + (long)b * n * r;
    stage_rows(si, fb + (long)i0 * r, ni, r, r, rp);
    stage_rows(sj, fb + (long)j0 * r, nj, r, r, rp);
    SI[f] = si;
    SJ[f] = sj;
  }
  stage_wait();
  __syncthreads();
  const long o = (long)b * Ko;
  for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    const int q = tij[o + k], s = tslot[o + k];
    const int il = q >> IJ_SHIFT, jl = (q & IJ_MASK) - j0;
    const T* I[P::NF];
    const T* J[P::NF];
#pragma unroll
    for (int f = 0; f < P::NF; ++f) {
      I[f] = SI[f] + il * rp;
      J[f] = SJ[f] + jl * rp;
    }
    typename P::A acc[P::ND];
#pragma unroll 4
    for (int c = 0; c < r; ++c) p.dots(acc, I, J, c);
    p.store(acc, o + s);
  }
}

// one warp, the cnt <= E entries whose rows start at elements ri[e] and
// rj[e] of every factor: lanes over r, a shuffle tree each, the entries'
// trees interleaved level by level; lane 0 stores entry e at out[e] >= 0
// (p.store), or a diagonal row at -out[e] - 1 (p.store_diag)
template <int E, class P>
__device__ __forceinline__ void warp_entries(const P& p, const long (&ri)[E],
                                             const long (&rj)[E],
                                             const long (&out)[E], int cnt,
                                             int r) {
  using T = typename P::T;
  const int lane = threadIdx.x & 31;
  typename P::A acc[E][P::ND];
  for (int c = lane; c < r; c += 32) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < cnt) {
        const T* I[P::NF];
        const T* J[P::NF];
#pragma unroll
        for (int f = 0; f < P::NF; ++f) {
          I[f] = p.f[f] + ri[e];
          J[f] = p.f[f] + rj[e];
        }
        p.dots(acc[e], I, J, c);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < cnt) {  // uniform across the warp
#pragma unroll
        for (int d = 0; d < P::ND; ++d) acc[e][d].merge_down(off);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < cnt) {
        if (out[e] >= 0)
          p.store(acc[e], out[e]);
        else
          p.store_diag(acc[e], -out[e] - 1);
      }
    }
  }
}

// one warp, the diagonal rows k0 .. k0 + E - 1 (below nd) of the blocks'
// [B n] rows: the dots at (i, i)
template <int E, class P>
__device__ __forceinline__ void warp_diag(const P& p, int k0, int nd,
                                          int r) {
  const int cnt = min(E, nd - k0);
  long ri[E], out[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long k = k0 + min(e, cnt - 1);
    ri[e] = k * r;
    out[e] = -k - 1;
  }
  warp_entries<E>(p, ri, ri, out, cnt, r);
}

// blocks below units: one CTA per unit of sparse tiles (other units
// return), no shared memory; warp w takes entries lo + w E .. at once,
// then the next SDDMM_WARPS E.  Blocks from units on: the nd diagonal
// rows, SDDMM_WARPS E a block.
template <int E, class P>
__global__ void __launch_bounds__(SDDMM_THREADS, warp_min_ctas<P>())
    sddmm_l2_kernel(P p, const int* __restrict__ tslot,
                    const int* __restrict__ tij, const int* __restrict__ tbnd,
                    const int* __restrict__ trow0,
                    const int* __restrict__ tcol0, int n, int Ko, int U,
                    int r, int units, int nd) {
  const int w = threadIdx.x >> 5;
  if ((int)blockIdx.x >= units) {
    const int k0 = (((int)blockIdx.x - units) * SDDMM_WARPS + w) * E;
    if (k0 < nd) warp_diag<E>(p, k0, nd, r);  // uniform across the warp
    return;
  }
  const int b = blockIdx.x / U, u = blockIdx.x - b * U;
  const int lo = tbnd[(long)b * (U + 1) + u];
  const int hi = tbnd[(long)b * (U + 1) + u + 1];
  if (lo >= hi || tcol0[(long)b * U + u] >= 0) return;  // uniform
  const long i0 = trow0[(long)b * U + u];
  const long o = (long)b * Ko, fo = (long)b * n;
  for (int k0 = lo + w * E; k0 < hi; k0 += SDDMM_WARPS * E) {
    const int cnt = min(E, hi - k0);
    long ri[E], rj[E], out[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = k0 + min(e, cnt - 1);
      const int q = tij[o + k];
      ri[e] = (fo + i0 + (q >> IJ_SHIFT)) * r;
      rj[e] = (fo + (q & IJ_MASK)) * r;
      out[e] = o + tslot[o + k];
    }
    warp_entries<E>(p, ri, rj, out, cnt, r);
  }
}

// no schedule: warp w takes entries w E .. of all blocks' (rows, cols),
// the slot of each entry its position, then the nd diagonal rows
template <int E, class P>
__global__ void __launch_bounds__(SDDMM_THREADS, warp_min_ctas<P>())
    sddmm_off_kernel(P p, const int* __restrict__ rows,
                     const int* __restrict__ cols, int B, int n, int Ko,
                     int r, int nd) {
  // B Ko + nd < 2^31 (the wrapper's int sizes)
  const int k0 =
      (int)(((blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5) * E);
  const int N = B * Ko;
  if (k0 >= N) {  // uniform across the warp: the diagonal's warps follow
    const int kd = k0 - ((N + E - 1) / E) * E;
    if (kd >= 0 && kd < nd) warp_diag<E>(p, kd, nd, r);
    return;
  }
  const int cnt = min(E, N - k0);
  long ri[E], rj[E], out[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = k0 + min(e, cnt - 1);
    const long fo = (long)(k / Ko) * n;
    ri[e] = (fo + rows[k]) * r;
    rj[e] = (fo + cols[k]) * r;
    out[e] = k;
  }
  warp_entries<E>(p, ri, rj, out, cnt, r);
}

// the off values of P on B blocks of Ko slots and, for nd = B n, its
// diagonal (nd = 0: none): over the schedule t (slot, ij, bnd, row0,
// col0; U units a block, 0: none staged; l2: 0 when no unit of sparse
// tiles exists) where it stages something and the staged arrays of Q
// fit SDDMM_SMEM_MAX (the staged units, then one launch of the sparse
// units and the diagonal), else one launch of sddmm_off_kernel on
// (rows, cols) and the diagonal.  Q is P, or the policy whose path P
// must take (K3's one dot takes its two dots' path, so that the two
// agree bit for bit).  Returns cudaGetLastError().
template <class P, class Q = P>
int launch_sddmm(const P& p, const int* rows, const int* cols,
                 const int* const* t, int B, int n, int Ko, int r, int U,
                 int TR, int TC, int l2, int nd, cudaStream_t stream) {
  constexpr int E = warp_e<P>();
  constexpr int PER_BLOCK = SDDMM_WARPS * E;  // entries a block
  const size_t smem = sddmm_smem<P>(r, TR, TC);
  if ((long)B * Ko > 0 && U > 0 &&
      sddmm_smem<Q>(r, TR, TC) <= SDDMM_SMEM_MAX) {
    static SmemLimit limit;
    int err = limit.allow((const void*)sddmm_staged_kernel<P>, smem);
    if (err != 0) return err;
    sddmm_staged_kernel<P><<<(unsigned)(B * U), SDDMM_THREADS, smem,
                             stream>>>(p, t[0], t[1], t[2], t[3], t[4], n,
                                       Ko, U, r, TR, TC);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int units = l2 ? B * U : 0;
    const int blocks = units + (nd + PER_BLOCK - 1) / PER_BLOCK;
    if (blocks > 0)
      sddmm_l2_kernel<E, P><<<(unsigned)blocks, SDDMM_THREADS, 0, stream>>>(
          p, t[0], t[1], t[2], t[3], t[4], n, Ko, U, r, units, nd);
  } else {
    // the diagonal's warps follow the off entries' last warp
    const long warps = ((long)B * Ko + E - 1) / E + ((long)nd + E - 1) / E;
    const long blocks = (warps + SDDMM_WARPS - 1) / SDDMM_WARPS;
    if (blocks > 0)
      sddmm_off_kernel<E, P><<<(unsigned)blocks, SDDMM_THREADS, 0, stream>>>(
          p, rows, cols, B, n, Ko, r, nd);
  }
  return (int)cudaGetLastError();
}

}  // namespace lt
