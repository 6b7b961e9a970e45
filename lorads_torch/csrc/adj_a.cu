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
// for its sorted scatters.  Here
//
//   W_o[b, k] = a2[b, k] * (<X_i, F_j> + <X_j, F_i>) / 2,  i = rows[b, k], j = cols[b, k]
//
// and, when d != nullptr (constraints on the diagonal also exist), a
// second kernel writes d[b, i] = <X_i, F_i> for the diagonal
// composition, which the caller runs through K4 twice.  f32 sums are
// Neumaier-compensated (warp_acc.cuh), f64 sums direct.
//
// What bounds it: the traffic of factor rows into the SMs.  The bytes
// the function must move are X and F once, the indices, a2 and W_o
// (12.6 MB at matcomp2000: n = 4000, r = 17, Ko = 478843, f64), but a
// gather of four r-wide rows per entry moves 544 B an entry, 260 MB a
// call, through L2 (the parent design: one warp per entry, 2.3 TB/s).
// Matrix completion's entries share rows: its pattern is a 12 %-dense
// bipartite block, so each row is used by ~240 entries.
//
// The design: the off slots are scheduled once, at bucket build, in
// square tiles of the pattern (kernels.adj_tiles: ADJ_TILE = 64 rows and
// columns).  A tile of at least 16 entries is a staged unit (at most
// 2048 entries; adj_tiled_kernel, one CTA a unit): the CTA stages X and
// F at its 64 rows and 64 columns into shared memory with cp.async
// (tiles.cuh), then gives each thread one entry at a time: the two
// r-term dots from shared memory, one a2 read and one W_o store at the
// entry's slot (slots are unique: no atomics).  The sparser tiles of a
// row strip form units of at most 32 entries that stage nothing
// (adj_l2_kernel, no shared memory, so more CTAs fit an SM): a warp per
// entry reads its four rows from L2, lanes over r, as the parent design
// did (a thread per entry reading whole rows from L2 fetched each
// 8-byte element as its own sector, 2.6x the parent's time at
// maxcut20000's pattern, where nearly every tile is sparse).  At
// matcomp2000 the staged units move ~35 MB a call instead of gathering
// 260 MB.  When the four staged arrays would exceed ADJ_SMEM_MAX (r > 49
// at f64, r > 99 at f32), or no tile is staged, the parent's kernel
// runs instead, on every entry (adj_off_kernel).

#include <cuda_runtime.h>

#include "tiles.cuh"
#include "warp_acc.cuh"

namespace {

using lt::Acc;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int TILED_THREADS = 256;
constexpr size_t ADJ_SMEM_MAX = 100 * 1024;

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

// one thread per entry of the unit's [lo, hi), the rows X_i, F_i, X_j,
// F_j from shared memory
template <typename T>
__device__ __forceinline__ void adj_entries_staged(
    const T* XI, const T* FI, const T* XJ, const T* FJ,
    const int* __restrict__ ij, const int* __restrict__ sl,
    const T* __restrict__ a2b, T* __restrict__ wb, int lo, int hi, int j0,
    int r, int rp) {
  for (int k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    const int p = ij[k], s = sl[k];
    const int il = p >> lt::IJ_SHIFT, jl = (p & lt::IJ_MASK) - j0;
    const T* xi = XI + il * rp;
    const T* fi = FI + il * rp;
    const T* xj = XJ + jl * rp;
    const T* fj = FJ + jl * rp;
    Acc<T> s1, s2;
#pragma unroll 4
    for (int c = 0; c < r; ++c) {
      s1.add(xi[c] * fj[c]);
      s2.add(xj[c] * fi[c]);
    }
    wb[s] = a2b[s] * (T(0.5) * (s1.value() + s2.value()));
  }
}

// one warp per entry of the unit's [lo, hi), lanes over r, every row
// from L2 (a unit of sparse tiles: its rows are used by few entries)
template <typename T>
__device__ __forceinline__ void adj_entries_l2(
    const T* __restrict__ Xb, const T* __restrict__ Fb,
    const int* __restrict__ ij, const int* __restrict__ sl,
    const T* __restrict__ a2b, T* __restrict__ wb, int lo, int hi, int i0,
    int r) {
  const int lane = threadIdx.x & 31;
  for (int k = lo + (threadIdx.x >> 5); k < hi; k += blockDim.x >> 5) {
    const int p = ij[k], s = sl[k];
    const long i = i0 + (p >> lt::IJ_SHIFT), j = p & lt::IJ_MASK;
    Acc<T> s1, s2;
    for (int c = lane; c < r; c += 32) {
      s1.add(Xb[i * r + c] * Fb[j * r + c]);
      s2.add(Xb[j * r + c] * Fb[i * r + c]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      s1.merge_down(off);
      s2.merge_down(off);
    }
    if (lane == 0) wb[s] = a2b[s] * (T(0.5) * (s1.value() + s2.value()));
  }
}

// one CTA per staged unit (blockIdx.x = b * U + u; other units return)
template <typename T>
__global__ void __launch_bounds__(TILED_THREADS)
    adj_tiled_kernel(const T* __restrict__ X, const T* __restrict__ F,
                     const int* __restrict__ tslot,
                     const int* __restrict__ tij,
                     const int* __restrict__ tbnd,
                     const int* __restrict__ trow0,
                     const int* __restrict__ tcol0,
                     const T* __restrict__ a2, T* __restrict__ W_o, int n,
                     int Ko, int U, int r, int TR, int TC) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / U, u = blockIdx.x - b * U;
  const int lo = tbnd[(long)b * (U + 1) + u];
  const int hi = tbnd[(long)b * (U + 1) + u + 1];
  const int j0 = tcol0[(long)b * U + u];
  if (lo >= hi || j0 < 0) return;  // uniform across the CTA
  const int i0 = trow0[(long)b * U + u];
  const T* Xb = X + (long)b * n * r;
  const T* Fb = F + (long)b * n * r;
  const long o = (long)b * Ko;
  const int rp = lt::padded_stride(r);
  T* XI = reinterpret_cast<T*>(smem);
  T* FI = XI + TR * rp;
  T* XJ = FI + TR * rp;
  T* FJ = XJ + TC * rp;
  const int ni = min(TR, n - i0), nj = min(TC, n - j0);
  lt::stage_rows(XI, Xb + (long)i0 * r, ni, r, r, rp);
  lt::stage_rows(FI, Fb + (long)i0 * r, ni, r, r, rp);
  lt::stage_rows(XJ, Xb + (long)j0 * r, nj, r, r, rp);
  lt::stage_rows(FJ, Fb + (long)j0 * r, nj, r, r, rp);
  lt::stage_wait();
  __syncthreads();
  adj_entries_staged<T>(XI, FI, XJ, FJ, tij + o, tslot + o, a2 + o, W_o + o,
                        lo, hi, j0, r, rp);
}

// one CTA per unit of sparse tiles (other units return), no shared
// memory; the schedule splits these units at 32 entries
template <typename T>
__global__ void __launch_bounds__(TILED_THREADS)
    adj_l2_kernel(const T* __restrict__ X, const T* __restrict__ F,
                  const int* __restrict__ tslot, const int* __restrict__ tij,
                  const int* __restrict__ tbnd,
                  const int* __restrict__ trow0,
                  const int* __restrict__ tcol0, const T* __restrict__ a2,
                  T* __restrict__ W_o, int n, int Ko, int U, int r) {
  const int b = blockIdx.x / U, u = blockIdx.x - b * U;
  const int lo = tbnd[(long)b * (U + 1) + u];
  const int hi = tbnd[(long)b * (U + 1) + u + 1];
  if (lo >= hi || tcol0[(long)b * U + u] >= 0) return;  // uniform
  const long o = (long)b * Ko;
  adj_entries_l2<T>(X + (long)b * n * r, F + (long)b * n * r, tij + o,
                    tslot + o, a2 + o, W_o + o, lo, hi,
                    trow0[(long)b * U + u], r);
}

long blocks_for(long warps) {
  return (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
}

template <typename T>
int launch(const void* X, const void* F, const void* rows, const void* cols,
           const void* a2, const void* const* t, void* d, void* W_o, int B,
           int n, int Ko, int r, int U, int TR, int TC, int l2,
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
  if ((long)B * Ko <= 0) return (int)cudaGetLastError();
  const size_t smem =
      (size_t)2 * (TR + TC) * lt::padded_stride(r) * sizeof(T);
  if (smem <= ADJ_SMEM_MAX && U > 0) {
    static lt::SmemLimit limit;
    int err = limit.allow((const void*)adj_tiled_kernel<T>, smem);
    if (err != 0) return err;
    const int* ti[5];
    for (int k = 0; k < 5; ++k) ti[k] = static_cast<const int*>(t[k]);
    const unsigned grid = (unsigned)((long)B * U);
    adj_tiled_kernel<T><<<grid, TILED_THREADS, smem, stream>>>(
        xp, fp, ti[0], ti[1], ti[2], ti[3], ti[4],
        static_cast<const T*>(a2), static_cast<T*>(W_o), n, Ko, U, r, TR, TC);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (l2)
      adj_l2_kernel<T><<<grid, TILED_THREADS, 0, stream>>>(
          xp, fp, ti[0], ti[1], ti[2], ti[3], ti[4],
          static_cast<const T*>(a2), static_cast<T*>(W_o), n, Ko, U, r);
  } else {
    adj_off_kernel<T><<<(unsigned)blocks_for((long)B * Ko),
                        32 * WARPS_PER_BLOCK, 0, stream>>>(
        xp, fp, static_cast<const int*>(rows), static_cast<const int*>(cols),
        static_cast<const T*>(a2), static_cast<T*>(W_o), B, n, Ko, r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// X, F [B, n, r]; rows, cols int32 [B, Ko]; a2 [B, Ko]; the schedule
// (kernels.Tiles: slot, ij int32 [B, Ko], bnd [B, U+1], row0, col0
// [B, U], tiles of TR x TC; U == 0: no staged tile, the warp-per-entry
// kernel on rows, cols); l2: 0 when no unit of sparse tiles exists; d
// [B, n] or NULL; W_o [B, Ko]; all contiguous.  is_f64: 1 for float64,
// 0 for float32.  Returns cudaGetLastError().
extern "C" int lt_adj_a_offdiag(int is_f64, const void* X, const void* F,
                                const void* rows, const void* cols,
                                const void* a2, const void* t_slot,
                                const void* t_ij, const void* t_bnd,
                                const void* t_row0, const void* t_col0,
                                void* d, void* W_o, int B, int n, int Ko,
                                int r, int U, int TR, int TC, int l2,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* t[5] = {t_slot, t_ij, t_bnd, t_row0, t_col0};
  return is_f64 ? launch<double>(X, F, rows, cols, a2, t, d, W_o, B, n, Ko,
                                 r, U, TR, TC, l2, s)
                : launch<float>(X, F, rows, cols, a2, t, d, W_o, B, n, Ko,
                                r, U, TR, TC, l2, s);
}
