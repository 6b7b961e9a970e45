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
// and, when d != nullptr (constraints on the diagonal also exist), the
// warp path's launch also writes d[b, i] = <X_i, F_i> for the diagonal
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
// columns), and the entries run over that schedule through sddmm.cuh,
// shared with K3 and K3p.  A tile of at least 16 entries is a staged
// unit (at most 2048 entries, one CTA a unit): the CTA stages X and F at
// its 64 rows and 64 columns into shared memory with cp.async
// (tiles.cuh), then gives each thread one entry at a time: the two
// r-term dots from shared memory, one a2 read and one W_o store at the
// entry's slot (slots are unique: no atomics).  The sparser tiles of a
// row strip form units of at most 32 entries that stage nothing (no
// shared memory, so more CTAs fit an SM): a warp per entry, lanes over
// r, its four rows from L2 (a thread per entry reading whole rows from
// L2 fetched each 8-byte element as its own sector, 2.6x the time of a
// warp per entry at maxcut20000's pattern, where nearly every tile is
// sparse).  At matcomp2000 the staged units move ~35 MB a call instead
// of gathering 260 MB.  When the four staged arrays would exceed
// SDDMM_SMEM_MAX (r > 49 at f64, r > 99 at f32), or no tile is staged,
// every entry takes the warp path straight from (rows, cols).

#include <cuda_runtime.h>

#include "sddmm.cuh"

namespace {

using lt::Acc;

// W_o = a2 .* (<X_i, F_j> + <X_j, F_i>) / 2, d = <X_i, F_i>
template <typename T_>
struct AdjA {
  using T = T_;
  using A = Acc<T>;
  static constexpr int NF = 2, ND = 2;
  const T* f[NF];  // X, F
  const T* a2;
  T* W_o;
  T* d;
  __device__ __forceinline__ void dots(A (&s)[ND], const T* const (&I)[NF],
                                       const T* const (&J)[NF],
                                       int c) const {
    s[0].add(I[0][c] * J[1][c]);
    s[1].add(J[0][c] * I[1][c]);
  }
  __device__ __forceinline__ void store(const A (&s)[ND], long k) const {
    W_o[k] = a2[k] * (T(0.5) * (s[0].value() + s[1].value()));
  }
  __device__ __forceinline__ void store_diag(const A (&s)[ND],
                                             long k) const {
    d[k] = s[0].value();
  }
};

template <typename T>
int launch(const void* X, const void* F, const void* rows, const void* cols,
           const void* a2, const int* const* t, void* d, void* W_o, int B,
           int n, int Ko, int r, int U, int TR, int TC, int l2,
           cudaStream_t stream) {
  const AdjA<T> p{{static_cast<const T*>(X), static_cast<const T*>(F)},
                  static_cast<const T*>(a2), static_cast<T*>(W_o),
                  static_cast<T*>(d)};
  return lt::launch_sddmm(p, static_cast<const int*>(rows),
                          static_cast<const int*>(cols), t, B, n, Ko, r, U,
                          TR, TC, l2, d != nullptr ? B * n : 0, stream);
}

}  // namespace

// X, F [B, n, r]; rows, cols int32 [B, Ko]; a2 [B, Ko]; the schedule
// (kernels.Tiles: slot, ij int32 [B, Ko], bnd [B, U+1], row0, col0
// [B, U], tiles of TR x TC; U == 0: no staged tile, the warp path on
// rows, cols); l2: 0 when no unit of sparse tiles exists; d
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
  const int* t[5] = {static_cast<const int*>(t_slot),
                     static_cast<const int*>(t_ij),
                     static_cast<const int*>(t_bnd),
                     static_cast<const int*>(t_row0),
                     static_cast<const int*>(t_col0)};
  return is_f64 ? launch<double>(X, F, rows, cols, a2, t, d, W_o, B, n, Ko,
                                 r, U, TR, TC, l2, s)
                : launch<float>(X, F, rows, cols, a2, t, d, W_o, B, n, Ko,
                                r, U, TR, TC, l2, s);
}
