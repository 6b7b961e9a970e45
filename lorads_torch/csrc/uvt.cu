// K3 uvt_split: sym(U V^T) on a split sparsity pattern (an SDDMM).
//
// Replaces the split branch of lorads_tpu/ops/pattern.py: uvt (and
// uvt_from_cache, its U-is-V form from gathered rows).  The TPU version
// gathers four [B, Ko, r] row blocks (U and V at the off rows and off
// columns) into HBM and reduces their products along r.  Here:
//
//   d[b, i] = <U[b, i], V[b, i]>                                (diagonal)
//   o[b, k] = (<U[b, i_k], V[b, j_k]> + <U[b, j_k], V[b, i_k]>) / 2   (off values)
//
// with i_k = rows[b, k], j_k = cols[b, k].  When U is V (the ALM's
// objective values, the spectral repair) both dots are <R_i, R_j>, and
// the off values take one dot an entry, reading two rows instead of
// four: bit for bit the two-dot value of the same path, since the two
// dots then add equal terms in the same order.
//
// The off values run over K6's schedule of the off slots (sddmm.cuh:
// staged 64 x 64 tiles, a thread an entry from shared memory; units of
// sparse tiles and patterns with no staged tile, a warp per entry, or 4
// entries for one dot at f64 or two at f32, lanes over r, rows from L2;
// the diagonal rows ride in that launch, as entries (i, i)).  Sums are direct in the input type (the path runs it
// at f64).
//
// What bounds it: the factor rows' traffic into the SMs.  The function
// must move U, V, the indices and its outputs once (7.84 MB at maxcut
// n=20000, Ko=80000, r=20, f64); a warp path reads two r-wide rows an
// entry from L2 for each factor (one for U is V: 25.6 MB at maxcut20000,
// the traffic of K2's gathers there), a staged tile each factor row once
// a tile (matrix completion's 12 %-dense block, ~240 entries a row).

#include <cuda_runtime.h>

#include "sddmm.cuh"

namespace {

using lt::Direct;

// o = (<U_i, V_j> + <U_j, V_i>) / 2
template <typename T_>
struct UvtTwo {
  using T = T_;
  using A = Direct<T>;
  static constexpr int NF = 2, ND = 2;
  const T* f[NF];  // U, V
  T* o;
  T* d;
  __device__ __forceinline__ void dots(A (&s)[ND], const T* const (&I)[NF],
                                       const T* const (&J)[NF],
                                       int c) const {
    s[0].add(I[0][c] * J[1][c]);
    s[1].add(J[0][c] * I[1][c]);
  }
  __device__ __forceinline__ void store(const A (&s)[ND], long k) const {
    o[k] = T(0.5) * (s[0].value() + s[1].value());
  }
  __device__ __forceinline__ void store_diag(const A (&s)[ND],
                                             long k) const {
    d[k] = s[0].value();
  }
};

// U is V: o = <R_i, R_j>
template <typename T_>
struct UvtOne {
  using T = T_;
  using A = Direct<T>;
  static constexpr int NF = 1, ND = 1;
  const T* f[NF];  // R
  T* o;
  T* d;
  __device__ __forceinline__ void dots(A (&s)[ND], const T* const (&I)[NF],
                                       const T* const (&J)[NF],
                                       int c) const {
    s[0].add(I[0][c] * J[0][c]);
  }
  __device__ __forceinline__ void store(const A (&s)[ND], long k) const {
    o[k] = s[0].value();
  }
  __device__ __forceinline__ void store_diag(const A (&s)[ND],
                                             long k) const {
    d[k] = s[0].value();
  }
};

template <typename T>
int launch(int one_dot, const void* U, const void* V, const void* rows,
           const void* cols, const int* const* t, void* d, void* o, int B,
           int n, int Ko, int r, int Un, int TR, int TC, int l2,
           cudaStream_t stream) {
  const T* u = static_cast<const T*>(U);
  const T* v = static_cast<const T*>(V);
  const int* ri = static_cast<const int*>(rows);
  const int* ci = static_cast<const int*>(cols);
  T* op = static_cast<T*>(o);
  T* dp = static_cast<T*>(d);
  if (one_dot)
    return lt::launch_sddmm<UvtOne<T>, UvtTwo<T>>(
        UvtOne<T>{{u}, op, dp}, ri, ci, t, B, n, Ko, r, Un, TR, TC, l2, B * n,
        stream);
  return lt::launch_sddmm(UvtTwo<T>{{u, v}, op, dp}, ri, ci, t, B, n, Ko, r,
                          Un, TR, TC, l2, B * n, stream);
}

}  // namespace

// U, V [B, n, r] (one_dot: V is U, one dot an entry); rows, cols int32
// [B, Ko]; the schedule of the off slots (kernels.Tiles: slot, ij int32
// [B, Ko], bnd [B, U+1], row0, col0 [B, U], tiles of TR x TC; Un == 0:
// no staged tile, the warp path on rows, cols); l2: 0 when no unit of
// sparse tiles exists; d [B, n]; o [B, Ko]; all contiguous.  is_f64: 1
// for float64, 0 for float32.  Returns cudaGetLastError().
extern "C" int lt_uvt_split(int is_f64, int one_dot, const void* U,
                            const void* V, const void* rows,
                            const void* cols, const void* t_slot,
                            const void* t_ij, const void* t_bnd,
                            const void* t_row0, const void* t_col0, void* d,
                            void* o, int B, int n, int Ko, int r, int Un,
                            int TR, int TC, int l2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t[5] = {static_cast<const int*>(t_slot),
                     static_cast<const int*>(t_ij),
                     static_cast<const int*>(t_bnd),
                     static_cast<const int*>(t_row0),
                     static_cast<const int*>(t_col0)};
  return is_f64 ? launch<double>(one_dot, U, V, rows, cols, t, d, o, B, n,
                                 Ko, r, Un, TR, TC, l2, s)
                : launch<float>(one_dot, U, V, rows, cols, t, d, o, B, n,
                                Ko, r, Un, TR, TC, l2, s);
}
