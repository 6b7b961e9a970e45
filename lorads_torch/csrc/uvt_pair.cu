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
//   rd_d[b, i] = <R_i, D_i>,   dd_d[b, i] = <D_i, D_i>            (diagonal)
//   rd_o[b, k] = (<R_i, D_j> + <R_j, D_i>) / 2,
//   dd_o[b, k] = <D_i, D_j>,   i = rows[b, k], j = cols[b, k]      (off values)
//
// The off values run over K6's schedule of the off slots (sddmm.cuh):
// a staged 64 x 64 tile stages R and D at its rows and columns into
// shared memory (four arrays of 64 x r), and a thread takes one entry at
// a time, its three dots from shared memory, two stores at the entry's
// slot; units of sparse tiles, and patterns with no staged tile, take a
// warp per entry, lanes over r, the rows from L2.  So the gathered
// [Ko, r] blocks never exist and no cache is needed.  The diagonal rows
// ride in the warp path's launch, as entries (i, i).  f32 sums are
// Neumaier-compensated (warp_acc.cuh), f64 sums direct.
//
// What bounds it: the factor rows' traffic into the SMs.  The function
// must move R, D, the indices and four outputs once (12.6 MB at
// matcomp2000: n = 4000, Ko = 478843, r = 17, f64); a warp an entry
// gathers four r-wide rows from L2 for each (260 MB a call), a staged
// tile reads each row once a tile (the pattern's 12 %-dense block uses
// each row in ~240 entries).

#include <cuda_runtime.h>

#include "sddmm.cuh"

namespace {

using lt::Acc;

// rd_o = (<R_i, D_j> + <R_j, D_i>) / 2, dd_o = <D_i, D_j>
template <typename T_>
struct Pair {
  using T = T_;
  using A = Acc<T>;
  static constexpr int NF = 2, ND = 3;
  const T* f[NF];  // R, D
  T* rd_o;
  T* dd_o;
  T* rd_d;
  T* dd_d;
  __device__ __forceinline__ void dots(A (&s)[ND], const T* const (&I)[NF],
                                       const T* const (&J)[NF],
                                       int c) const {
    const T ri = I[0][c], rj = J[0][c], di = I[1][c], dj = J[1][c];
    s[0].add(ri * dj);
    s[1].add(rj * di);
    s[2].add(di * dj);
  }
  __device__ __forceinline__ void store(const A (&s)[ND], long k) const {
    rd_o[k] = T(0.5) * (s[0].value() + s[1].value());
    dd_o[k] = s[2].value();
  }
  __device__ __forceinline__ void store_diag(const A (&s)[ND],
                                             long k) const {
    rd_d[k] = s[0].value();
    dd_d[k] = s[2].value();
  }
};

template <typename T>
int launch(const void* R, const void* D, const void* rows, const void* cols,
           const int* const* t, void* rd_d, void* rd_o, void* dd_d,
           void* dd_o, int B, int n, int Ko, int r, int U, int TR, int TC,
           int l2, cudaStream_t stream) {
  const Pair<T> p{{static_cast<const T*>(R), static_cast<const T*>(D)},
                  static_cast<T*>(rd_o), static_cast<T*>(dd_o),
                  static_cast<T*>(rd_d), static_cast<T*>(dd_d)};
  return lt::launch_sddmm(p, static_cast<const int*>(rows),
                          static_cast<const int*>(cols), t, B, n, Ko, r, U,
                          TR, TC, l2, B * n, stream);
}

}  // namespace

// R, D [B, n, r]; rows, cols int32 [B, Ko]; the schedule of the off
// slots (kernels.Tiles: slot, ij int32 [B, Ko], bnd [B, U+1], row0,
// col0 [B, U], tiles of TR x TC; U == 0: no staged tile, the warp path
// on rows, cols); l2: 0 when no unit of sparse tiles exists; rd_d, dd_d
// [B, n]; rd_o, dd_o [B, Ko]; all contiguous.  is_f64: 1 for float64, 0
// for float32.  Returns cudaGetLastError().
extern "C" int lt_uvt_pair(int is_f64, const void* R, const void* D,
                           const void* rows, const void* cols,
                           const void* t_slot, const void* t_ij,
                           const void* t_bnd, const void* t_row0,
                           const void* t_col0, void* rd_d, void* rd_o,
                           void* dd_d, void* dd_o, int B, int n, int Ko,
                           int r, int U, int TR, int TC, int l2,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t[5] = {static_cast<const int*>(t_slot),
                     static_cast<const int*>(t_ij),
                     static_cast<const int*>(t_bnd),
                     static_cast<const int*>(t_row0),
                     static_cast<const int*>(t_col0)};
  return is_f64 ? launch<double>(R, D, rows, cols, t, rd_d, rd_o, dd_d, dd_o,
                                 B, n, Ko, r, U, TR, TC, l2, s)
                : launch<float>(R, D, rows, cols, t, rd_d, rd_o, dd_d, dd_o,
                                B, n, Ko, r, U, TR, TC, l2, s);
}
