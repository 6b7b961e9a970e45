// K4 gather_segsum: a gather fused with a sorted segment sum.
//
// Replaces, in lorads_tpu/ops/pattern.py, constr_vals (:1140: A(.) on the
// pattern values, split and dense), the W_d / W_o / dense sums of
// build_w (:1250-1304), the dd sums of the dense CG operator
// (:1466-1470) and scatter_constr (:1189), and in lorads_tpu/ops/lp.py
// the LP's constr_vals and adjoint_cols (:113, :128).  The TPU version
// gathers x at the entries into a [B, N] product, multiplies by the entry
// values and reduces it with the compensated prefix scan comp_segment_sum
// (K1) -- or, when every segment holds one entry, an exact masked gather
// (single_segment_sum).  Here the segment bounds are CSR pointers and one
// pass does all of it:
//
//   out[b, s] = base[b, s]
//             + alpha * sum_{k in [bnd[b, s], bnd[b, s+1])} val[b, k] * x[b, idx[b, k]]
//
// with base == nullptr read as 0.  x has any length Nx (the diagonal of
// sym(UV^T), its off-pattern values, a flat [n^2] matrix, or a
// constraint-space vector).
//
// What bounds it: not bytes (theta800's dense A(.) moves 0.1 MB, 0.00004
// ms at 3.35 TB/s) but the latency of the dependent loads bnd -> idx ->
// x, an L2 round trip each.  A schedule that walks a segment in one
// thread pays that latency once per entry: theta's trace constraint (800
// entries among 3200 one-entry constraints) took 800 serial gathers.  So
// the schedule spends the card's parallelism on the entries of a segment
// and keeps several loads in flight per lane:
//
// * G lanes per segment, G a power of two from 1 to 32 picked on the host
//   from the mean segment length N / S (shapes only: reading bnd on the
//   host would sync every call).  A warp takes 32 / G consecutive
//   segments; the G lanes of a segment stride over its entries and
//   combine by a shuffle tree.  Layouts of one- or two-entry segments
//   (matcomp's A(.), C + A^*(w), the dense dd sums, scatter_constr) keep
//   G = 1; the LP's K8a / K8b (60-200 entries per segment) take G = 32.
// * A segment longer than 8 G entries is left by its group; after the
//   group pass the warp takes each such segment in turn (__ballot_sync)
//   with all 32 lanes, so no lane walks more than ceil(len / 32) entries
//   of it: theta800's trace is 25 strided steps per lane, not 800.
// * Each lane loop issues its idx / val loads and x gathers ahead of the
//   accumulation, U entries at a time (U = 4 in the group pass, 1 with
//   G = 1, 8 in the warp pass).  With G = 32 (K8a, K8b: a few entries per
//   lane) the last batch is predicated, so a lane's entries are one round
//   of loads; elsewhere the remainder is walked one by one (predicated
//   batches there took 48-62 registers and cost the one-entry layouts and
//   theta's trace 10-30 %).
// * No __launch_bounds__: with it ptxas held the G = 1 instances to 32 or
//   40 registers and spilled 4-8 bytes, which cost the one-entry layouts
//   5-10 % against the parent's thread-per-segment kernel.
//
// Segments of many thousand entries (a theta of n >= 4096 has a trace of
// that length) would be better served by a block per segment and a
// second pass over the blocks' sums; no path of today has one, and a
// warp walks them correctly.
//
// The schedule's device code lives in segsum.cuh, shared with K2's r = 1
// matvec (cmul.cu); this file adds K4's epilogue (base, alpha).
//
// Exactness: a one-entry segment is summed exactly (0 + p == p, the other
// lanes add zeros), as the reference's single_segment_sum is; alpha and
// base are applied with _rn intrinsics, one rounding each, so one-entry
// outputs equal the plain version's bit for bit.  f32 sums are
// Neumaier-compensated (warp_acc.cuh), f64 sums direct.  No atomics: each
// output's order of summation is fixed from run to run.

#include <cuda_runtime.h>

#include "segsum.cuh"

namespace {

// out[t] = base[t] + alpha * sum, each operation rounded once (_rn), so a
// one-entry segment's output equals the plain version's bit for bit
template <typename T>
struct StoreBase {
  const T* base;
  T* out;
  T alpha;
  __device__ __forceinline__ void operator()(long t, int, T sum) const {
    T v = lt::mul_rn(alpha, sum);
    if (base != nullptr) v = lt::add_rn(base[t], v);
    out[t] = v;
  }
};

template <typename T>
int launch(const void* x, const void* idx, const void* val, const void* bnd,
           const void* base, void* out, int B, int Nx, int N, int S,
           double alpha, cudaStream_t stream) {
  lt::launch_segsum(static_cast<const T*>(x), static_cast<const int*>(idx),
                    static_cast<const T*>(val), static_cast<const int*>(bnd),
                    B, Nx, N, S,
                    StoreBase<T>{static_cast<const T*>(base),
                                 static_cast<T*>(out), (T)alpha},
                    stream);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, Nx], idx int32 [B, N] into x, val [B, N], bnd int32 [B, S+1]
// nondecreasing within [0, N], base [B, S] or NULL, out [B, S]; all
// contiguous.  is_f64: 1 for float64, 0 for float32.
// Returns cudaGetLastError().
extern "C" int lt_gather_segsum(int is_f64, const void* x, const void* idx,
                                const void* val, const void* bnd,
                                const void* base, void* out, int B, int Nx,
                                int N, int S, double alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(x, idx, val, bnd, base, out, B, Nx, N, S,
                                 alpha, s)
                : launch<float>(x, idx, val, bnd, base, out, B, Nx, N, S,
                                alpha, s);
}
