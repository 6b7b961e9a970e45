// K2 cmul_csr: C @ X for a split bucket, as one fused CSR SpMM.
//
// Replaces lorads_tpu/ops/pattern.py: cmul.  The TPU version gathers
// X at the full-symmetric entry columns into a [B, Ks, r] product,
// scales it by C's values and reduces it with the compensated prefix
// scan comp_segment_sum (K1), slicing the entry list into chunks when it
// exceeds 8M entries to bound that transient in HBM.  Here one pass
// fuses the gather, the multiply and the segment sum:
//
//   out[b, i, c] = c_diag[b, i] * X[b, i, c]
//                + sum_{k in [bnd[b, i], bnd[b, i+1])} vals[b, k] * X[b, cols[b, k], c]
//
// so the [Ks, r] product is never written and no chunking is needed.
// c_diag == nullptr drops the diagonal term (the certificate matvec,
// include_diag=False).  The diagonal term is applied after the sum, with
// _rn intrinsics (one rounding each, as the plain version).
//
// The callers' shapes: Max-Cut rows are short (Ks / n = 8 at maxcut
// n=20000 deg 8, 4 at gset_torus10000), r is the solve's rank (20, 19)
// for the ALM's C @ D and ADMM's C @ V, B = 4 for the merged batch, and
// r = 1 for the Lanczos certificate's SpMV.
//
// r == 1: K4's schedule (segsum.cuh): G lanes per row from Ks / n (G = 8
// at maxcut20000, 4 at gset_torus10000, so 4 or 8 rows per warp), rows
// longer than 8 G entries taken by the whole warp, loads issued ahead.
//
// r > 1: a warp takes 32 consecutive column pairs of the block's output
// [n, r], read as [n, ceil(r / 2)] pairs: lane l holds pair p = 32 w + l,
// row p / h, columns 2 (p % h) and the next (h = ceil(r / 2); odd r
// leaves the row's last pair one column).  At r = 20 a warp covers 3.2
// rows with all 32 lanes busy, at any r and without column tiles.  The
// warp's rows own one contiguous stretch of the entry list; the warp
// loads it 32 entries at a time, lane l taking entry l, in one coalesced
// load of cols and one of vals (each entry loaded once a warp, never
// again per column), and each lane takes its row's entries from their
// lanes by shuffles, 4 a round: the 4 X gathers of a round are issued
// before any is summed, and a round past a row's last entry is
// predicated off (the rounds a warp runs: its longest row's entries in
// the stretch, rounded up to 4).  Even r reads each X pair with one
// 16-byte load (double2 / float2), odd r with two.  Rows of any length
// take the same path: a 5000-entry hub row is walked 32 entries a
// stretch by its lanes.
//
// What bounds it: the gathers' traffic from L2, not their latency and
// not HBM bytes.  At maxcut n=20000, Ks=160000, r=20 in f64 the function
// moves 8.56 MB (0.0026 ms at 3.35 TB/s) and a graph replay finds X
// (3.2 MB) in the 50 MB L2, but the rows gather 160000 X rows of 160 B,
// 25.6 MB through L2 into the SMs.  The batch of four spends 0.0065 ms
// an instance above an empty kernel's floor against 0.0080 for one
// alone: most of the time is gather throughput (3.9 TB/s of 160-byte
// rows), the rest the fill and drain of a grid of 1.3 waves.  The
// shuffles share the loads' issue pipe, so few registers and many
// resident warps still pay: 128 threads a block at 56 registers keep 36
// warps an SM.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (device time in a 20-call CUDA graph,
// f64, chip_smoke.py --kernels-of in turns): 0.0096 ms at maxcut20000
// r=20 against 0.0099-0.0100 for three rows a warp, each group walking
// its row with uniform (col, val) loads and one gather in flight, and
// 0.0104-0.0105 for a warp a row; 0.0275-0.0277 against 0.0323-0.0332
// and 0.0452-0.0462 for the batch of four; 0.0035-0.0039 against
// 0.0045-0.0048 and 0.0046-0.0047 at gset_torus10000 r=19; a 5000-entry
// hub row among short ones at r=20 0.33 ms against 0.46 and 0.53.  f32
// at r=20 loses to three rows a warp on that layout (0.51 against 0.47
// ms), for a reason not found (48 registers, no spills).  At r = 1 the
// 2.3 MB lie below one launch's floor (an empty kernel takes
// 0.0013-0.0028 ms per call in a graph).
//
// f32 sums are Neumaier-compensated (warp_acc.cuh), f64 sums are direct.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "segsum.cuh"

namespace {

using lt::Acc;
using lt::FULL;
constexpr int THREADS = 128;  // 4 warps a block
constexpr int U = 4;          // X gathers in flight a lane

template <typename T>
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

// the X values at columns c, c + 1 of the row at xr (c + 1 when two);
// VEC: one 16-byte (8-byte) load, X pairs aligned (even r)
template <typename T, bool VEC>
__device__ __forceinline__ void load_pair(const T* __restrict__ xr, bool two,
                                          T& x0, T& x1) {
  if constexpr (VEC) {
    const typename Pair<T>::type q =
        *reinterpret_cast<const typename Pair<T>::type*>(xr);
    x0 = q.x;
    x1 = q.y;
  } else {
    x0 = xr[0];
    x1 = two ? xr[1] : T(0);
  }
}

// (THREADS, 1): without the second bound ptxas held the f64 kernel to 40
// registers and the 4 gathers of a round no longer overlapped (0.0125-
// 0.0128 against 0.0096 ms at maxcut20000 r=20); it takes 56 now
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    cmul_pairs_kernel(const T* __restrict__ X, const T* __restrict__ c_diag,
                      const int* __restrict__ cols,
                      const T* __restrict__ vals, const int* __restrict__ bnd,
                      T* __restrict__ out, int B, int n, int Ks, int r,
                      int wpb) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int b = warp / wpb;  // the block of the warp's pairs
  if (b >= B) return;        // uniform across the warp
  const int h = (r + 1) >> 1;
  const int p = (warp - b * wpb) * 32 + lane;
  const bool live = p < n * h;
  const int pc = live ? p : n * h - 1;
  const int row = pc / h;
  const int c = 2 * (pc - row * h);
  const bool two = c + 1 < r;
  const int* bb = bnd + (long)b * (n + 1) + row;
  const int lo = bb[0], hi = bb[1];
  const T* xb = X + (long)b * n * r;
  const int ro = row * r + c;
  // the diagonal terms, read before the gathers
  T d0 = T(0), d1 = T(0);
  if (c_diag != nullptr && live) {
    const T cd = c_diag[(long)b * n + row];
    T x0, x1;
    load_pair<T, VEC>(xb + ro, two, x0, x1);
    d0 = lt::mul_rn(cd, x0);
    d1 = lt::mul_rn(cd, x1);
  }
  // the warp's stretch of entries: its first row's start to its last's end
  const int wlo = __shfl_sync(FULL, lo, 0);
  const int whi = (int)__reduce_max_sync(FULL, (unsigned)(live ? hi : 0));
  const int* cb = cols + (long)b * Ks;
  const T* vb = vals + (long)b * Ks;
  Acc<T> a0, a1;
  for (int base = wlo; base < whi; base += 32) {
    int ci = 0;
    T vi = T(0);
    if (base + lane < whi) {
      ci = cb[base + lane];
      vi = vb[base + lane];
    }
    // this lane's row's entries in the 32: lanes s0 .. s0 + cnt - 1
    const int s0 = max(lo, base) - base;
    const int cnt = live ? max(0, min(hi, base + 32) - max(lo, base)) : 0;
    const int nq = (int)__reduce_max_sync(FULL, (unsigned)cnt);
    for (int kk = 0; kk < nq; kk += U) {
      int ii[U];
      T vv[U], x0[U], x1[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = (s0 + kk + u) & 31;
        ii[u] = __shfl_sync(FULL, ci, src);
        vv[u] = __shfl_sync(FULL, vi, src);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x0[u] = T(0);
        x1[u] = T(0);
        if (kk + u < cnt)
          load_pair<T, VEC>(xb + ii[u] * r + c, two, x0[u], x1[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (kk + u < cnt) {
          a0.add(vv[u] * x0[u]);
          a1.add(vv[u] * x1[u]);
        }
    }
  }
  if (!live) return;
  T v0 = a0.value(), v1 = a1.value();
  if (c_diag != nullptr) {
    v0 = lt::add_rn(d0, v0);
    v1 = lt::add_rn(d1, v1);
  }
  T* o = out + (long)b * n * r + ro;
  if constexpr (VEC) {
    typename Pair<T>::type q;
    q.x = v0;
    q.y = v1;
    *reinterpret_cast<typename Pair<T>::type*>(o) = q;
  } else {
    o[0] = v0;
    if (two) o[1] = v1;
  }
}

// r > 1: one launch, pairs loaded whole where r is even and X, out are
// aligned for it; cudaErrorInvalidValue where the int offsets would
// overflow (B n ceil(r / 2) or n r past 2^31 - 32)
template <typename T>
int launch_pairs(const T* X, const T* c_diag, const int* cols, const T* vals,
                 const int* bnd, T* out, int B, int n, int Ks, int r,
                 cudaStream_t stream) {
  const long wpb = ((long)n * ((r + 1) / 2) + 31) / 32;
  if ((long)n * r > INT_MAX - 32 || B * wpb * 32 > INT_MAX - 32)
    return (int)cudaErrorInvalidValue;
  const long blocks = (B * wpb + THREADS / 32 - 1) / (THREADS / 32);
  constexpr size_t align = sizeof(typename Pair<T>::type);
  const bool vec = r % 2 == 0 && reinterpret_cast<uintptr_t>(X) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0;
  if (vec)
    cmul_pairs_kernel<T, true><<<(unsigned)blocks, THREADS, 0, stream>>>(
        X, c_diag, cols, vals, bnd, out, B, n, Ks, r, (int)wpb);
  else
    cmul_pairs_kernel<T, false><<<(unsigned)blocks, THREADS, 0, stream>>>(
        X, c_diag, cols, vals, bnd, out, B, n, Ks, r, (int)wpb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* Xv, const void* c_diagv, const void* colsv,
           const void* valsv, const void* bndv, void* outv, int B, int n,
           int Ks, int r, cudaStream_t stream) {
  const T* X = static_cast<const T*>(Xv);
  const T* c_diag = static_cast<const T*>(c_diagv);
  const int* cols = static_cast<const int*>(colsv);
  const T* vals = static_cast<const T*>(valsv);
  const int* bnd = static_cast<const int*>(bndv);
  T* out = static_cast<T*>(outv);
  if ((long)B * n <= 0 || r <= 0) return (int)cudaGetLastError();
  if (r > 1)
    return launch_pairs(X, c_diag, cols, vals, bnd, out, B, n, Ks, r, stream);
  lt::launch_segsum(X, cols, vals, bnd, B, n, Ks, n,
                    lt::StoreDiag<T>{X, c_diag, out}, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// X [B, n, r], c_diag [B, n] or NULL, cols int32 [B, Ks], vals [B, Ks],
// bnd int32 [B, n+1] (row pointers into the row-sorted entry list),
// out [B, n, r]; all contiguous.  is_f64: 1 for float64, 0 for float32.
// Returns cudaGetLastError().
extern "C" int lt_cmul(int is_f64, const void* X, const void* c_diag,
                       const void* cols, const void* vals, const void* bnd,
                       void* out, int B, int n, int Ks, int r,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(X, c_diag, cols, vals, bnd, out, B, n, Ks,
                                 r, s)
                : launch<float>(X, c_diag, cols, vals, bnd, out, B, n, Ks,
                                r, s);
}
