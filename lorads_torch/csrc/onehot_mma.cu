// P1 onehot_scatter and P2 onehot_gather: sorted segment sum and sorted
// row gather as one-hot products on the tensor cores (mma.sync, bf16).
//
// Replaces tools/probes/onehot.py sorted_scatter (:190) / sorted_gather
// (:238) and the one-hot window scatters of the other probes
// (microbench_gather5/6, onehot_bisect, onehot_nn, onehot_r,
// pallas_gather3/4 sT: the same function in a [K, r] or [r, K] layout).
// The TPU kernels multiply a one-hot matrix, built from an iota compare,
// by a whole 2*WT-row window held in VMEM.  On Hopper that window (2 *
// 2048 rows * 24 * 4 B = 393 KB) does not fit a block's 227 KB of shared
// memory, and multiplying all of it would cost 2 * CT * 2WT * r flops per
// plane per tile -- more than the bytes.  So each 16-wide sub-tile
// streams only the rows that feed it:
//
//   scatter: out[s, c] = sum_k [ids[k] == s] vals[k, c]  over the rows k
//            of segments [s0, s0 + 16), found by binary search of the
//            sorted ids inside the plan's window of the tile;
//   gather:  out[t, c] = sum_j [ids[t] == j] X[j, c]     over the source
//            rows j in [ids[t0], ids[t0 + 15]] of the sub-tile's ids.
//
// Work split: one block per CT-segment (KT-id) output tile, 8 warps; a
// warp takes one (16-row sub-tile, 32-column group) unit at a time.
// Data flow: the unit's rows go through the warp's shared memory in
// 16-row k-chunks (ids and the [16, 32] value chunk, zero past the
// segment end and past r); each lane builds its one-hot A fragment of
// mma.m16n8k16 in registers from id == segment (or id == row) compares --
// no one-hot matrix is stored anywhere -- and its B fragment from the
// staged values.  The [r, K] layout stages the chunk with the lanes along
// K, so both layouts give the same shared-memory chunk and B fragment.
// Arithmetic: each f32 value is split in-kernel (round to nearest even)
// into bf16 planes hi, mid(, lo) whose sum is the value exactly (3
// planes) or to ~2^-16 (2 planes); one mma per plane with f32
// accumulation into the plane's own accumulator, and the planes are added
// in order ((hi + mid) + lo) at the store.  Mode "f32" runs as the 3-plane
// split: the one-hot factor is exact in bf16, so every product is exact
// in f32.  r is padded to the mma's 8 columns by masked loads and stores.
// Padded ids (n_pad + 7) match no segment and no row.
//
// What bounds it: device memory at the probes' shapes (one read of the
// values and ids, one write of the output); the one-hot flops at the
// 16-row granularity are ~2 * 16 * 16 * 8 per (k-chunk, 8 columns, plane).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int SUB = 16;          // segments / ids per sub-tile (mma m)
constexpr int KC = 16;           // rows per k-chunk (mma k)
constexpr int NT = 4;            // 8-column n-tiles per unit
constexpr int COLS = 8 * NT;     // columns per unit
constexpr int LD = COLS + 4;     // padded row: conflict-free B reads
constexpr uint32_t ONE = 0x3F80u;  // bf16 1.0

__device__ __forceinline__ int lower_bound(const int* a, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ uint32_t onehot2(int id0, int id1, int key0,
                                            int key1) {
  return (id0 == key0 ? ONE : 0u) | ((id1 == key1 ? ONE : 0u) << 16);
}

// The P bf16 planes of v (round to nearest even), as bit patterns.
template <int P>
__device__ __forceinline__ void split(float v, uint32_t (&b)[P]) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  const float rem = __fsub_rn(v, __bfloat162float(h));
  const __nv_bfloat16 m = __float2bfloat16_rn(rem);
  b[0] = __bfloat16_as_ushort(h);
  b[1] = __bfloat16_as_ushort(m);
  if constexpr (P == 3) {
    const float rem2 = __fsub_rn(rem, __bfloat162float(m));
    b[2] = __bfloat16_as_ushort(__float2bfloat16_rn(rem2));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[p][j] += A @ plane_p(S[:, 8j : 8j + 8]) for the n-tiles inside r.
// B fragment of m16n8k16: rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of
// column g.
template <int P>
__device__ __forceinline__ void mma_planes(float (&acc)[P][NT][4],
                                           float (*S)[LD], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, int n0, int r, int g,
                                           int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (n0 + 8 * j >= r) break;  // uniform across the warp
    const int col = 8 * j + g;
    uint32_t p0[P], p1[P], p8[P], p9[P];
    split<P>(S[2 * t][col], p0);
    split<P>(S[2 * t + 1][col], p1);
    split<P>(S[2 * t + 8][col], p8);
    split<P>(S[2 * t + 9][col], p9);
#pragma unroll
    for (int p = 0; p < P; ++p)
      mma_bf16(acc[p][j], a0, a1, a2, a3, p0[p] | (p1[p] << 16),
               p8[p] | (p9[p] << 16));
  }
}

// C fragment element i of n-tile j: row g (+8 for i >= 2), column
// 2t + (i & 1); the planes added in order.
template <int P>
__device__ __forceinline__ float planes_sum(const float (&acc)[P][NT][4],
                                            int j, int i) {
  float v = __fadd_rn(acc[0][j][i], acc[1][j][i]);
  if constexpr (P == 3) v = __fadd_rn(v, acc[2][j][i]);
  return v;
}

template <int P>
__global__ void __launch_bounds__(WARPS * 32)
    onehot_scatter_kernel(const float* __restrict__ vals,
                          const int* __restrict__ ids,
                          const int* __restrict__ wblock,
                          float* __restrict__ out, int K, int n, int r,
                          int CT, int WT, int rk) {
  __shared__ float sv[WARPS][KC][LD];
  __shared__ int sid[WARPS][KC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x;
  const int w0 = __ldg(wblock + tile) * WT;
  const int w1 = min(w0 + 2 * WT, K);  // the tile's window of rows
  const int ngroups = (r + COLS - 1) / COLS;
  const int units = (CT / SUB) * ngroups;
  for (int u = warp; u < units; u += WARPS) {
    const int n0 = (u % ngroups) * COLS;
    const int s0 = tile * CT + (u / ngroups) * SUB;
    const int lo = lower_bound(ids, w0, w1, s0);
    const int hi = lower_bound(ids, lo, w1, s0 + SUB);
    float acc[P][NT][4] = {};
    for (int k0 = lo; k0 < hi; k0 += KC) {
      if (lane < KC)
        sid[warp][lane] = k0 + lane < hi ? __ldg(ids + k0 + lane) : -1;
      for (int e = lane; e < KC * COLS; e += 32) {
        const int kk = rk ? e % KC : e / COLS;
        const int c = rk ? e / KC : e % COLS;
        const int row = k0 + kk, col = n0 + c;
        float v = 0.f;
        if (row < hi && col < r)
          v = __ldg(vals + (rk ? (long)col * K + row : (long)row * r + col));
        sv[warp][kk][c] = v;
      }
      __syncwarp();
      // A[m][kk] = (ids[k0 + kk] == s0 + m): rows g, g + 8; columns 2t,
      // 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3)
      const int* si = sid[warp];
      const int i0 = si[2 * t], i1 = si[2 * t + 1];
      const int i8 = si[2 * t + 8], i9 = si[2 * t + 9];
      const int sa = s0 + g, sb = s0 + g + 8;
      mma_planes<P>(acc, sv[warp], onehot2(i0, i1, sa, sa),
                    onehot2(i0, i1, sb, sb), onehot2(i8, i9, sa, sa),
                    onehot2(i8, i9, sb, sb), n0, r, g, t);
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (n0 + 8 * j >= r) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int seg = s0 + g + (i >= 2 ? 8 : 0);
        const int c = n0 + 8 * j + 2 * t + (i & 1);
        if (seg < n && c < r)
          out[rk ? (long)c * n + seg : (long)seg * r + c] =
              planes_sum<P>(acc, j, i);
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(WARPS * 32)
    onehot_gather_kernel(const float* __restrict__ X,
                         const int* __restrict__ ids,
                         float* __restrict__ out, int K, int n, int r,
                         int KT) {
  __shared__ float sv[WARPS][KC][LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ngroups = (r + COLS - 1) / COLS;
  const int units = (KT / SUB) * ngroups;
  for (int u = warp; u < units; u += WARPS) {
    const int n0 = (u % ngroups) * COLS;
    const int t0 = blockIdx.x * KT + (u / ngroups) * SUB;
    if (t0 >= K) continue;  // uniform across the warp
    // ids are padded to the tile (n_pad + 7 past K: matches no row)
    const int ia = __ldg(ids + t0 + g), ib = __ldg(ids + t0 + g + 8);
    const int first = __ldg(ids + t0);
    const int last = __ldg(ids + min(t0 + SUB - 1, K - 1));
    float acc[P][NT][4] = {};
    for (int row0 = first; row0 <= last; row0 += KC) {
      for (int e = lane; e < KC * COLS; e += 32) {
        const int row = row0 + e / COLS, col = n0 + e % COLS;
        sv[warp][e / COLS][e % COLS] =
            row < n && col < r ? __ldg(X + (long)row * r + col) : 0.f;
      }
      __syncwarp();
      // A[m][kk] = (ids[t0 + m] == row0 + kk): rows g (ia), g + 8 (ib)
      const int j0 = row0 + 2 * t;
      mma_planes<P>(acc, sv[warp], onehot2(ia, ia, j0, j0 + 1),
                    onehot2(ib, ib, j0, j0 + 1),
                    onehot2(ia, ia, j0 + 8, j0 + 9),
                    onehot2(ib, ib, j0 + 8, j0 + 9), n0, r, g, t);
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (n0 + 8 * j >= r) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = t0 + g + (i >= 2 ? 8 : 0);
        const int c = n0 + 8 * j + 2 * t + (i & 1);
        if (k < K && c < r) out[(long)k * r + c] = planes_sum<P>(acc, j, i);
      }
    }
  }
}

}  // namespace

// planes: 2 or 3; rk: 0 for vals [K, r] -> out [n, r], 1 for vals [r, K]
// -> out [r, n]; ids int32 [>= K] sorted (padding n_pad + 7); wblock
// int32 [n_pad / CT]; CT a multiple of 16.  Returns cudaGetLastError().
extern "C" int lt_onehot_scatter(int planes, int rk, const void* vals,
                                 const void* ids, const void* wblock,
                                 void* out, int K, int n, int n_pad, int r,
                                 int CT, int WT, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = n_pad / CT;
  const float* v = static_cast<const float*>(vals);
  const int* id = static_cast<const int*>(ids);
  const int* wb = static_cast<const int*>(wblock);
  float* o = static_cast<float*>(out);
  if (tiles > 0 && r > 0) {
    if (planes == 3)
      onehot_scatter_kernel<3><<<tiles, WARPS * 32, 0, s>>>(
          v, id, wb, o, K, n, r, CT, WT, rk);
    else
      onehot_scatter_kernel<2><<<tiles, WARPS * 32, 0, s>>>(
          v, id, wb, o, K, n, r, CT, WT, rk);
  }
  return (int)cudaGetLastError();
}

// planes: 2 or 3; X float32 [n, r]; ids int32 [ceil(K / KT) * KT] sorted,
// padded with n_pad + 7; out [K, r]; KT a multiple of 16.  Returns
// cudaGetLastError().
extern "C" int lt_onehot_gather(int planes, const void* X, const void* ids,
                                void* out, int K, int n, int r, int KT,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (K + KT - 1) / KT;
  const float* x = static_cast<const float*>(X);
  const int* id = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  if (tiles > 0 && r > 0) {
    if (planes == 3)
      onehot_gather_kernel<3><<<tiles, WARPS * 32, 0, s>>>(x, id, o, K, n,
                                                           r, KT);
    else
      onehot_gather_kernel<2><<<tiles, WARPS * 32, 0, s>>>(x, id, o, K, n,
                                                           r, KT);
  }
  return (int)cudaGetLastError();
}
