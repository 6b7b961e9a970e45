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
//            of segments [s0, s0 + 16), given by the plan's sub-tile row
//            pointers (sub_ptr, host-built by searchsorted);
//   gather:  out[t, c] = sum_j [ids[t] == j] X[j, c]     over the source
//            rows j in [ids[t0], ids[t0 + 15]] of the sub-tile's ids.
//
// Scatter work split: a warp per (16-segment sub-tile, 32-column group)
// unit, 4 warps a block (1264 units at n = 20000, r <= 32: every SM
// busy; the plan's CT tile and window choose nothing here).  The unit's
// rows go through a ring of 3 staged 16-row k-chunks a warp (values and
// ids, cp.async: 16 bytes a copy where the layout allows, two chunks in
// flight while one is split and multiplied); rows outside the unit are
// zeroed as the B fragment is read.  A block a CT tile would leave
// most SMs idle (79 blocks at CT = 256) and bound the kernel by the
// latency of too few warps.
// Gather work split: units of (16-id sub-tile, 32-column group), 5000
// at K = 80000, r <= 32 (the plan's KT tile chooses nothing here), 4
// warps a block and as many blocks as the SMs hold at once; a warp takes
// the units u, u + stride, ... .  It holds a unit's 16 ids in registers
// (two a lane, and the sub-tile's last) and stages the source rows
// [ids[t0], ids[t0 + 15]] of its columns by cp.async in 16-row k-chunks
// from ids[t0] (16 bytes a copy where r % 4 == 0 and X is 16-byte
// aligned, else 4; rows past the span left unstaged and zeroed as the B
// fragment is read) through a ring of 3 chunks; the next unit's ids load
// while this unit's rows are copied; each D fragment's two adjacent
// columns go out as one 8-byte store where r is even.  A block a KT
// tile of 8 warps, each walking its units one after another with
// scalar loads, left too few independent warps in flight.
// Data flow: each lane builds its one-hot A fragment of mma.m16n8k16 in
// registers from id == segment (or id == row) compares -- no one-hot
// matrix is stored anywhere -- and its B fragment from the staged
// values.  The scatter's [r, K] layout stages a chunk column by column
// ([col][row]), the gather's and the [K, r] layout row by row.
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

#include <algorithm>

#include "tiles.cuh"

namespace {

constexpr int SWARPS = 4;         // warps a block, a unit each
constexpr int NBUF = 3;           // staged k-chunks a warp
constexpr int SUB = 16;          // segments / ids per sub-tile (mma m)
constexpr int KC = 16;           // rows per k-chunk (mma k)
constexpr int NT = 4;            // 8-column n-tiles per unit
constexpr int COLS = 8 * NT;     // columns per unit
constexpr int LD = COLS + 4;     // padded row: conflict-free B reads
constexpr int LDT = KC + 8;      // padded [r, K] column: conflict-free
                                 // float2 B reads, 16-byte aligned
constexpr uint32_t ONE = 0x3F80u;  // bf16 1.0


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

// C fragment element i of n-tile j: row g (+8 for i >= 2), column
// 2t + (i & 1); the planes added in order.
template <int P>
__device__ __forceinline__ float planes_sum(const float (&acc)[P][NT][4],
                                            int j, int i) {
  float v = __fadd_rn(acc[0][j][i], acc[1][j][i]);
  if constexpr (P == 3) v = __fadd_rn(v, acc[2][j][i]);
  return v;
}

// A staged k-chunk of a scatter unit: its values as [row][col] ([K, r]
// layout: a row's columns contiguous, as in vals) or [col][row] ([r, K]:
// a column's 16 rows contiguous, read as float2 pairs), and its ids.
struct __align__(16) Chunk {
  union {
    float kr[KC][LD];
    float rk[COLS][LDT];
  };
  int id[KC];
};

// Rows [k0, k0 + 16) of the unit's column group [n0, n0 + w) into ch,
// rows at or past hi left unstaged (every row of the chunk lies in
// vals: k0 >= 0, and k0 + 16 <= K_pad for the ids).  VEC: 16 bytes a
// cp.async ([K, r]: r % 4 == 0; [r, K]: K % 4 == 0 and k0 % 4 == 0, vals
// 16-byte aligned), else 4.  Asynchronous until the group's wait.
template <bool RK>
__device__ __forceinline__ void stage_chunk(Chunk& ch,
                                            const float* __restrict__ vals,
                                            const int* __restrict__ ids,
                                            int k0, int hi, int n0, int w,
                                            int K, int r, bool vec,
                                            int lane) {
  if (lane < KC) lt::copy_async<4>(&ch.id[lane], ids + k0 + lane);
  if constexpr (!RK) {
    if (vec) {
      // lane e: row e / 8, columns 4 (e % 8) .. + 3
      for (int e = lane; e < KC * 8; e += 32) {
        const int kk = e >> 3, v = e & 7;
        if (4 * v < w && k0 + kk < hi)
          lt::copy_async<16>(&ch.kr[kk][4 * v],
                             vals + (long)(k0 + kk) * r + n0 + 4 * v);
      }
    } else {
      for (int kk = 0; kk < KC && k0 + kk < hi; ++kk)
        if (lane < w)
          lt::copy_async<4>(&ch.kr[kk][lane],
                            vals + (long)(k0 + kk) * r + n0 + lane);
    }
  } else {
    if (vec) {
      // lane e: column e / 4, rows 4 (e % 4) .. + 3
      for (int e = lane; e < COLS * 4; e += 32) {
        const int c = e >> 2, v = e & 3;
        if (c < w && k0 + 4 * v < hi)
          lt::copy_async<16>(&ch.rk[c][4 * v],
                             vals + (long)(n0 + c) * K + k0 + 4 * v);
      }
    } else {
      for (int e = lane; e < COLS * KC; e += 32) {
        const int c = e >> 4, kk = e & 15;
        if (c < w && k0 + kk < hi)
          lt::copy_async<4>(&ch.rk[c][kk],
                            vals + (long)(n0 + c) * K + k0 + kk);
      }
    }
  }
}

// acc[p][j] += A @ plane_p(B_j) for one staged chunk: A[m][kk] = (id ==
// s0 + m) built in registers, B the chunk's values with the rows outside
// [lo, hi) zeroed (unstaged, or a neighbouring sub-tile's).  B fragment
// of m16n8k16: rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of column g.
template <int P, bool RK>
__device__ __forceinline__ void mma_chunk(float (&acc)[P][NT][4],
                                          const Chunk& ch, int k0, int lo,
                                          int hi, int s0, int n0, int r,
                                          int g, int t) {
  const int i0 = ch.id[2 * t], i1 = ch.id[2 * t + 1];
  const int i8 = ch.id[2 * t + 8], i9 = ch.id[2 * t + 9];
  const int sa = s0 + g, sb = s0 + g + 8;
  const uint32_t a0 = onehot2(i0, i1, sa, sa), a1 = onehot2(i0, i1, sb, sb);
  const uint32_t a2 = onehot2(i8, i9, sa, sa), a3 = onehot2(i8, i9, sb, sb);
  const int k = k0 + 2 * t;
  const bool m0 = k >= lo && k < hi, m1 = k + 1 >= lo && k + 1 < hi;
  const bool m8 = k + 8 >= lo && k + 8 < hi, m9 = k + 9 >= lo && k + 9 < hi;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (n0 + 8 * j >= r) break;  // uniform across the warp
    const int col = 8 * j + g;
    float x0, x1, x8, x9;
    if constexpr (RK) {
      const float2 p = *reinterpret_cast<const float2*>(&ch.rk[col][2 * t]);
      const float2 q =
          *reinterpret_cast<const float2*>(&ch.rk[col][2 * t + 8]);
      x0 = p.x; x1 = p.y; x8 = q.x; x9 = q.y;
    } else {
      x0 = ch.kr[2 * t][col]; x1 = ch.kr[2 * t + 1][col];
      x8 = ch.kr[2 * t + 8][col]; x9 = ch.kr[2 * t + 9][col];
    }
    uint32_t p0[P], p1[P], p8[P], p9[P];
    split<P>(m0 ? x0 : 0.f, p0);
    split<P>(m1 ? x1 : 0.f, p1);
    split<P>(m8 ? x8 : 0.f, p8);
    split<P>(m9 ? x9 : 0.f, p9);
#pragma unroll
    for (int p = 0; p < P; ++p)
      mma_bf16(acc[p][j], a0, a1, a2, a3, p0[p] | (p1[p] << 16),
               p8[p] | (p9[p] << 16));
  }
}

// A warp a unit (16-segment sub-tile, 32-column group); its rows [lo,
// hi) from the plan's sub-tile row pointers; k-chunks of 16 rows
// (from lo, or in [r, K] from lo rounded down to a multiple of 4 so
// that a column's 16 rows are four aligned 16-byte copies) through a
// ring of NBUF staged chunks, NBUF - 1 in flight while one is split and
// multiplied.
template <int P, bool RK>
__global__ void __launch_bounds__(SWARPS * 32)
    onehot_scatter_kernel(const float* __restrict__ vals,
                          const int* __restrict__ ids,
                          const int* __restrict__ sub_ptr,
                          float* __restrict__ out, int K, int n, int r,
                          int units, int ngroups, bool vec) {
  __shared__ Chunk ring[SWARPS][NBUF];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int u = blockIdx.x * SWARPS + warp;
  if (u >= units) return;  // uniform across the warp
  const int sub = u / ngroups;
  const int n0 = (u - sub * ngroups) * COLS, s0 = sub * SUB;
  const int w = min(COLS, r - n0);
  const int lo = __ldg(sub_ptr + sub), hi = __ldg(sub_ptr + sub + 1);
  const int kstart = RK ? lo & ~3 : lo;
  const int nch = hi > lo ? (hi - kstart + KC - 1) / KC : 0;
  Chunk* my = ring[warp];
#pragma unroll
  for (int i = 0; i < NBUF - 1; ++i) {
    if (i < nch)
      stage_chunk<RK>(my[i], vals, ids, kstart + i * KC, hi, n0, w, K, r,
                      vec, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float acc[P][NT][4] = {};
  for (int i = 0; i < nch; ++i) {
    const int nx = i + NBUF - 1;
    if (nx < nch)
      stage_chunk<RK>(my[nx % NBUF], vals, ids, kstart + nx * KC, hi, n0, w,
                      K, r, vec, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NBUF - 1) : "memory");
    __syncwarp();
    mma_chunk<P, RK>(acc, my[i % NBUF], kstart + i * KC, lo, hi, s0, n0, r,
                     g, t);
    __syncwarp();  // the chunk's slot is free for the next stage
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (n0 + 8 * j >= r) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int seg = s0 + g + (i >= 2 ? 8 : 0);
      const int c = n0 + 8 * j + 2 * t + (i & 1);
      if (seg < n && c < r)
        out[RK ? (long)c * n + seg : (long)seg * r + c] =
            planes_sum<P>(acc, j, i);
    }
  }
}

// Rows [row0, row0 + nrows) of the unit's column group [n0, n0 + w)
// of X [n, r] into S; asynchronous until the group's wait.  VEC: 16
// bytes a copy (r % 4 == 0, X 16-byte aligned), else 4.
__device__ __forceinline__ void stage_rows_kr(float (*S)[LD],
                                              const float* __restrict__ X,
                                              int row0, int nrows, int n0,
                                              int w, int r, bool vec,
                                              int lane) {
  if (vec) {
    // lane e: row e / 8, columns 4 (e % 8) .. + 3
    for (int e = lane; e < nrows * 8; e += 32) {
      const int kk = e >> 3, v = e & 7;
      if (4 * v < w)
        lt::copy_async<16>(&S[kk][4 * v],
                           X + (long)(row0 + kk) * r + n0 + 4 * v);
    }
  } else {
    for (int kk = 0; kk < nrows; ++kk)
      if (lane < w)
        lt::copy_async<4>(&S[kk][lane], X + (long)(row0 + kk) * r + n0 + lane);
  }
}

// A warp a unit (16-id sub-tile, 32-column group) at a time, its units
// u, u + stride, ... of the grid's warps: the unit's ids in registers
// (the next unit's loaded while this one's rows are copied), the source
// rows of their span [first, last] in k-chunks of 16 rows from first
// through a ring of NBUF staged chunks, NBUF - 1 in flight while one is
// split and multiplied.  A[m][kk] = (ids[t0 + m] == row0 + kk) is built
// in registers; B rows past the span are zeroed.
template <int P>
__global__ void __launch_bounds__(SWARPS * 32)
    onehot_gather_kernel(const float* __restrict__ X,
                         const int* __restrict__ ids,
                         float* __restrict__ out, int K, int r, int units,
                         int ngroups, bool vec, bool vec2) {
  __shared__ __align__(16) float ring[SWARPS][NBUF][KC][LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int stride = gridDim.x * SWARPS;
  int u = blockIdx.x * SWARPS + warp;
  if (u >= units) return;  // uniform across the warp
  // ids are padded to the plan's tile (n_pad + 7 past K: matches no row)
  int t0 = u / ngroups * SUB;
  int ia = __ldg(ids + t0 + g), ib = __ldg(ids + t0 + g + 8);
  int last = __ldg(ids + min(t0 + SUB - 1, K - 1));
  float(*my)[KC][LD] = ring[warp];
  for (;;) {
    const int n0 = (u - t0 / SUB * ngroups) * COLS;
    const int w = min(COLS, r - n0);
    const int first = __shfl_sync(0xffffffffu, ia, 0);
    const int nch = (last - first) / KC + 1;
#pragma unroll
    for (int i = 0; i < NBUF - 1; ++i) {
      if (i < nch)
        stage_rows_kr(my[i], X, first + i * KC,
                      min(KC, last - first - i * KC + 1), n0, w, r, vec,
                      lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const int un = u + stride;
    int tn = 0, na = 0, nb = 0, nl = 0;
    if (un < units) {
      tn = un / ngroups * SUB;
      na = __ldg(ids + tn + g);
      nb = __ldg(ids + tn + g + 8);
      nl = __ldg(ids + min(tn + SUB - 1, K - 1));
    }
    float acc[P][NT][4] = {};
    for (int i = 0; i < nch; ++i) {
      const int nx = i + NBUF - 1;
      if (nx < nch)
        stage_rows_kr(my[nx % NBUF], X, first + nx * KC,
                      min(KC, last - first - nx * KC + 1), n0, w, r, vec,
                      lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NBUF - 1) : "memory");
      __syncwarp();
      const int row0 = first + i * KC;
      const int nrows = min(KC, last - row0 + 1);
      const float(*S)[LD] = my[i % NBUF];
      // A rows g (ia) and g + 8 (ib), k-columns 2t, 2t+1 and 2t+8, 2t+9
      const int j0 = row0 + 2 * t;
      const uint32_t a0 = onehot2(ia, ia, j0, j0 + 1);
      const uint32_t a1 = onehot2(ib, ib, j0, j0 + 1);
      const uint32_t a2 = onehot2(ia, ia, j0 + 8, j0 + 9);
      const uint32_t a3 = onehot2(ib, ib, j0 + 8, j0 + 9);
      const bool m0 = 2 * t < nrows, m1 = 2 * t + 1 < nrows;
      const bool m8 = 2 * t + 8 < nrows, m9 = 2 * t + 9 < nrows;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n0 + 8 * j >= r) break;  // uniform across the warp
        const int col = 8 * j + g;
        uint32_t p0[P], p1[P], p8[P], p9[P];
        split<P>(m0 ? S[2 * t][col] : 0.f, p0);
        split<P>(m1 ? S[2 * t + 1][col] : 0.f, p1);
        split<P>(m8 ? S[2 * t + 8][col] : 0.f, p8);
        split<P>(m9 ? S[2 * t + 9][col] : 0.f, p9);
#pragma unroll
        for (int p = 0; p < P; ++p)
          mma_bf16(acc[p][j], a0, a1, a2, a3, p0[p] | (p1[p] << 16),
                   p8[p] | (p9[p] << 16));
      }
      __syncwarp();  // the chunk's slot is free for the next stage
    }
    // D fragment: rows g and g + 8, columns 2t and 2t + 1 of each n-tile
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (n0 + 8 * j >= r) break;
      const int c = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = t0 + g + 8 * h;
        if (k >= K) continue;
        const float v0 = planes_sum<P>(acc, j, 2 * h);
        const float v1 = planes_sum<P>(acc, j, 2 * h + 1);
        float* o = out + (long)k * r + c;
        if (vec2 && c + 1 < r) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (c < r) o[0] = v0;
          if (c + 1 < r) o[1] = v1;
        }
      }
    }
    if (un >= units) break;
    u = un; t0 = tn; ia = na; ib = nb; last = nl;
  }
}

}  // namespace

template <int P, bool RK>
void launch_scatter(const float* v, const int* id, const int* sp, float* o,
                    int K, int n, int r, bool vec, cudaStream_t s) {
  const int ngroups = (r + COLS - 1) / COLS;
  const int units = (n + SUB - 1) / SUB * ngroups;
  onehot_scatter_kernel<P, RK><<<(units + SWARPS - 1) / SWARPS,
                                 SWARPS * 32, 0, s>>>(v, id, sp, o, K, n, r,
                                                      units, ngroups, vec);
}

// planes: 2 or 3; rk: 0 for vals [K, r] -> out [n, r], 1 for vals [r, K]
// -> out [r, n]; ids int32 [>= K + 16] sorted (padding n_pad + 7);
// sub_ptr int32 [ceil(n / 16) + 1]: the first row of each 16-segment
// sub-tile (and K).  Returns cudaGetLastError().
extern "C" int lt_onehot_scatter(int planes, int rk, const void* vals,
                                 const void* ids, const void* sub_ptr,
                                 void* out, int K, int n, int r,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* id = static_cast<const int*>(ids);
  const int* sp = static_cast<const int*>(sub_ptr);
  float* o = static_cast<float*>(out);
  const bool vec = reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   (rk ? K % 4 == 0 : r % 4 == 0);
  if (n > 0 && r > 0) {
    if (planes == 3 && rk)
      launch_scatter<3, true>(v, id, sp, o, K, n, r, vec, s);
    else if (planes == 3)
      launch_scatter<3, false>(v, id, sp, o, K, n, r, vec, s);
    else if (rk)
      launch_scatter<2, true>(v, id, sp, o, K, n, r, vec, s);
    else
      launch_scatter<2, false>(v, id, sp, o, K, n, r, vec, s);
  }
  return (int)cudaGetLastError();
}

// A resident grid: the blocks an SM holds (queried once) times the SMs,
// or fewer where the units end first.
template <int P>
int launch_gather(const float* x, const int* id, float* o, int K, int r,
                  int units, int ngroups, bool vec, bool vec2,
                  cudaStream_t s) {
  static int per_sm = 0;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err == 0 && per_sm == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, onehot_gather_kernel<P>, SWARPS * 32, 0);
  if (err != 0) return err;
  const long blocks = std::min<long>((units + SWARPS - 1) / SWARPS,
                                     (long)std::max(per_sm, 1) * sms);
  onehot_gather_kernel<P><<<(unsigned)blocks, SWARPS * 32, 0, s>>>(
      x, id, o, K, r, units, ngroups, vec, vec2);
  return (int)cudaGetLastError();
}

// planes: 2 or 3; X float32 [n, r]; ids int32 [>= ceil(K / 16) * 16]
// sorted, ids[:K] in [0, n), padded with n_pad + 7 (past n + 16: no
// staged row matches it); out [K, r].  Returns cudaGetLastError().
extern "C" int lt_onehot_gather(int planes, const void* X, const void* ids,
                                void* out, int K, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const int* id = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  if (K <= 0 || r <= 0) return (int)cudaGetLastError();
  const int ngroups = (r + COLS - 1) / COLS;
  const int units = (K + SUB - 1) / SUB * ngroups;
  const bool vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec2 = r % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 8 == 0;
  return planes == 3
             ? launch_gather<3>(x, id, o, K, r, units, ngroups, vec, vec2, s)
             : launch_gather<2>(x, id, o, K, r, units, ngroups, vec, vec2, s);
}
