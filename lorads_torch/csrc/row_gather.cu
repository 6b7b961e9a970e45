// P3 row_gather: unsorted row gather X[ids] on the CUDA cores.
//
// Replaces the in-kernel dynamic gathers of tools/probes/:
// microbench_pallas_gather.py gA-gD (X[n, r] rows by a [T] id block),
// microbench_pallas_gather2.py g, microbench_gather.py pallas_gather and
// microbench_gather9.py fA/fB (scalar-prefetch loops over a VMEM table);
// the transposed layout of microbench_pallas_gather3/4.py gT ([R, n] ->
// [R, K] along the lanes); and the scalar gathers gE/gE2 (r = 1).  The
// TPU gathers by a scalar loop or a lane shuffle inside VMEM.
//
//   row layout:        out[k, c] = X[ids[k], c]       X [n, r], out [K, r]
//   transposed layout: out[c, k] = X[c, ids[k]]       X [R, n], out [R, K]
//
// Row layout: the lanes of a warp run over the flattened (row, vector)
// index of the output, so a warp covers a group of consecutive output
// rows, writes 32 consecutive vectors and reads each source row as
// contiguous vectors: 16-byte float4 loads when r % 4 == 0 (and the
// pointers allow), else 4-byte loads.
//
// Width 1 (a [n] table, [n, 1] or [1, n]): the wrapper passes it as the
// transposed layout at R = 1, a [1, n] row, to the direct kernel (rb =
// 0): a thread 4 ids from one int4 load, 4 independent gathers through
// the read-only path and one float4 store, 64 threads a block over at
// most one wave with a grid-stride loop (a thread an id where K % 4 != 0
// or ids or out is not 16-byte aligned).  A caller's rb = 1 forces the
// staged schedule below with the table as its one row (gE's own design),
// which wins from ~10 ids a table entry (PERF.md §6, PR 13).
//
// Transposed layout, staged schedule: what gT keeps in VMEM, a block
// keeps in shared memory.  A block takes RB table rows (RB = 1 or 2, a
// row of n floats each, 80 KB at n = 20000) and a slice of the ids: it
// copies its rows in with 16-byte cp.async (4-byte where a row is not
// 16-byte aligned), one commit group a row, loads its ids once into
// registers (int4 loads where K % 4 == 0), then for each row, as soon as
// that row has landed, reads sX[row][ids[k]] from shared memory and
// writes the output row coalesced along K (float4 stores where K % 4 ==
// 0).  The grid, (K slices) x (row groups), fills every SM, and its
// sizes come from the host (probes/gather.py cols_schedule).  A 4-byte
// read of X[c, id] straight from L2 costs a 32-byte sector; staged, the
// table's rows cross from L2 once a block.
// Transposed layout, L2 schedule: a thread an id, the lanes over K
// (coalesced writes of each output row), X read through the read-only
// path.  The host picks it where a row does not fit a block's shared
// memory, or where the ids are too few to pay for staging a row.
//
// What bounds it: device memory (or L2, for a table that fits its 50 MB)
// -- each gathered row is read once and written once; the ids are read
// once.  Staged, the rows' copies from L2 (RB x n x 4 bytes a block)
// come first and the output's writes after.  At width 1 the bytes are
// too few to matter: the direct kernel is bound by its random 4-byte
// gathers, one L1 request each, after the launch and two dependent
// reads (ids, then the table); staged, by the table's copy into each
// block before its first gather (PERF.md §6, PR 13).  Ids are checked
// against [0, n) by the wrapper, not here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tiles.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROW_THREADS = 512;  // staged schedule: threads a staged row
// the direct 1-D gather: small blocks, so that a few thousand ids still
// spread over every SM (its random gathers queue in each SM's L1)
constexpr int FLAT_THREADS = 64;
constexpr int IDS = 24;           // staged schedule: ids a thread holds

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ X,
                                   const int* __restrict__ ids,
                                   V* __restrict__ out, long total, int rv) {
  const long e = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long k = e / rv;
  const int c = (int)(e - k * rv);
  out[e] = __ldg(X + (long)__ldg(ids + k) * rv + c);
}

__global__ void gather_cols_kernel(const float* __restrict__ X,
                                   const int* __restrict__ ids,
                                   float* __restrict__ out, int n, int K,
                                   int r) {
  const long k = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long id = __ldg(ids + k);
  for (int c = 0; c < r; ++c)
    out[(long)c * K + k] = __ldg(X + (long)c * n + id);
}

// The 1-D gather (r = 1), direct: a thread takes 4 ids from one int4
// load, issues 4 independent gathers and writes one float4 (VEC: K % 4
// == 0, ids and out 16-byte aligned; else a thread an id), over a grid
// of at most one wave with a grid-stride loop.
template <bool VEC>
__global__ void __launch_bounds__(FLAT_THREADS)
    gather_flat_kernel(const float* __restrict__ X,
                       const int* __restrict__ ids, float* __restrict__ out,
                       int K) {
  const long tid = blockIdx.x * (long)blockDim.x + threadIdx.x;
  const long stride = gridDim.x * (long)blockDim.x;
  if constexpr (VEC) {
    const int4* i4 = reinterpret_cast<const int4*>(ids);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long q = tid; q < K / 4; q += stride) {
      const int4 i = __ldg(i4 + q);
      o4[q] = make_float4(__ldg(X + i.x), __ldg(X + i.y), __ldg(X + i.z),
                          __ldg(X + i.w));
    }
  } else {
    for (long k = tid; k < K; k += stride) out[k] = __ldg(X + __ldg(ids + k));
  }
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The staged schedule: block (x, y) takes the ids [x * slice, + slice)
// and the rows [y * RB, + RB) of X, RB * 512 threads, a thread up to IDS
// ids.  VEC: K % 4 == 0, slice % 4 == 0, ids and out 16-byte aligned.
template <int RB, bool VEC>
__global__ void __launch_bounds__(RB * ROW_THREADS, 2 / RB)
    gather_cols_staged_kernel(const float* __restrict__ X,
                              const int* __restrict__ ids,
                              float* __restrict__ out, int n, int K, int R,
                              int slice) {
  extern __shared__ __align__(16) float sX[];
  constexpr int T = RB * ROW_THREADS;
  const int np = (n + 3) & ~3;  // staged row stride: 16-byte aligned rows
  const int c0 = blockIdx.y * RB;
  const int rb = min(RB, R - c0);
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    if (j < rb)
      lt::stage_rows(sX + j * np, X + (long)(c0 + j) * n, 1, n, n, n);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const int k0 = blockIdx.x * slice;
  const int len = min(slice, K - k0);
  int id[IDS];
#pragma unroll
  for (int i = 0; i < IDS / 4; ++i) {
    if constexpr (VEC) {
      const int v = threadIdx.x + T * i;
      if (4 * v < len) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(ids + k0) + v);
        id[4 * i] = q.x; id[4 * i + 1] = q.y;
        id[4 * i + 2] = q.z; id[4 * i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = threadIdx.x + T * (4 * i + q);
        if (k < len) id[4 * i + q] = __ldg(ids + k0 + k);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    if (RB == 2 && j == 0)
      wait_group<1>();  // row 0 has landed, row 1 may still be in flight
    else
      wait_group<0>();
    __syncthreads();
    if (j < rb) {
      const float* s = sX + j * np;
      float* o = out + (long)(c0 + j) * K + k0;
#pragma unroll
      for (int i = 0; i < IDS / 4; ++i) {
        if constexpr (VEC) {
          const int v = threadIdx.x + T * i;
          if (4 * v < len)
            reinterpret_cast<float4*>(o)[v] =
                make_float4(s[id[4 * i]], s[id[4 * i + 1]], s[id[4 * i + 2]],
                            s[id[4 * i + 3]]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = threadIdx.x + T * (4 * i + q);
            if (k < len) o[k] = s[id[4 * i + q]];
          }
        }
      }
    }
  }
}

template <int RB, bool VEC>
int launch_staged(const float* X, const int* ids, float* out, int n, int K,
                  int R, int slice, cudaStream_t s) {
  static lt::SmemLimit limit;
  const size_t smem = (size_t)RB * ((n + 3) & ~3) * sizeof(float);
  const int err =
      limit.allow((const void*)gather_cols_staged_kernel<RB, VEC>, smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)((K + slice - 1) / slice),
                  (unsigned)((R + RB - 1) / RB));
  gather_cols_staged_kernel<RB, VEC><<<grid, RB * ROW_THREADS, smem, s>>>(
      X, ids, out, n, K, R, slice);
  return (int)cudaGetLastError();
}

unsigned blocks_for(long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

// The direct 1-D gather over at most one wave: the blocks an SM holds
// (queried once) times the SMs.
template <bool VEC>
int launch_flat(const float* X, const int* ids, float* out, int K,
                cudaStream_t s) {
  static int per_sm = 0;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err == 0 && per_sm == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_flat_kernel<VEC>, FLAT_THREADS, 0);
  if (err != 0) return err;
  const long work = VEC ? K / 4 : K;
  const long blocks = std::min<long>((work + FLAT_THREADS - 1) / FLAT_THREADS,
                                     (long)std::max(per_sm, 1) * sms);
  if (blocks > 0)
    gather_flat_kernel<VEC><<<(unsigned)blocks, FLAT_THREADS, 0, s>>>(
        X, ids, out, K);
  return (int)cudaGetLastError();
}

}  // namespace

// transposed: 0 for X [n, r] -> out [K, r], 1 for X [r, n] -> out [r, K]
// (at r = 1 the 1-D gather); ids int32 [K] in [0, n); all contiguous
// float32.  For the transposed layout rb (the rows a block stages, 1 or
// 2; 0: the L2 schedule, at r = 1 the direct kernel) and slice (the ids a
// block takes, at most rb * 512 * 24, a multiple of 4) come from the
// host.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a schedule the kernels cannot run.
extern "C" int lt_row_gather(int transposed, const void* X, const void* ids,
                             void* out, int n, int K, int r, int rb,
                             int slice, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  if (K <= 0 || r <= 0) return (int)cudaGetLastError();
  if (transposed && rb != 0) {
    if (rb < 0 || rb > 2 || slice <= 0 || slice % 4 != 0 ||
        slice > rb * ROW_THREADS * IDS)
      return (int)cudaErrorInvalidValue;
    const float* x = static_cast<const float*>(X);
    float* o = static_cast<float*>(out);
    const bool vec =
        K % 4 == 0 && ((reinterpret_cast<uintptr_t>(ids) |
                        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (rb == 2)
      return vec ? launch_staged<2, true>(x, id, o, n, K, r, slice, s)
                 : launch_staged<2, false>(x, id, o, n, K, r, slice, s);
    return vec ? launch_staged<1, true>(x, id, o, n, K, r, slice, s)
               : launch_staged<1, false>(x, id, o, n, K, r, slice, s);
  }
  if (transposed && r == 1) {
    const bool vec =
        K % 4 == 0 && ((reinterpret_cast<uintptr_t>(ids) |
                        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const float* x = static_cast<const float*>(X);
    float* o = static_cast<float*>(out);
    return vec ? launch_flat<true>(x, id, o, K, s)
               : launch_flat<false>(x, id, o, K, s);
  }
  if (transposed) {
    gather_cols_kernel<<<blocks_for(K), THREADS, 0, s>>>(
        static_cast<const float*>(X), id, static_cast<float*>(out), n, K, r);
  } else if (r % 4 == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
             (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const long total = (long)K * (r / 4);
    gather_rows_kernel<float4><<<blocks_for(total), THREADS, 0, s>>>(
        static_cast<const float4*>(X), id, static_cast<float4*>(out), total,
        r / 4);
  } else {
    const long total = (long)K * r;
    gather_rows_kernel<float><<<blocks_for(total), THREADS, 0, s>>>(
        static_cast<const float*>(X), id, static_cast<float*>(out), total, r);
  }
  return (int)cudaGetLastError();
}

// The shared memory a block of the current device may opt in to.
extern "C" int lt_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}
