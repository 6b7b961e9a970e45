// K1 segment_sum_csr: sorted segment sums over CSR bounds.
//
// Replaces lorads_tpu/ops/pattern.py: comp_segment_sum (with its
// _pair_scan / _twosum helpers) and single_segment_sum.  The TPU version
// computes a compensated TwoSum prefix scan over the whole [B, N] array
// and differences it at the segment boundaries, because the TPU has no
// fast scatter and no native f64.  Here the bounds are CSR row pointers,
// so each segment is summed directly and no prefix error exists:
//
//   out[b, j, c] = sum_{k in [bounds[b, j], bounds[b, j+1])} data[b, k, c]
//
// Layout: the segments are sorted and contiguous, so a run of
// consecutive segments j0..j1 is one contiguous span of data,
// [bounds[j0] * r, bounds[j1] * r).  A block takes a run of `run`
// segments (picked on the host from the mean segment length N / S so
// that the run's span fills about half the staging buffer; no host read
// of the bounds), loads the run's bounds once, and streams the span
// through shared memory in pieces of whole segments, 16 bytes a
// cp.async (the span's unaligned head and tail element by element, the
// buffer offset so that the body is 16-byte aligned on both sides; any
// r).  Then a thread sums one (segment, column) of the piece, or a few,
// walking the segment's rows in shared memory; the outputs of a run are
// one contiguous stretch of out, so the stores coalesce.  (Splitting the
// copies into groups, so that the first outputs' sums start while later
// groups are in flight, was slower on the card.)  A segment
// longer than the buffer is a piece of its own: the whole block takes
// it from global memory, threads over (entry group, column), four loads
// in flight a thread, and the groups' partial sums are merged in order
// of the group.
//
// Precision: f64 is summed directly in f64.  f32 is summed with a
// Neumaier (Kahan-Babuska) compensated accumulator, written with
// __fadd_rn/__fsub_rn so no compiler contraction can fold the error term
// away (build without --use_fast_math); that keeps the eps32 * |segment|
// contract of pattern.py:143-148.  Empty segments write 0.
//
// What bounds it: the card's memory bandwidth -- every input value is
// read once and each output written once; the bounds are read once --
// at f64.  At f32 the compensated sums (~9 instructions an entry) take
// longer on the card than the copies, and the block size is set for
// them.

#include <cstdint>

#include <cuda_runtime.h>

#include "tiles.cuh"
#include "warp_acc.cuh"

namespace {

using lt::Acc;
using lt::copy_async;

constexpr int BUF_BYTES = 24 * 1024;  // the staging buffer of a block
constexpr int RUN_MAX = 512;          // segments a block

// threads a block: at f32 the sums, ~9 instructions an entry for the
// compensated add, take longer than the copies and want every thread
// of the SM (8 blocks of 256); at f64 (one add an entry) 128 did better
template <typename T>
constexpr int threads_of() {
  return sizeof(T) == 4 ? 256 : 128;
}

// src[0, total) into buf[a, a + total), a = src's offset in elements
// from a 16-byte boundary, so that the body goes 16 bytes a copy on both
// sides; asynchronous until stage_wait().  Returns a.
template <typename T, int THREADS>
__device__ __forceinline__ int stage_span(T* buf, const T* __restrict__ src,
                                          int total) {
  constexpr int V = 16 / sizeof(T);
  const int a = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  const int head = min(total, (V - a) % V);
  const int body = (total - head) / V;
  T* dst = buf + a;
  for (int e = threadIdx.x; e < head; e += THREADS)
    copy_async<sizeof(T)>(dst + e, src + e);
  for (int e = threadIdx.x; e < body; e += THREADS)
    copy_async<16>(dst + head + e * V, src + head + e * V);
  for (int e = head + body * V + threadIdx.x; e < total; e += THREADS)
    copy_async<sizeof(T)>(dst + e, src + e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return a;
}

// One segment longer than the buffer, rows [lo, hi) of d (row stride
// r), by the whole block: thread t takes column c0 + t % W of entry
// group t / W (G groups, W columns a pass), rows lo + g, lo + g + G, ...;
// the groups' partial sums meet in shared memory and are merged in
// order of the group.  Ends with the block synchronised.
template <typename T, int THREADS>
__device__ void long_segment(const T* __restrict__ d, T* __restrict__ o,
                             int lo, int hi, int r, Acc<T>* part) {
  for (int c0 = 0; c0 < r; c0 += THREADS) {
    const int W = min(r - c0, THREADS), G = THREADS / W;
    const int g = threadIdx.x / W, c = c0 + threadIdx.x % W;
    Acc<T> acc;
    if (g < G) {
      const T* p = d + c;
      int k = lo + g;
      for (; k + 3 * G < hi; k += 4 * G) {
        const T v0 = p[(long)k * r], v1 = p[(long)(k + G) * r];
        const T v2 = p[(long)(k + 2 * G) * r], v3 = p[(long)(k + 3 * G) * r];
        acc.add(v0);
        acc.add(v1);
        acc.add(v2);
        acc.add(v3);
      }
      for (; k < hi; k += G) acc.add(p[(long)k * r]);
      part[threadIdx.x] = acc;
    }
    __syncthreads();
    if (g == 0) {
      for (int h = 1; h < G; ++h) acc.merge(part[h * W + threadIdx.x]);
      o[c] = acc.value();
    }
    __syncthreads();
  }
}

template <typename T, int THREADS = threads_of<T>()>
__global__ void __launch_bounds__(THREADS)
    segment_sum_kernel(const T* __restrict__ data,
                       const int* __restrict__ bounds, T* __restrict__ out,
                       int N, int S, int r, int run, int runs) {
  constexpr int CAP = BUF_BYTES / sizeof(T);  // elements a piece
  __shared__ __align__(16) T buf[CAP + 16 / sizeof(T)];
  __shared__ int sb[RUN_MAX + 1];
  const int b = blockIdx.x / runs;
  const int j0 = (blockIdx.x - b * runs) * run;
  const int nseg = min(run, S - j0);
  const int* bb = bounds + (long)b * (S + 1) + j0;
  for (int i = threadIdx.x; i <= nseg; i += THREADS) sb[i] = bb[i];
  __syncthreads();
  const T* d = data + (long)b * N * r;
  T* o = out + ((long)b * S + j0) * r;
  const int cap_rows = CAP / r;
  int a = 0;  // the piece's first segment
  while (a < nseg) {
    // the piece: segments [a, e), e the last with sb[e] - sb[a] <= cap_rows
    const int lim = sb[a] + cap_rows;
    int e = nseg;
    if (sb[nseg] > lim) {
      int lo = a;
      while (lo < e) {
        const int mid = (lo + e + 1) >> 1;
        if (sb[mid] <= lim) lo = mid; else e = mid - 1;
      }
    }
    if (e == a) {  // segment a alone exceeds the buffer
      long_segment<T, THREADS>(d, o + (long)a * r, sb[a], sb[a + 1], r,
                               reinterpret_cast<Acc<T>*>(buf));
      a += 1;
      continue;
    }
    const int k0 = sb[a];
    const int off =
        stage_span<T, THREADS>(buf, d + (long)k0 * r, (sb[e] - k0) * r);
    lt::stage_wait();
    __syncthreads();
    const int nout = (e - a) * r;
    for (int q = threadIdx.x; q < nout; q += THREADS) {
      const int js = q / r;
      const int j = a + js, c = q - js * r;
      const T* p = buf + off + (sb[j] - k0) * r + c;
      Acc<T> acc;
      const int len = sb[j + 1] - sb[j];
#pragma unroll 4
      for (int k = 0; k < len; ++k) acc.add(p[k * r]);
      o[(long)a * r + q] = acc.value();
    }
    __syncthreads();  // the buffer is free for the next piece
    a = e;
  }
}

// segments a block: the run whose span at the mean segment length fills
// half the buffer, at least 1, at most RUN_MAX
inline int run_of(int N, int S, int r, int elem) {
  const double mean = S > 0 ? (double)N / S : 0.0;
  const double per_seg = (mean > 1.0 ? mean : 1.0) * r;
  const double fit = (BUF_BYTES / elem) / 2 / per_seg;
  return fit < 1.0 ? 1 : fit > RUN_MAX ? RUN_MAX : (int)fit;
}

template <typename T>
int launch(const void* data, const void* bounds, void* out, int B, int N,
           int S, int r, cudaStream_t stream) {
  if ((long)B * S > 0 && r > 0) {
    const int run = run_of(N, S, r, (int)sizeof(T));
    const int runs = (S + run - 1) / run;
    segment_sum_kernel<T><<<(unsigned)((long)B * runs), threads_of<T>(), 0,
                            stream>>>(
        static_cast<const T*>(data), static_cast<const int*>(bounds),
        static_cast<T*>(out), N, S, r, run, runs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// data [B, N, r] (r = 1 for 2-D data), bounds int32 [B, S+1]
// nondecreasing within [0, N], out [B, S, r]; all contiguous.
// is_f64: 1 for float64, 0 for float32.  Returns cudaGetLastError().
extern "C" int lt_segment_sum(int is_f64, const void* data,
                              const void* bounds, void* out, int B, int N,
                              int S, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(data, bounds, out, B, N, S, r, s)
                : launch<float>(data, bounds, out, B, N, S, r, s);
}
