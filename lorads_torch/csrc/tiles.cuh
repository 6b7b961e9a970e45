// Shared pieces of the tiled kernels K5 (wmul.cu) and K6 (adj_a.cu):
// the packing of a schedule entry (kernels.Tiles in ops/kernels.py) and
// the staging of contiguous factor rows into shared memory.
//
// A schedule entry's ij word holds (row - its unit's row0) << IJ_SHIFT
// | col.  Staged rows keep a row stride rp = r | 1: an odd stride puts
// the same column of neighbouring rows in different banks, for f32
// words and for the two words of an f64 alike (K6 reads a column across
// rows; K5 reads along a row and keeps rp = r).  Unpadded whole rows
// are one contiguous span, copied 16 bytes at a time; other rows one
// element (4 or 8 bytes) per cp.async, so rows of any r need no 16-byte
// alignment (at r = 17 an f64 row is 136 bytes, 8-byte aligned only).

#pragma once
#include <cstdint>

#include <cuda_runtime.h>

namespace lt {

constexpr int IJ_SHIFT = 25;
constexpr int IJ_MASK = (1 << IJ_SHIFT) - 1;

__host__ __device__ inline int padded_stride(int r) { return r | 1; }

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

// columns [0, w) of rows [0, nrows) of the row-major array src (row
// stride ld) into dst at row stride rp, spread over the block's threads;
// asynchronous until stage_wait().  Where the rows are whole and
// unpadded (w == ld == rp) they are one contiguous span: 16-byte copies
// where src and dst are 16-byte aligned (the tail element by element),
// else one element a copy.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           int nrows, int w, int ld, int rp) {
  if (w == ld && rp == w &&
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0) {
    const int total = nrows * w;
    constexpr int V = 16 / sizeof(T);  // elements a 16-byte copy
    const int body = total / V;
    for (int e = threadIdx.x; e < body; e += blockDim.x)
      copy_async<16>(dst + e * V, src + e * V);
    for (int e = body * V + threadIdx.x; e < total; e += blockDim.x)
      copy_async<sizeof(T)>(dst + e, src + e);
  } else {
    const int total = nrows * w;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int row = e / w, c = e - row * w;
      copy_async<sizeof(T)>(dst + row * rp + c, src + (long)row * ld + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's staged copies have landed (a __syncthreads() after it
// makes every thread's visible)
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the dynamic shared memory of one kernel: beyond 48 KB its limit must
// be raised first, which each launch site does once a device through a
// static SmemLimit of its own (a race repeats the raise, nothing worse)
class SmemLimit {
 public:
  int allow(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err != 0) return err;
    if (dev < kDevices && raised_[dev] >= bytes) return 0;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == 0 && dev < kDevices) raised_[dev] = bytes;
    return err;
  }

 private:
  static constexpr int kDevices = 64;
  size_t raised_[kDevices] = {};
};

}  // namespace lt
