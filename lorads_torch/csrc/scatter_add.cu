// P4 scatter_add: unsorted segment sum by vector reductions, behind a
// zeroing kernel that lets it start early.
//
// Replaces tools/probes/microbench_gather9.py fC: a serial
// read-modify-write loop that zeroes a VMEM-resident [n, r] output and
// adds K rows of values into it at unsorted ids, in one kernel (the TPU
// has no scatter unit, so it is one scalar loop on one core):
//
//   out[ids[k], :] += vals[k, :]            vals [K, r], out [n, r]
//
// The zeroing: a kernel of 16-byte stores that, as its first
// instruction, lets the next launch start (programmatic dependent
// launch, griddepcontrol).  The add kernel's blocks start beside it,
// load their first ids and values, and wait (griddepcontrol.wait) for
// the zeroing to complete before their first reduction: the add
// kernel's launch and first loads overlap the zeroing.  Measured on the
// H100 against the zeroing in the add kernel behind a grid-wide barrier
// (a cooperative launch), a cudaMemsetAsync node and torch.zeros, it was
// the fastest (PERF.md §6, PR 13).
//
// The adds: a thread takes a column group of V floats (V = 4: float4,
// where r % 4 == 0 and vals is 16-byte aligned; V = 2: float2 where r
// is even and vals 8-byte aligned; else 1) over G = 4 consecutive rows.
// It loads the G ids and the G value vectors at once (independent
// loads), sums in registers while the id repeats, and issues one vector
// reduction each time the id changes (atomicAdd(float4*),
// REDG.E.ADD.F32x4 on sm_90): on unsorted ids one reduction a (row,
// column group), a quarter of the scalar atomics at V = 4; on sorted
// ids the run length fewer again, so a hub of equal ids is no longer
// one atomic a value on r addresses.  The lanes of a warp run over (row
// chunk, column group), so each lane group reads its chunk's rows as
// one contiguous stretch.  The grid: the units' blocks, at most the
// blocks the SMs hold at once (occupancy queried once), with a
// grid-stride loop.  The order of the additions is not fixed, so the
// result may differ between runs in the last bits (held to 4 eps32 *
// sum |values| against the plain version's f64 sum).  G = 1 sums no
// runs (slower on sorted ids and hubs), G = 8 runs out of registers
// (PERF.md §6, PR 13).
//
// What bounds it: L2 traffic.  The values (K * r * 4 bytes) are read
// once, and on unsorted ids their reductions move as many bytes again
// into L2, where the output (n * r * 4 bytes) stays at the probes'
// shapes.  The bytes bound (values, ids and the output once, at
// 3.35 TB/s) counts neither the reductions' traffic nor the zeroing's
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int ZERO_THREADS = 256;
constexpr int ROWS = 4;  // G: the rows a thread sums

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float2& a, float2 b) {
  a.x += b.x; a.y += b.y;
}
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero_of<float2>() {
  return make_float2(0.f, 0.f);
}
template <> __device__ __forceinline__ float4 zero_of<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// out[0, count) = 0, 16-byte stores from a 16-byte aligned out.
__global__ void __launch_bounds__(ZERO_THREADS)
    zero_kernel(float* __restrict__ out, long count) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long tid = blockIdx.x * (long)blockDim.x + threadIdx.x;
  const long stride = gridDim.x * (long)blockDim.x;
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long i = tid; i < count / 4; i += stride)
    o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long i = count / 4 * 4 + tid; i < count; i += stride) out[i] = 0.f;
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    scatter_add_kernel(const float* __restrict__ vals,
                       const int* __restrict__ ids, float* __restrict__ out,
                       int K, int groups) {
  using T = typename Vec<V>::T;
  constexpr int G = ROWS;
  const T* v = reinterpret_cast<const T*>(vals);
  T* o = reinterpret_cast<T*>(out);
  const long units = (long)((K + G - 1) / G) * groups;
  const long stride = gridDim.x * (long)blockDim.x;
  int id[G];
  T x[G];
  auto load = [&](long u) {
    const long k0 = u / groups * G;
    const int c = (int)(u % groups);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const bool in = u < units && k0 + j < K;
      id[j] = in ? __ldg(ids + k0 + j) : -1;
      x[j] = in ? __ldg(v + (k0 + j) * groups + c) : zero_of<T>();
    }
  };
  const long first = blockIdx.x * (long)blockDim.x + threadIdx.x;
  load(first);
  // the zeroing kernel has completed and its stores are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (long u = first; u < units; u += stride) {
    if (u != first) load(u);
    const int c = (int)(u % groups);
    int cur = id[0];
    T acc = x[0];
#pragma unroll
    for (int j = 1; j < G; ++j) {
      if (id[j] == cur) {
        add_to(acc, x[j]);
      } else {
        if (cur >= 0) atomicAdd(o + (long)cur * groups + c, acc);
        cur = id[j];
        acc = x[j];
      }
    }
    if (cur >= 0) atomicAdd(o + (long)cur * groups + c, acc);
  }
}

// The add kernel over its units, at most the blocks the SMs hold at once
// (queried once), behind the zeroing (programmatic dependent launch).
template <int V>
int launch_adds(const float* vals, const int* ids, float* out, int K, int r,
                cudaStream_t s) {
  static int per_sm = 0;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err == 0 && per_sm == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_add_kernel<V>, THREADS, 0);
  if (err != 0) return err;
  const long units = (long)((K + ROWS - 1) / ROWS) * (r / V);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)std::min<long>(
      (units + THREADS - 1) / THREADS, (long)std::max(per_sm, 1) * sms));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, scatter_add_kernel<V>, vals, ids, out,
                                 K, r / V);
}

}  // namespace

// vals float32 [K, r] (r = 1: [K]); ids int32 [K] in [0, n); out float32
// [n, r], contiguous, 16-byte aligned, any contents.  Zeroes out, then
// adds, with the widest reductions r and the values' alignment allow.
// Returns the launches' error, or cudaErrorInvalidValue for an unaligned
// out.
extern "C" int lt_scatter_add(const void* vals, const void* ids, void* out,
                              int K, int n, int r, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long count = (long)n * r;
  if (count <= 0) return (int)cudaGetLastError();
  if (K < 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err != 0) return err;
  const long zero_blocks =
      std::min<long>((count / 4 + ZERO_THREADS - 1) / ZERO_THREADS, sms);
  zero_kernel<<<(unsigned)std::max<long>(zero_blocks, 1), ZERO_THREADS, 0,
                s>>>(static_cast<float*>(out), count);
  err = (int)cudaGetLastError();
  if (err != 0 || K == 0) return err;
  const float* v = static_cast<const float*>(vals);
  const int* id = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  const uintptr_t at = reinterpret_cast<uintptr_t>(vals);
  if (r % 4 == 0 && at % 16 == 0) return launch_adds<4>(v, id, o, K, r, s);
  if (r % 2 == 0 && at % 8 == 0) return launch_adds<2>(v, id, o, K, r, s);
  return launch_adds<1>(v, id, o, K, r, s);
}
