// Conditional nodes of CUDA graphs (CUDA >= 12.4): the loops whose exit
// the device decides (alg/devloop.py, ``nest``), the counterpart of
// lorads_tpu's nested ``lax.while_loop``s, and the branches inside them
// (``lax.cond``).
//
// lt_cond_begin is called while `stream` is being captured.  It creates a
// conditional handle in the graph being captured, captures a one-thread
// kernel that sets the handle from the device boolean `pred`, adds a WHILE
// (type 1) or IF (type 0) node after it, moves the stream's capture point
// past the node and starts capturing `child` into the node's body graph.
// The caller then issues the body on `child` and calls lt_cond_end, which
// captures the body's last kernel and ends the child's capture: for a WHILE
// node, the kernel that sets the handle from `pred` (the loop's exit test
// on its new state: the body runs again while it is nonzero); for an IF
// node, a kernel that only counts.  Either adds one to `counter` (int64 on
// the device, or null) each time the body runs, so that the host can count
// the body's launches from one read.
//
// Nodes nest: a body being captured on `child` may itself open a node on a
// second child stream.

#include <cuda_runtime.h>

namespace {

__global__ void cond_set_kernel(cudaGraphConditionalHandle handle,
                                const unsigned char* pred,
                                unsigned long long* counter) {
  if (counter != nullptr) *counter += 1;
  cudaGraphSetConditional(handle, (pred != nullptr && *pred) ? 1u : 0u);
}

__global__ void count_kernel(unsigned long long* counter) {
  if (counter != nullptr) *counter += 1;
}

// the error of a stream that is not being captured
constexpr int NOT_CAPTURING = 1000;

}  // namespace

extern "C" int lt_cond_begin(int is_while, const void* pred, void* child,
                             unsigned long long* handle_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                           &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return NOT_CAPTURING;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  cond_set_kernel<<<1, 1, 0, s>>>(
      handle, static_cast<const unsigned char*>(pred), nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(child), body,
                                    nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  *handle_out = handle;
  return 0;
}

extern "C" int lt_cond_end(int is_while, unsigned long long handle,
                           const void* pred, void* counter, void* child) {
  cudaStream_t c = static_cast<cudaStream_t>(child);
  unsigned long long* count = static_cast<unsigned long long*>(counter);
  if (is_while)
    cond_set_kernel<<<1, 1, 0, c>>>(
        handle, static_cast<const unsigned char*>(pred), count);
  else
    count_kernel<<<1, 1, 0, c>>>(count);
  cudaError_t e = cudaGetLastError();
  cudaGraph_t body;
  const cudaError_t e2 = cudaStreamEndCapture(c, &body);
  return (int)(e != cudaSuccess ? e : e2);
}
