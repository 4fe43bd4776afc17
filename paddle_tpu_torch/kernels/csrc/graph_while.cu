// Conditional nodes (IF and WHILE) for CUDA graphs captured by torch
// (paddle_tpu_torch/kernels/graph_while.py).
//
// A conditional node runs its body graph when (IF), or as long as
// (WHILE, checked before every iteration), its condition handle is
// nonzero. The handle is set by a one-thread kernel that reads a device
// bool: upstream of the node, and for WHILE again at the end of every
// iteration, from the predicate the body recomputed. Each run of that
// kernel adds one to its node kind's launch count, a device global read
// and reset from the host. A body is captured from a second stream
// straight into the node's body graph; torch's allocator serves its
// allocations from a memory pool of its own that the parent graph keeps
// (graph_while.py), since its capture is not the graph's.
//
// Plain C entry points (bound with ctypes), each returning a
// cudaError_t; CUDA >= 12.4 (conditional nodes).
#include <cuda_runtime.h>

namespace {

// runs of set_condition_kernel by node kind (0: IF, 1: WHILE)
__device__ unsigned long long launch_counts[2];

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred, int kind) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
  atomicAdd(&launch_counts[kind], 1ull);
}

cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr,
                                  ndeps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, ndeps);
#endif
}

}  // namespace

extern "C" {

const char* graph_while_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int graph_while_versions(int* driver, int* runtime) {
  cudaError_t e = cudaDriverGetVersion(driver);
  if (e != cudaSuccess) return e;
  return cudaRuntimeGetVersion(runtime);
}

// The current device's launch counts of set_condition_kernel (IF, WHILE)
// into counts[2]; with reset, sets them to 0 after reading. Synchronous:
// call outside a capture.
int graph_while_launch_counts(unsigned long long* counts, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(counts, launch_counts,
                                       sizeof(launch_counts));
  if (e != cudaSuccess || !reset) return e;
  const unsigned long long zeros[2] = {0, 0};
  return cudaMemcpyToSymbol(launch_counts, zeros, sizeof(zeros));
}

// `stream` is capturing. Adds, on its current dependencies, the kernel
// that sets a new condition handle from *pred, then a conditional node
// (kind 0: IF, 1: WHILE) over that handle; the node becomes the stream's
// only dependency. Returns the node's body graph and the handle.
int graph_cond_begin(void* stream, const bool* pred, int kind,
                     void** body_out, unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t e = capture_info(s, &status, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  set_condition_kernel<<<1, 1, 0, s>>>(handle, pred, kind == 1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = capture_info(s, &status, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return e;
  *body_out = params.conditional.phGraph_out[0];
  *handle_out = handle;
  return cudaSuccess;
}

// Starts capturing `stream` (idle) into `body` (a conditional node's
// body graph).
int graph_cond_capture_body(void* stream, void* body) {
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(body),
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

// Ends a body's capture; for a WHILE body (`pred` not null) first the
// kernel that sets the handle from *pred, the predicate the iteration
// recomputed.
int graph_cond_end_body(void* stream, unsigned long long handle,
                        const bool* pred) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (pred != nullptr) {
    set_condition_kernel<<<1, 1, 0, s>>>(handle, pred, 1);
    e = cudaGetLastError();
  }
  cudaGraph_t graph;
  cudaError_t end = cudaStreamEndCapture(s, &graph);
  return e != cudaSuccess ? e : end;
}

}  // extern "C"
