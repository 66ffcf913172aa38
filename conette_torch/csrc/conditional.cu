// CUDA graph conditional nodes for the captured decode searches.
//
// The JAX package runs beam and greedy search as a lax.while_loop that
// leaves once no beam is alive (conette_tpu/decoding/beam.py, greedy.py).
// A CUDA graph has no loop that the host does not unroll, so the port
// captures the search as a chain of max_pred_size "if" nodes: node s holds
// step s and runs only while the continue flag that step s - 1 wrote is set.
// This file builds one such node inside a stream capture, through the CUDA
// runtime, as ATen/cuda/CUDAGraph.cpp does for torch.cond (which the
// card's torch may lack):
//
//   1. a conditional handle on the graph that the parent stream captures;
//   2. a one-thread kernel on the parent stream that sets the handle from
//      the flag (a bool in device memory) each time the graph runs;
//   3. an "if" node after it, which becomes the parent's only dependency;
//   4. the node's body graph captured from a second stream
//      (cudaStreamBeginCaptureToGraph), until conette_graph_if_end.
//
// The caller points its allocator at a memory pool that outlives the graph
// while the body is captured (conette_torch/graphs.py). Not a port
// of a TPU kernel: the kernel here moves one byte.

#include <cuda_runtime.h>

namespace {

constexpr int kNotCapturing = cudaErrorStreamCaptureUnmatched;

#if CUDART_VERSION >= 12040
__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, nullptr, n_deps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, n_deps);
#endif
}
#endif

}  // namespace

// The CUDA runtime this library was built against and the driver's, as
// CUDART_VERSION numbers (12040 for 12.4); conditional nodes need both at
// 12.4 or later.
extern "C" int conette_conditional_versions(int* runtime, int* driver) {
  *runtime = CUDART_VERSION;
  return cudaDriverGetVersion(driver);
}

// Open an "if" node on the flag in the graph that `parent` captures and
// start capturing its body from `child` (which must not be capturing).
extern "C" int conette_graph_if_begin(void* parent, void* child, const void* flag) {
#if CUDART_VERSION >= 12040
  cudaStream_t s = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = capture_info(s, &status, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return kNotCapturing;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = capture_info(s, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(child),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
#else
  return cudaErrorNotSupported;
#endif
}

// End the body's capture on `child`; the body stays owned by its node.
extern "C" int conette_graph_if_end(void* child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}

// A stream of its own for the bodies' captures (a pooled torch stream may
// be the parent's), which the caller wraps as a torch ExternalStream and
// keeps for the life of the process.
extern "C" int conette_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return err;
}
