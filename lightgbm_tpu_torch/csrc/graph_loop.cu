// A tree of the device grower as one CUDA graph with a WHILE node per
// wave stage (ops/graphs.py builds it; ops/grow.py captures its pieces).
//
// The JAX package grows a tree inside `lax.while_loop`s, one per stage of
// the wave plan (lightgbm_tpu/ops/grow.py:1003-1012, `_grow_impl`), so the
// number of waves a tree takes is decided on the device.  Here every piece
// of a tree (its prologue, one wave of each stage, its epilogue) is
// captured by PyTorch into a graph of its own (`torch.cuda.CUDAGraph`,
// kept), and this file composes them into one graph:
//
//   prologue -> [set h1] -> WHILE h1 { wave(stage 1) -> [set h1] }
//            -> [set h2] -> WHILE h2 { wave(stage 2) -> [set h2] } ...
//            -> epilogue
//
// `set` is a one-thread kernel that reads the grower's control words on
// the device (`ctl[0]` the leaf count, `ctl[1]` the done flag) and sets
// the loop's condition to `!done && nl < limit`, the eager loop's test.
// The body of a loop is the stage's wave graph as a child graph node, so
// it is captured once whatever the number of waves the stage may take,
// and PyTorch's allocator sees one ordinary capture per piece.  Nothing
// is read back on the host: a launch of the composed graph grows a tree.
//
// Not a kernel port: the TPU has no counterpart (jax.jit composes the
// loops there).  What bounds it is the device-side loop overhead, one
// condition evaluation and one body launch a wave (measured by
// scripts/probe_graph_cuda.py).  Needs CUDA 12.4 or newer (conditional
// nodes); WHILE nodes and child graphs in their bodies are 12.4 features.

#include <cuda_runtime.h>

namespace {

__global__ void set_while_kernel(cudaGraphConditionalHandle handle,
                                 const int* ctl, int limit) {
  cudaGraphSetConditional(handle,
                          (ctl[1] == 0 && ctl[0] < limit) ? 1u : 0u);
}

cudaError_t add_set_node(cudaGraphNode_t* node, cudaGraph_t graph,
                         const cudaGraphNode_t* dep, size_t ndep,
                         cudaGraphConditionalHandle handle, const int* ctl,
                         int limit) {
  void* args[] = {&handle, &ctl, &limit};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_while_kernel);
  kp.gridDim = dim3(1, 1, 1);
  kp.blockDim = dim3(1, 1, 1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep, ndep, &kp);
}

}  // namespace

#define LOOP_CHECK(call)                                                   \
  do {                                                                     \
    cudaError_t e_ = (call);                                               \
    if (e_ != cudaSuccess) {                                               \
      cudaGraphDestroy(g);                                                 \
      return (int)e_;                                                      \
    }                                                                      \
  } while (0)

// Builds and instantiates the composed graph of `n` steps.  Step i runs
// the captured graph `pieces[i]` once (limits[i] < 0) or, as a WHILE
// loop, while `ctl[1] == 0 && ctl[0] < limits[i]`.  `ctl` is a device
// pointer to the grower's int32 control words.  On success writes the
// executable and the graph (both to be released with loop_graph_destroy)
// and returns 0; else the CUDA error code.
extern "C" int loop_graph_build(int n, void* const* pieces,
                                const int* limits, const void* ctl,
                                void** exec_out, void** graph_out) {
  cudaGraph_t g = nullptr;
  cudaError_t e0 = cudaGraphCreate(&g, 0);
  if (e0 != cudaSuccess) return (int)e0;
  const int* c = static_cast<const int*>(ctl);
  cudaGraphNode_t prev = nullptr;
  for (int i = 0; i < n; ++i) {
    cudaGraph_t piece = static_cast<cudaGraph_t>(pieces[i]);
    const cudaGraphNode_t* dep = prev ? &prev : nullptr;
    const size_t ndep = prev ? 1 : 0;
    if (limits[i] < 0) {
      cudaGraphNode_t node;
      LOOP_CHECK(cudaGraphAddChildGraphNode(&node, g, dep, ndep, piece));
      prev = node;
      continue;
    }
    cudaGraphConditionalHandle handle;
    LOOP_CHECK(cudaGraphConditionalHandleCreate(&handle, g, 0, 0));
    cudaGraphNode_t set0;
    LOOP_CHECK(add_set_node(&set0, g, dep, ndep, handle, c, limits[i]));
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    cudaGraphNode_t loop;
    LOOP_CHECK(cudaGraphAddNode(&loop, g, &set0, 1, &cp));
    cudaGraph_t body = cp.conditional.phGraph_out[0];
    cudaGraphNode_t wave, set1;
    LOOP_CHECK(cudaGraphAddChildGraphNode(&wave, body, nullptr, 0, piece));
    LOOP_CHECK(add_set_node(&set1, body, &wave, 1, handle, c, limits[i]));
    prev = loop;
  }
  cudaGraphExec_t exec = nullptr;
  LOOP_CHECK(cudaGraphInstantiate(&exec, g, 0));
  *exec_out = exec;
  *graph_out = g;
  return 0;
}

// Launches the composed graph on `stream` (no synchronization).
extern "C" int loop_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int loop_graph_destroy(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = e2;
  }
  return (int)e;
}
