// The frame graph: one CUDA graph per frame whose conditional (IF) nodes
// take the place of the reference's lax.cond branches
// (stereo_svo_tpu/engine/step.py: bootstrap or track, the keyframe phase,
// the online loop; the batched step's batch-level conds).
//
// It replaces no TPU kernel. The step's phases are captured by PyTorch as
// graphs of their own (engine/graphed.py); these entry points assemble
// them into one graph through the CUDA runtime: each phase becomes a
// child-graph node, those that run only on some frames inside the body of
// an IF node, and a one-block kernel node sets each IF node's handle from
// a device bool that the nodes before it wrote (cudaGraphSetConditional).
// The nodes form one chain in the order they are added, so a predicate
// written by an earlier node is read by a later one, and a frame is one
// graph launch with no host read. Conditional nodes need CUDA 12.4.
//
// Plain C interface (loaded with ctypes); every entry point returns a
// cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SET = 8;  // handles one set node writes

struct SetWork {
  cudaGraphConditionalHandle handle[MAX_SET];
  const bool* pred[MAX_SET];
  int n;
};

__global__ void set_conditionals_kernel(SetWork w) {
  const int i = threadIdx.x;
  if (i < w.n) cudaGraphSetConditional(w.handle[i], *w.pred[i] ? 1u : 0u);
}

// After a node was added with `*last` as its dependency: on success it is
// the chain's last node.
int append(cudaError_t err, cudaGraphNode_t node, void** last) {
  if (err == cudaSuccess) *last = node;
  return (int)err;
}

// The dependency list of a node added after `last` (none at the start).
size_t deps(void* const* last) { return *last ? 1 : 0; }

}  // namespace

extern "C" int svo_graph_create(void** graph) {
  return (int)cudaGraphCreate((cudaGraph_t*)graph, 0);
}

extern "C" int svo_graph_destroy(void* graph) {
  return (int)cudaGraphDestroy((cudaGraph_t)graph);
}

// A conditional handle of `graph`, reset to 0 at every launch.
extern "C" int svo_graph_cond_handle(void* graph,
                                     unsigned long long* handle) {
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(
      &h, (cudaGraph_t)graph, 0, cudaGraphCondAssignDefault);
  if (err == cudaSuccess) *handle = (unsigned long long)h;
  return (int)err;
}

// A child-graph node of `child` (cloned) after *last.
extern "C" int svo_graph_add_child(void* graph, void** last, void* child) {
  cudaGraphNode_t node = nullptr;
  const cudaGraphNode_t dep = (cudaGraphNode_t)*last;
  const cudaError_t err = cudaGraphAddChildGraphNode(
      &node, (cudaGraph_t)graph, &dep, deps(last), (cudaGraph_t)child);
  return append(err, node, last);
}

// An IF node on `handle` after *last, whose body is a child-graph node of
// `body` (cloned). Fails where the body holds a node kind that a
// conditional body may not (memory allocation or free, host, event).
extern "C" int svo_graph_add_if(void* graph, void** last,
                                unsigned long long handle, void* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  p.conditional.type = cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node = nullptr, inner = nullptr;
  const cudaGraphNode_t dep = (cudaGraphNode_t)*last;
  cudaError_t err = cudaGraphAddNode(&node, (cudaGraph_t)graph, &dep,
                                     deps(last), &p);
  if (err != cudaSuccess) return (int)err;
  err = cudaGraphAddChildGraphNode(&inner, p.conditional.phGraph_out[0],
                                   nullptr, 0, (cudaGraph_t)body);
  return append(err, node, last);
}

// A kernel node after *last that sets handles[i] to preds[i] (device bools)
// for i < n.
extern "C" int svo_graph_add_set(void* graph, void** last,
                                 const unsigned long long* handles,
                                 void* const* preds, int n) {
  if (n < 1 || n > MAX_SET) return (int)cudaErrorInvalidValue;
  SetWork w = {};
  for (int i = 0; i < n; ++i) {
    w.handle[i] = (cudaGraphConditionalHandle)handles[i];
    w.pred[i] = (const bool*)preds[i];
  }
  w.n = n;
  void* args[] = {&w};
  cudaKernelNodeParams k = {};
  k.func = (void*)set_conditionals_kernel;
  k.gridDim = dim3(1);
  k.blockDim = dim3(32);
  k.kernelParams = args;
  cudaGraphNode_t node = nullptr;
  const cudaGraphNode_t dep = (cudaGraphNode_t)*last;
  const cudaError_t err = cudaGraphAddKernelNode(
      &node, (cudaGraph_t)graph, &dep, deps(last), &k);
  return append(err, node, last);
}

extern "C" int svo_graph_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate((cudaGraphExec_t*)exec,
                                   (cudaGraph_t)graph, 0);
}

extern "C" int svo_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int svo_graph_exec_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}
