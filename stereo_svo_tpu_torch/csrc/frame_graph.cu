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
// Spans. A conditional body may hold no event node, so CUDA events cannot
// time a body; a one-thread stamp kernel node that reads %globaltimer
// can, at any level of the graph. The frame begins and ends with a stamp,
// and every body sits between an entry and an exit stamp: in the outer
// chain for a body every frame runs, inside the IF node's body graph for
// the others. The stamps write one int64 table a step (layout below, the
// same as the plain version's in engine/graphed.py): each body's runs and
// summed nanoseconds, and a ring of one row a frame. The frame-exit stamp
// advances the frame counter that picks the ring's row. A stamp costs one
// kernel node (about a microsecond of the chain's time).
//
// Stages and counters. A stage (a part of a body: the epipolar search,
// window BA) has a slot of the table as a body has; its stamps are
// launched inside the body's capture (svo_stamp on the capturing stream),
// so they are kernel nodes of the body's own graph. A counter stamp copies
// an int32 that an earlier node of the frame wrote into the frame's row.
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

// What a stamp does (engine/graphed.py: FRAME_START ... COUNT).
enum StampOp { FRAME_START = 0, BODY_START = 1, BODY_END = 2, FRAME_END = 3,
               CLOCK = 4, COUNT = 5 };

// The span table of a step with n slots (its bodies, then its stages) and
// c counters, int64:
//   runs[n] | ns[n] | frames | clock | start[n] | ring[ring][2 + 2n + c]
// A ring row: the frame's start and end, then each slot's nanoseconds in
// the frame and its start after the frame's start (0 where it did not
// run), then each counter's value in the frame (0 where none was written).
// The row of the frame that runs is frames % ring.
struct Stamp {
  long long* table;
  int op, body, n, ring, counts;
  const int* src;  // COUNT: the int32 that counter `body` takes
};

__global__ void stamp_kernel(Stamp s) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* t = s.table;
  const int n = s.n, width = 2 + 2 * n + s.counts;
  long long* runs = t;
  long long* ns = t + n;
  long long* frames = t + 2 * n;
  long long* start = t + 2 * n + 2;
  long long* row = t + 3 * n + 2 + (*frames % s.ring) * width;
  switch (s.op) {
    case FRAME_START:
      row[0] = now;
      for (int i = 1; i < width; ++i) row[i] = 0;
      break;
    case BODY_START:
      start[s.body] = now;
      break;
    case BODY_END: {
      const long long d = now - start[s.body];
      runs[s.body] += 1;
      ns[s.body] += d;
      row[2 + s.body] = d;
      row[2 + n + s.body] = start[s.body] - row[0];
      break;
    }
    case FRAME_END:
      row[1] = now;
      *frames += 1;
      break;
    case COUNT:
      row[2 + 2 * n + s.body] = *s.src;
      break;
    default:  // CLOCK: the timer alone, for the clock's calibration
      t[2 * n + 1] = now;
  }
}

// After a node was added with `*last` as its dependency: on success it is
// the chain's last node.
int append(cudaError_t err, cudaGraphNode_t node, void** last) {
  if (err == cudaSuccess) *last = node;
  return (int)err;
}

// The dependency list of a node added after `last` (none at the start).
size_t deps(void* const* last) { return *last ? 1 : 0; }

// A stamp kernel node in `graph` after *last.
int add_stamp(cudaGraph_t graph, void** last, Stamp s) {
  void* args[] = {&s};
  cudaKernelNodeParams k = {};
  k.func = (void*)stamp_kernel;
  k.gridDim = dim3(1);
  k.blockDim = dim3(1);
  k.kernelParams = args;
  cudaGraphNode_t node = nullptr;
  const cudaGraphNode_t dep = (cudaGraphNode_t)*last;
  const cudaError_t err = cudaGraphAddKernelNode(&node, graph, &dep,
                                                 deps(last), &k);
  return append(err, node, last);
}

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

// A stamp node (op, body; see Stamp) of the table `table` after *last.
extern "C" int svo_graph_add_stamp(void* graph, void** last, void* table,
                                   int op, int body, int n, int ring,
                                   int counts) {
  return add_stamp((cudaGraph_t)graph, last,
                   Stamp{(long long*)table, op, body, n, ring, counts,
                         nullptr});
}

// One stamp launched on `stream`: the calibration's CLOCK, or, inside a
// body's capture, a stage's entry or exit or a counter (`src`).
extern "C" int svo_stamp(void* table, int op, int body, int n, int ring,
                         int counts, const void* src, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      Stamp{(long long*)table, op, body, n, ring, counts, (const int*)src});
  return (int)cudaGetLastError();
}

// An IF node on `handle` after *last, whose body graph is a chain: body
// `body`'s entry stamp, a child-graph node of `child` (cloned), its exit
// stamp. Fails where the child holds a node kind that a conditional body
// may not (memory allocation or free, host, event).
extern "C" int svo_graph_add_if(void* graph, void** last,
                                unsigned long long handle, void* child,
                                void* table, int body, int n, int ring,
                                int counts) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  p.conditional.type = cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
  const cudaGraphNode_t dep = (cudaGraphNode_t)*last;
  const cudaError_t err = cudaGraphAddNode(&node, (cudaGraph_t)graph, &dep,
                                           deps(last), &p);
  if (err != cudaSuccess) return (int)err;
  const cudaGraph_t inside = p.conditional.phGraph_out[0];
  void* chain = nullptr;
  int rc = add_stamp(inside, &chain,
                     Stamp{(long long*)table, BODY_START, body, n, ring,
                           counts, nullptr});
  if (!rc) {
    cudaGraphNode_t inner = nullptr;
    const cudaGraphNode_t after = (cudaGraphNode_t)chain;
    const cudaError_t e = cudaGraphAddChildGraphNode(&inner, inside, &after,
                                                     1, (cudaGraph_t)child);
    rc = append(e, inner, &chain);
  }
  if (!rc)
    rc = add_stamp(inside, &chain,
                   Stamp{(long long*)table, BODY_END, body, n, ring, counts,
                         nullptr});
  if (!rc) *last = node;
  return rc;
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
