// The block loop — one launch a block of engine steps.
//
// Replaces: the `lax.while_loop(cond, step)` of `_run_impl` and its `cond`
// (stateright_tpu/parallel/wavefront.py:701-710, :748-751), which XLA
// compiles into one device program a block.  The port's step is a few
// hundred to a few thousand PyTorch operations and hand-written kernels
// issued from Python; issued op by op, a block costs the host 12-26 us an
// operation and runs every step after the stop as a no-op.  Here the
// engine captures its step once into a CUDA graph (torch's capture, on a
// side stream), and this file wraps that graph in a conditional WHILE
// node:
//
//   [cond, reset] -> WHILE(handle) { step (child graph) -> [cond] }
//
// `srt_block_cond` is the cond: one thread reads the carry's status,
// head, tail, unique count, discoveries and checked error word, and the
// device iteration counter `k`; it evaluates JAX's `cond` (status OK,
// `k < steps`, a non-empty queue, a property still undiscovered, the
// target not reached, no failed check), writes `k + go` back and sets the
// WHILE node's condition to `go`.  No step runs after it turns false, and
// `k` ends as the number of steps the block executed.  The first node
// resets `k` to 0, so every launch of the graph is one block.
//
// Bound on an H100: latency.  The kernel moves a few dozen bytes; what it
// saves is the host's issue of every operation of every step.  Its cost
// is one single-thread launch a step inside the graph.
//
// Conditional nodes need CUDA 12.3: nvcc 12.3 or newer, and an NVIDIA
// kernel module of release 545 or newer.
#include <cuda_runtime.h>
#include <cstdint>

#if CUDART_VERSION < 12030
#error "block_loop.cu needs CUDA 12.3 or newer (conditional graph nodes)"
#endif

namespace {

struct CondArgs {
  const long long* head;
  const long long* tail;
  const long long* unique;
  const long long* status;
  const long long* disc;  // n_disc words; n_disc 0: the model has no property
  const bool* err;        // null: not under .checked()
  long long target;       // < 0: no target
  long long steps;
  long long* k;           // the block's iteration counter
  unsigned char* go_out;  // null inside a graph
  int n_disc;
  int reset;              // 1: the first evaluation of a block (k = 0)
  cudaGraphConditionalHandle handle;  // 0 outside a graph
};

__global__ void srt_block_cond_kernel(CondArgs a) {
  const long long k = a.reset ? 0 : *a.k;
  bool go = *a.status == 0 && *a.tail > *a.head && k < a.steps;
  if (a.n_disc > 0) {
    bool all = true;
    for (int i = 0; i < a.n_disc; ++i) all = all && a.disc[i] != 0;
    go = go && !all;
  }
  if (a.target >= 0) go = go && *a.unique < a.target;
  if (a.err != nullptr) go = go && !*a.err;
  *a.k = k + (go ? 1 : 0);
  if (a.go_out != nullptr) *a.go_out = go ? 1 : 0;
  if (a.handle != 0) cudaGraphSetConditional(a.handle, go ? 1u : 0u);
}

CondArgs make_args(void* head, void* tail, void* unique, void* status,
                   void* disc, int n_disc, void* err, long long target,
                   long long steps, void* k) {
  CondArgs a{};
  a.head = static_cast<const long long*>(head);
  a.tail = static_cast<const long long*>(tail);
  a.unique = static_cast<const long long*>(unique);
  a.status = static_cast<const long long*>(status);
  a.disc = static_cast<const long long*>(disc);
  a.n_disc = n_disc;
  a.err = static_cast<const bool*>(err);
  a.target = target;
  a.steps = steps;
  a.k = static_cast<long long*>(k);
  return a;
}

cudaError_t add_cond(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* dep, size_t ndep, CondArgs a) {
  void* params[] = {&a};
  cudaKernelNodeParams kp{};
  kp.func = reinterpret_cast<void*>(srt_block_cond_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = params;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep, ndep, &kp);
}

}  // namespace

// One evaluation outside a graph (the card tests and chip_smoke.py hold
// it against the plain version): `go_out` gets the verdict, `k` the
// counter after it.
extern "C" int srt_block_cond(void* head, void* tail, void* unique,
                              void* status, void* disc, int n_disc, void* err,
                              long long target, long long steps, void* k,
                              int reset, void* go_out, void* stream) {
  CondArgs a = make_args(head, tail, unique, status, disc, n_disc, err,
                         target, steps, k);
  a.reset = reset;
  a.go_out = static_cast<unsigned char*>(go_out);
  srt_block_cond_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The block graph around a captured step graph `step` (cloned into the
// WHILE body as a child graph; the caller keeps its own).  Writes the
// graph, its instantiation and the step graph's node count.
extern "C" int srt_block_graph_create(void* step, void* head, void* tail,
                                      void* unique, void* status, void* disc,
                                      int n_disc, void* err, long long target,
                                      long long steps, void* k,
                                      void** graph_out, void** exec_out,
                                      long long* nodes_out) {
  cudaGraph_t graph = nullptr, body = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t first = nullptr, loop = nullptr, child = nullptr,
                  again = nullptr;
  cudaGraphConditionalHandle handle = 0;
  cudaGraphNodeParams wp{};
  size_t nodes = 0;
  CondArgs a = make_args(head, tail, unique, status, disc, n_disc, err,
                         target, steps, k);
  cudaError_t e = cudaGraphGetNodes(static_cast<cudaGraph_t>(step), nullptr,
                                    &nodes);
  if (e == cudaSuccess) e = cudaGraphCreate(&graph, 0);
  if (e == cudaSuccess) e = cudaGraphConditionalHandleCreate(&handle, graph,
                                                             0, 0);
  if (e == cudaSuccess) {
    a.handle = handle;
    a.reset = 1;
    e = add_cond(&first, graph, nullptr, 0, a);
  }
  if (e == cudaSuccess) {
    wp.type = cudaGraphNodeTypeConditional;
    wp.conditional.handle = handle;
    wp.conditional.type = cudaGraphCondTypeWhile;
    wp.conditional.size = 1;
#if CUDART_VERSION >= 13000
    e = cudaGraphAddNode(&loop, graph, &first, nullptr, 1, &wp);
#else
    e = cudaGraphAddNode(&loop, graph, &first, 1, &wp);
#endif
  }
  if (e == cudaSuccess) {
    body = wp.conditional.phGraph_out[0];
    e = cudaGraphAddChildGraphNode(&child, body, nullptr, 0,
                                   static_cast<cudaGraph_t>(step));
  }
  if (e == cudaSuccess) {
    a.reset = 0;
    e = add_cond(&again, body, &child, 1, a);
  }
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, graph, 0);
  if (e != cudaSuccess) {
    if (graph != nullptr) cudaGraphDestroy(graph);
    cudaGetLastError();  // a failed graph call is not sticky: clear it
    return (int)e;
  }
  *graph_out = graph;
  *exec_out = exec;
  *nodes_out = (long long)nodes;
  return 0;
}

extern "C" int srt_block_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int srt_block_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    const cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = f;
  }
  return (int)e;
}
