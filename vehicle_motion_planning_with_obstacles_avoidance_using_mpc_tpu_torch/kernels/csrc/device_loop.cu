// device_loop: one solve as one CUDA graph whose Newton iterations run
// under a conditional WHILE node, with no host read between the graph's
// launch and its results.
//
// Replaces: the host side of the JAX package's solver/ipm.py iterate_fn
// (:1369-1380), the lax.while_loop whose condition (it < cap) & ~done is
// evaluated on the device inside one XLA program. The port captures three
// pieces with PyTorch (solver/loop.py): the work before the loop (the
// initial state and the active flags), the body (one Newton iteration and
// ipm_freeze, which writes the any-active flag on the device) and the
// work after it (finalize, the multistart's pick). This file joins them
// into one graph:
//
//   pre (child) -> loop_start -> WHILE { body (child) -> loop_next } -> post (child)
//
// loop_start and loop_next are one-thread kernel nodes: each reads the
// flag the pre piece or the body's freeze left in device memory and sets
// the WHILE node's condition from it (cudaGraphSetConditional), so a call
// in which every lane starts done runs no iteration. loop_start zeroes
// the iteration count and loop_next adds one to it; the host reads the
// count with the results, once a call.
// Bound on this card: latency. The two kernels move 8 bytes an iteration
// and do no arithmetic; the loop's cost is the WHILE node's turn-around
// between iterations, which replaces a host round trip an iteration.
// Design: the graph is built once per input shape and static tag from the
// captured pieces' cudaGraph_t (torch.cuda.CUDAGraph(keep_graph=True)
// .raw_cuda_graph()), instantiated, and launched on the caller's stream.
// A child graph node copies the piece's topology, not its memory: the
// PyTorch graphs that own the pieces' memory must outlive the exec.
// Conditional nodes need CUDA 12.4 (the runtime and the driver); a
// runtime or driver without them, or a body holding a node type a WHILE
// body refuses, makes the build return an error, which the wrapper raises
// with the versions and the body's node types. Nothing falls back.
#include "common.cuh"

#if CUDART_VERSION < 12040
#error "device_loop.cu needs CUDA 12.4 or newer (conditional graph nodes)"
#endif

__global__ void loop_start(cudaGraphConditionalHandle handle, const int* flag, int* count) {
  *count = 0;
  cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

__global__ void loop_next(cudaGraphConditionalHandle handle, const int* flag, int* count) {
  *count += 1;
  cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

static cudaError_t add_flag_kernel(cudaGraphNode_t* node, cudaGraph_t g,
                                   const cudaGraphNode_t* deps, size_t ndeps, void* fn,
                                   cudaGraphConditionalHandle* handle, const int** flag,
                                   int** count) {
  void* args[3] = {handle, flag, count};
  cudaKernelNodeParams p = {};
  p.func = fn;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, g, deps, ndeps, &p);
}

// The runtime's and the driver's CUDA versions (e.g. 12040).
extern "C" int device_loop_versions(long long* out) {
  int rt = 0, drv = 0;
  cudaError_t e = cudaRuntimeGetVersion(&rt);
  if (e == cudaSuccess) e = cudaDriverGetVersion(&drv);
  out[0] = rt;
  out[1] = drv;
  out[2] = CUDART_VERSION;
  return int(e);
}

// Counts of the nodes of ``graph`` by type: out[t] for cudaGraphNodeType
// t < nout (the child graphs' nodes are counted in, not the child node).
static cudaError_t census(cudaGraph_t graph, long long* out, int nout) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, &n);
  if (e != cudaSuccess || n == 0) return e;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) break;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = census(child, out, nout);
    } else if (int(t) < nout) {
      out[int(t)] += 1;
    }
  }
  delete[] nodes;
  return e;
}

extern "C" int device_loop_census(void* graph, long long* out, int nout) {
  for (int i = 0; i < nout; ++i) out[i] = 0;
  return int(census(static_cast<cudaGraph_t>(graph), out, nout));
}

// Build and instantiate pre -> loop_start -> WHILE{body -> loop_next} ->
// post. ``pre`` and ``post`` may be null (no node); a null ``body`` gives
// pre -> post with no loop (a call with no lane to iterate). ``flag`` is
// the int32 any-active flag that pre and the body's freeze write,
// ``count`` an int32 the loop's iterations land in. Writes the exec to
// out[0]; returns 0 or a cudaError_t.
extern "C" int device_loop_build(void* pre, void* body, void* post, void* flag, void* count,
                                 void** out) {
  cudaGraph_t g = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t last = nullptr, node = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return int(e);
  const int* flag_p = static_cast<const int*>(flag);
  int* count_p = static_cast<int*>(count);
  auto chain = [&](cudaError_t r) {   // the node just added follows ``last``
    if (r == cudaSuccess) last = node;
    return r;
  };
  if (pre) e = chain(cudaGraphAddChildGraphNode(&node, g, nullptr, 0, static_cast<cudaGraph_t>(pre)));
  if (e == cudaSuccess && body) {
    cudaGraphConditionalHandle handle = 0;
    e = cudaGraphConditionalHandleCreate(&handle, g, 0, 0);
    if (e == cudaSuccess)
      e = chain(add_flag_kernel(&node, g, last ? &last : nullptr, last ? 1 : 0,
                                reinterpret_cast<void*>(loop_start), &handle, &flag_p, &count_p));
    cudaGraph_t body_graph = nullptr;
    if (e == cudaSuccess) {
      cudaGraphNodeParams cp = {};
      cp.type = cudaGraphNodeTypeConditional;
      cp.conditional.handle = handle;
      cp.conditional.type = cudaGraphCondTypeWhile;
      cp.conditional.size = 1;
      e = chain(cudaGraphAddNode(&node, g, &last, 1, &cp));
      body_graph = cp.conditional.phGraph_out[0];
    }
    cudaGraphNode_t body_node = nullptr, next_node = nullptr;
    if (e == cudaSuccess)
      e = cudaGraphAddChildGraphNode(&body_node, body_graph, nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
    if (e == cudaSuccess)
      e = add_flag_kernel(&next_node, body_graph, &body_node, 1,
                          reinterpret_cast<void*>(loop_next), &handle, &flag_p, &count_p);
  }
  if (e == cudaSuccess && post)
    e = chain(cudaGraphAddChildGraphNode(&node, g, last ? &last : nullptr, last ? 1 : 0,
                                         static_cast<cudaGraph_t>(post)));
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, g, 0);
  cudaGraphDestroy(g);
  if (e != cudaSuccess) {
    cudaGetLastError();   // a failed build leaves no error for the next launch to find
    return int(e);
  }
  out[0] = exec;
  return 0;
}

extern "C" int device_loop_launch(void* exec, void* stream) {
  return int(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                             static_cast<cudaStream_t>(stream)));
}

extern "C" int device_loop_destroy(void* exec) {
  return int(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
