// The device loop: JAX's lax.while_loop (and the lax.cond inside the packed
// solve loop) as one instantiated CUDA graph with conditional nodes.
//
// Counterpart of the one-program solve loops of amg_tpu/structured.py
// (solve_loop_f64 :842-881, solve_loop_df32 :885-933, solve_core_packed
// :962-1058) and amg_tpu/krylov.py _pcg_device (:97-158). It replaces no
// TPU kernel: on the TPU the loop control is XLA's while op, which the
// graph's WHILE node and the condition kernel below take over.
//
// The loop bodies are captured by PyTorch (one CUDA graph each, sharing
// one memory pool) and placed here as child-graph nodes:
//
//   pre -> start -> WHILE { body -> step [-> IF { refine }] }
//       [-> final -> IF { fin }] -> post
//
// `start`, `step` and `final` are launches of loop_condition, one thread:
// it reads the loop state (err, tol_eff, it, n) from device memory and
// sets the conditional handles. Bound: a few dozen bytes and a compare,
// so its time is the launch latency inside the graph (about a
// microsecond); the host loop it replaces waits for a device-to-host
// read on every pass.
//
// Modes (the state is err f64, tol f64, it int32, n int32):
//   start:   loop = err > tol && it < n          (JAX's first cond)
//   step:    it += 1; loop = err > tol && it < n (solve_loop_*, PCG: every
//            pass refines)
//   step_if: did = err > tol; it += did; branch = did;
//            loop = did && it < n                (solve_core_packed: a
//            converged pass runs the residual only)
//   final:   branch = err > tol                  (the packed loop's
//            lax.cond: recompute the rss only on budget exhaustion)
// A NaN err compares false, as in JAX, and ends the loop.
//
// execs counts, for the launch counters, the replays (start), the passes
// (step), the refining passes and the final recomputations.
//
// Conditional nodes need CUDA 12.3 in both the toolkit and the driver;
// amg_cuda_versions reports both.

#include <cuda_runtime.h>

namespace {

enum Mode : int { kStart = 0, kStep = 1, kStepIf = 2, kFinal = 3 };

__global__ void loop_condition(const double* err, const double* tol,
                               int* it, const int* n,
                               unsigned long long* execs,
                               cudaGraphConditionalHandle loop,
                               cudaGraphConditionalHandle branch, int mode) {
  const bool above = *err > *tol;
  int i = *it;
  if (mode == kStart) {
    execs[0] += 1;
    cudaGraphSetConditional(loop, above && i < *n);
    return;
  }
  if (mode == kFinal) {
    execs[3] += above;
    cudaGraphSetConditional(branch, above);
    return;
  }
  const int did = mode == kStepIf ? (int)above : 1;
  i += did;
  *it = i;
  execs[1] += 1;
  execs[2] += did;
  if (mode == kStepIf) cudaGraphSetConditional(branch, did);
  cudaGraphSetConditional(loop, above && i < *n);
}

struct State {
  const double* err;
  const double* tol;
  int* it;
  const int* n;
  unsigned long long* execs;
};

cudaError_t add_condition(cudaGraphNode_t* node, cudaGraph_t g,
                          const cudaGraphNode_t* dep, State s,
                          cudaGraphConditionalHandle loop,
                          cudaGraphConditionalHandle branch, int mode) {
  void* args[] = {&s.err, &s.tol, &s.it, &s.n, &s.execs, &loop, &branch,
                  &mode};
  cudaKernelNodeParams p = {};
  p.func = (void*)loop_condition;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &p);
}

// A WHILE or IF node after `dep`; its body graph to *body.
cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t g,
                            const cudaGraphNode_t* dep,
                            cudaGraphConditionalHandle h,
                            cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type;
  p.conditional.size = 1;
  const cudaError_t e = cudaGraphAddNode(node, g, dep, dep ? 1 : 0, &p);
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

cudaError_t add_child(cudaGraphNode_t* node, cudaGraph_t g,
                      const cudaGraphNode_t* dep, cudaGraph_t child) {
  return cudaGraphAddChildGraphNode(node, g, dep, dep ? 1 : 0, child);
}

}  // namespace

// Assemble and instantiate the loop graph from the captured pieces (each a
// cudaGraph_t; refine and fin may be null: without refine every pass of
// body refines, without fin the post piece recomputes what it needs).
// The pieces are cloned into the graph, which is built and instantiated on
// card `dev`. On failure returns the CUDA error and the number of the step
// that failed in *stage (0 selecting the card, 1 the outer graph,
// 2 pre, 3 start, 4 WHILE, 5 body, 6 IF, 7 step, 8 refine, 9 final
// condition, 10 final IF, 11 fin, 12 post, 13 instantiate, 14 the upload
// to the card on `stream`, so the first launch does not pay it).
extern "C" int amg_loop_graph(int dev, void* pre, void* body,
                              void* refine, void* fin, void* post,
                              const double* err,
                              const double* tol, int* it, const int* n,
                              unsigned long long* execs, void* stream,
                              void** graph_out, void** exec_out,
                              int* stage) {
  const State s = {err, tol, it, n, execs};
  cudaGraph_t g = nullptr, w = nullptr, ib = nullptr, fb = nullptr;
  cudaGraphExec_t x = nullptr;
  cudaGraphNode_t a, b, c, d, e, f;
  const cudaStream_t stream_ = (cudaStream_t)stream;
  cudaGraphConditionalHandle h_loop = 0, h_branch = 0, h_fin = 0;
  cudaError_t err_ = cudaSuccess;
  *graph_out = nullptr;
  *exec_out = nullptr;
#define STEP(k, call)        \
  do {                       \
    *stage = (k);            \
    err_ = (call);           \
    if (err_ != cudaSuccess) \
      goto fail;             \
  } while (0)
  STEP(0, cudaSetDevice(dev));
  STEP(1, cudaGraphCreate(&g, 0));
  STEP(2, add_child(&a, g, nullptr, (cudaGraph_t)pre));
  STEP(3, cudaGraphConditionalHandleCreate(&h_loop, g, 0, 0));
  STEP(3, add_condition(&b, g, &a, s, h_loop, 0, kStart));
  STEP(4, add_conditional(&c, g, &b, h_loop, cudaGraphCondTypeWhile, &w));
  STEP(5, add_child(&d, w, nullptr, (cudaGraph_t)body));
  if (refine != nullptr) {
    STEP(6, cudaGraphConditionalHandleCreate(&h_branch, w, 0, 0));
    STEP(7, add_condition(&e, w, &d, s, h_loop, h_branch, kStepIf));
    STEP(6, add_conditional(&f, w, &e, h_branch, cudaGraphCondTypeIf, &ib));
    STEP(8, add_child(&f, ib, nullptr, (cudaGraph_t)refine));
  } else {
    STEP(7, add_condition(&e, w, &d, s, h_loop, 0, kStep));
  }
  if (fin != nullptr) {
    STEP(9, cudaGraphConditionalHandleCreate(&h_fin, g, 0, 0));
    STEP(9, add_condition(&d, g, &c, s, 0, h_fin, kFinal));
    STEP(10, add_conditional(&c, g, &d, h_fin, cudaGraphCondTypeIf, &fb));
    STEP(11, add_child(&e, fb, nullptr, (cudaGraph_t)fin));
  }
  STEP(12, add_child(&a, g, &c, (cudaGraph_t)post));
  STEP(13, cudaGraphInstantiate(&x, g, 0));
  STEP(14, cudaGraphUpload(x, stream_));
#undef STEP
  *stage = -1;
  *graph_out = g;
  *exec_out = x;
  return 0;
fail:
  if (x != nullptr) cudaGraphExecDestroy(x);
  if (g != nullptr) cudaGraphDestroy(g);
  cudaGetLastError();  // the kernels' launch checks read the last error
  return (int)err_;
}

extern "C" int amg_loop_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int amg_loop_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph != nullptr) {
    const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = e2;
  }
  return (int)e;
}

// The node types (cudaGraphNodeType) of `graph`, at most `cap` of them, and
// their number in *count: what a refused piece holds.
extern "C" int amg_graph_node_types(void* graph, int* types, int cap,
                                    int* count) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *count = (int)n;
  if (e != cudaSuccess || n == 0) return (int)e;
  cudaGraphNode_t nodes[4096];
  size_t m = n < 4096 ? n : 4096;
  e = cudaGraphGetNodes((cudaGraph_t)graph, nodes, &m);
  for (size_t i = 0; e == cudaSuccess && i < m && (int)i < cap; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    types[i] = (int)t;
  }
  return (int)e;
}

// The driver's and this library's runtime version (12030 = 12.3).
extern "C" int amg_cuda_versions(int* driver, int* runtime) {
  cudaError_t e = cudaDriverGetVersion(driver);
  if (e == cudaSuccess) e = cudaRuntimeGetVersion(runtime);
  return (int)e;
}
