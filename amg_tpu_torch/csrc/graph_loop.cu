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
//
// Also here, for the program's tracing (utils/tracing.py): trace_stamp, a
// one-thread kernel that writes (code, %globaltimer) into a device ring at
// an atomic index, so that spans captured into a graph's pieces carry
// their own device timings, the WHILE body included, which CUPTI does not
// record; and amg_graph_node_types, the node census of a captured graph.
// trace_stamp replaces no TPU kernel: its bound is one 16-byte write and
// an atomic, so its time is the launch latency inside the graph (about a
// microsecond); tracing is off by default and then no stamp is captured.

#include <cuda_runtime.h>

#include <mutex>
#include <unordered_map>
#include <vector>

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

// The body graph of each conditional node this library made, by node,
// while the graph that holds it lives: the runtime has no call that
// gives a conditional node's body back (node_types walks into it).
std::mutex bodies_mu;
std::unordered_map<cudaGraphNode_t, cudaGraph_t> bodies;
// the conditional nodes made for each assembled loop graph
std::unordered_map<cudaGraph_t, std::vector<cudaGraphNode_t>> conds_of;

void forget(const std::vector<cudaGraphNode_t>& conds) {
  std::lock_guard<std::mutex> lock(bodies_mu);
  for (cudaGraphNode_t c : conds) bodies.erase(c);
}

// A WHILE or IF node after `dep`; its body graph to *body, and the node
// to *made.
cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t g,
                            const cudaGraphNode_t* dep,
                            cudaGraphConditionalHandle h,
                            cudaGraphConditionalNodeType type,
                            cudaGraph_t* body,
                            std::vector<cudaGraphNode_t>* made) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type;
  p.conditional.size = 1;
  const cudaError_t e = cudaGraphAddNode(node, g, dep, dep ? 1 : 0, &p);
  if (e == cudaSuccess) {
    *body = p.conditional.phGraph_out[0];
    made->push_back(*node);
    std::lock_guard<std::mutex> lock(bodies_mu);
    bodies[*node] = *body;
  }
  return e;
}

cudaError_t add_child(cudaGraphNode_t* node, cudaGraph_t g,
                      const cudaGraphNode_t* dep, cudaGraph_t child) {
  return cudaGraphAddChildGraphNode(node, g, dep, dep ? 1 : 0, child);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ring: cap records of (code, time in ns); ctrl[0] the next index (it
// keeps counting past cap), ctrl[1] the stamps dropped for want of room.
__global__ void trace_stamp(unsigned long long* ring, unsigned int* ctrl,
                            unsigned int cap, unsigned long long code) {
  const unsigned long long t = globaltimer();
  const unsigned int i = atomicAdd(ctrl, 1u);
  if (i < cap) {
    ring[2 * (size_t)i] = code;
    ring[2 * (size_t)i + 1] = t;
  } else {
    atomicAdd(ctrl + 1, 1u);
  }
}

// One thread reads %globaltimer until it has changed n times: out[0] the
// least step seen, out[1] the whole stretch in ns.
__global__ void timer_steps(unsigned long long* out, int n) {
  const unsigned long long t0 = globaltimer();
  unsigned long long prev = t0, least = ~0ull;
  for (int changes = 0; changes < n;) {
    const unsigned long long t = globaltimer();
    if (t != prev) {
      if (t - prev < least) least = t - prev;
      prev = t;
      ++changes;
    }
  }
  out[0] = least;
  out[1] = prev - t0;
}

// Appends the types of every node of g to out, a child graph's or a
// conditional body's nodes after the node that holds them. The runtime
// answers cudaGraphNodeGetType for a conditional node with an error
// (runtime 12.9, driver 13.0, H100): a node this library made as one is
// known as conditional and walked into; another node whose type the
// runtime does not give is listed as -1.
cudaError_t walk(cudaGraph_t g, std::vector<int>* out, int depth) {
  if (depth > 16) return cudaErrorInvalidValue;
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess || n == 0) return e;
  std::vector<cudaGraphNode_t> nodes(n);
  e = cudaGraphGetNodes(g, nodes.data(), &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraph_t body = nullptr;
    {
      std::lock_guard<std::mutex> lock(bodies_mu);
      const auto it = bodies.find(nodes[i]);
      if (it != bodies.end()) body = it->second;
    }
    if (body != nullptr) {
      out->push_back((int)cudaGraphNodeTypeConditional);
      e = walk(body, out, depth + 1);
      continue;
    }
    cudaGraphNodeType t;
    if (cudaGraphNodeGetType(nodes[i], &t) != cudaSuccess) {
      cudaGetLastError();
      out->push_back(-1);
      continue;
    }
    out->push_back((int)t);
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = walk(child, out, depth + 1);
    }
  }
  return e;
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
  std::vector<cudaGraphNode_t> made;
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
  STEP(4, add_conditional(&c, g, &b, h_loop, cudaGraphCondTypeWhile, &w,
                          &made));
  STEP(5, add_child(&d, w, nullptr, (cudaGraph_t)body));
  if (refine != nullptr) {
    STEP(6, cudaGraphConditionalHandleCreate(&h_branch, w, 0, 0));
    STEP(7, add_condition(&e, w, &d, s, h_loop, h_branch, kStepIf));
    STEP(6, add_conditional(&f, w, &e, h_branch, cudaGraphCondTypeIf, &ib,
                            &made));
    STEP(8, add_child(&f, ib, nullptr, (cudaGraph_t)refine));
  } else {
    STEP(7, add_condition(&e, w, &d, s, h_loop, 0, kStep));
  }
  if (fin != nullptr) {
    STEP(9, cudaGraphConditionalHandleCreate(&h_fin, g, 0, 0));
    STEP(9, add_condition(&d, g, &c, s, 0, h_fin, kFinal));
    STEP(10, add_conditional(&c, g, &d, h_fin, cudaGraphCondTypeIf, &fb,
                             &made));
    STEP(11, add_child(&e, fb, nullptr, (cudaGraph_t)fin));
  }
  STEP(12, add_child(&a, g, &c, (cudaGraph_t)post));
  STEP(13, cudaGraphInstantiate(&x, g, 0));
  STEP(14, cudaGraphUpload(x, stream_));
#undef STEP
  *stage = -1;
  *graph_out = g;
  *exec_out = x;
  {
    std::lock_guard<std::mutex> lock(bodies_mu);
    conds_of[g] = made;
  }
  return 0;
fail:
  forget(made);
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
    std::vector<cudaGraphNode_t> made;
    {
      std::lock_guard<std::mutex> lock(bodies_mu);
      const auto it = conds_of.find((cudaGraph_t)graph);
      if (it != conds_of.end()) {
        made.swap(it->second);
        conds_of.erase(it);
      }
    }
    forget(made);
    const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = e2;
  }
  return (int)e;
}

// The node types (cudaGraphNodeType) of `graph` and of every child graph
// and conditional body in it, the first `cap` of them into `types`, and
// their number in *count (call with cap 0 for the count).
extern "C" int amg_graph_node_types(void* graph, int* types, int cap,
                                    int* count) {
  std::vector<int> all;
  const cudaError_t e = walk((cudaGraph_t)graph, &all, 0);
  *count = (int)all.size();
  for (size_t i = 0; i < all.size() && (int)i < cap; ++i) types[i] = all[i];
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// One stamp on `stream` (see trace_stamp).
extern "C" int amg_trace_stamp(void* ring, void* ctrl, int cap,
                               long long code, void* stream) {
  trace_stamp<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)ring, (unsigned int*)ctrl, (unsigned int)cap,
      (unsigned long long)code);
  return (int)cudaGetLastError();
}

// timer_steps on `stream` into out[2].
extern "C" int amg_timer_steps(void* out, int n, void* stream) {
  timer_steps<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)out,
                                                 n);
  return (int)cudaGetLastError();
}

// The driver's and this library's runtime version (12030 = 12.3).
extern "C" int amg_cuda_versions(int* driver, int* runtime) {
  cudaError_t e = cudaDriverGetVersion(driver);
  if (e == cudaSuccess) e = cudaRuntimeGetVersion(runtime);
  return (int)e;
}
