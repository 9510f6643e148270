// The collectives of the distributed solvers' blocks inside a CUDA graph:
// the port's own kernel, in K7's peer style (halo.cu). It replaces no TPU
// kernel: on the TPU, JAX's shard_map program runs psum, all_gather and
// the ppermute of the one-row halos as XLA collectives inside its while
// loop (amg_tpu/parallel/structured_dist.py _vcycle_local, pcg_fn,
// solve_fn). Here the K blocks are the threads of one process (a card
// group, on one card or several; parallel/launch.py CardGroup), the
// processes of a process group, or both, and the host collectives between
// them (events, copies, a host barrier, torch.distributed) cannot live in
// a graph: a conditional node's body holds kernels of one device and no
// event nodes. So one kernel moves the bytes:
//
//   gather: every block's payload (nbytes, the same on every block) to
//           every block, out (K, nbytes) in block order -- all_gather_slabs,
//           and the edge rows of launch.edges (each block's first and last
//           rows, from which a block assembles its strips);
//   sum:    the K payloads (f32 or f64 elements) added in block order,
//           out = ((p0 + p1) + p2) + ..., the same operations on the same
//           values on every block -- launch.psum, so every block's
//           condition kernel reads the same bits and takes the same passes.
//
// Each block owns one allocation (launch.GroupCollectives), which the other
// blocks address (the same card, another with peer access, or another
// process's allocation mapped through CUDA IPC; the flags' system scope
// holds across all three):
//
//   slots   [2][K][cap]  by epoch parity s, then the block that put there;
//   flags   [K][cap / kChunk]  by source block and chunk: the epoch of the
//                        last chunk that block put here;
//   counter [2]          the epoch, and the count of finished CTAs.
//
// One launch is one epoch e = counter + 1, read from device memory and
// advanced by the launch's last CTA, never a kernel argument, so a CUDA
// graph of collectives replays right. CTA c takes chunks c, c + grid, ...
// (kChunk bytes each): (1) it puts each of its chunks into slot (e & 1,
// k) of every other block and fences at system scope; (2) after the CTA's
// barrier, one thread stores e into that block's flag (k, chunk) (release,
// system scope); (3) for each chunk it waits for its own flags (q, chunk)
// of every other block q to reach e (acquire, system scope), bounded by
// %globaltimer; (4) it reads the chunk of every block (its own from src)
// into out, or adds them into out in block order. A CTA waits only on the
// other blocks' CTAs of the same chunk, never on a CTA of its own launch,
// and the grid is at most kMaxGrid CTAs, so the waiting CTAs of K launches
// always fit on the card beside the work that feeds them.
//
// Slot reuse, as K7's: a put at epoch e writes slot parity e & 1, last
// read by the other block at epoch e - 2. This launch follows, on its
// stream, launch e - 1, whose chunk 0 waited for that block's flag of
// epoch e - 1, stored in its launch e - 1, which follows its launch e - 2
// on its stream. So every block runs the same collectives in the same
// order with the same sizes (the distributed solvers' programs are the
// same on every block); then flags may run ahead (reached(f, e) compares
// as (int)(f - e) >= 0) and epochs may wrap.
//
// A wait that times out writes 1 and its epoch into the status words (host
// memory the device writes); the launch's other waits end by the same
// bound and later launches skip their waits once the status is set, so a
// lost block costs one timeout. The solve raises on the status after the
// graph (launch.GroupCollectives.check).
//
// Bound: the bytes put, (K - 1) nbytes a block (sum: (K - 1) elements),
// and the bytes read, K nbytes, at the device memory's rate (over NVLink
// between cards); a psum moves bytes of 8 and is the round trip of a flag.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;  // bytes behind one flag
constexpr int kMaxGrid = 16;
constexpr int kMaxBlocks = 8;

enum Mode : int { kGather = 0, kSumF32 = 1, kSumF64 = 2 };

struct Args {
  const uint32_t* src;
  void* out;
  long long nbytes, cap, timeout_ns;
  int k, K, mode;
  volatile int* status;
  char* bases[kMaxBlocks];
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool reached(unsigned f, unsigned e) {
  return (int)(f - e) >= 0;
}

// true once *flag reaches epoch e; false after timeout_ns, or at once when
// an earlier wait of this block has timed out
__device__ bool wait_epoch(unsigned* flag, unsigned e, long long timeout_ns,
                           volatile int* status) {
  cuda::atomic_ref<unsigned, cuda::thread_scope_system> f(*flag);
  if (reached(f.load(cuda::memory_order_acquire), e)) return true;
  if (status[0]) return false;
  const unsigned long long t0 = global_ns();
  for (;;) {
    __nanosleep(64);
    if (reached(f.load(cuda::memory_order_acquire), e)) return true;
    if ((long long)(global_ns() - t0) > timeout_ns) {
      status[1] = (int)e;
      __threadfence_system();
      status[0] = 1;
      __threadfence_system();
      return false;
    }
  }
}

__device__ __forceinline__ uint32_t* slot(const Args& a, int owner, int s,
                                          int from) {
  return reinterpret_cast<uint32_t*>(a.bases[owner] +
                                     ((long long)s * a.K + from) * a.cap);
}

__device__ __forceinline__ unsigned* flags_of(const Args& a, int owner) {
  return reinterpret_cast<unsigned*>(a.bases[owner] + 2LL * a.K * a.cap);
}

template <typename T>
__device__ void add_chunk(const Args& a, int s, long long lo, long long hi) {
  const T* mine = reinterpret_cast<const T*>(a.src);
  T* out = reinterpret_cast<T*>(a.out);
  for (long long i = lo / (long long)sizeof(T) + threadIdx.x;
       i < hi / (long long)sizeof(T); i += kThreads) {
    T t = 0;
    for (int q = 0; q < a.K; ++q) {
      const T v = q == a.k
          ? mine[i]
          : __ldcg(reinterpret_cast<const T*>(slot(a, a.k, s, q)) + i);
      t = q == 0 ? v : t + v;
    }
    out[i] = t;
  }
}

__global__ void __launch_bounds__(kThreads) peer_collective_kernel(
    const Args a) {
  const long long chunks_cap = a.cap / kChunk;
  unsigned* mine = flags_of(a, a.k);
  unsigned* counter = mine + a.K * chunks_cap;
  const unsigned e = *counter + 1;
  const int s = e & 1u;
  const long long chunks = (a.nbytes + kChunk - 1) / kChunk;
  // (1) put
  for (long long x = blockIdx.x; x < chunks; x += gridDim.x) {
    const long long lo = x * kChunk / 4;
    const long long hi = min(a.nbytes, (x + 1) * kChunk) / 4;
    for (long long w = lo + threadIdx.x; w < hi; w += kThreads) {
      const uint32_t v = a.src[w];
      for (int q = 0; q < a.K; ++q)
        if (q != a.k) slot(a, q, s, a.k)[w] = v;
    }
  }
  __threadfence_system();
  __syncthreads();
  // (2) signal
  if (threadIdx.x == 0) {
    for (long long x = blockIdx.x; x < chunks; x += gridDim.x)
      for (int q = 0; q < a.K; ++q)
        if (q != a.k)
          cuda::atomic_ref<unsigned, cuda::thread_scope_system>(
              flags_of(a, q)[a.k * chunks_cap + x])
              .store(e, cuda::memory_order_release);
  }
  // (3) wait, (4) read
  __shared__ bool ok;
  for (long long x = blockIdx.x; x < chunks; x += gridDim.x) {
    if (threadIdx.x == 0) {
      bool all = true;
      for (int q = 0; q < a.K; ++q)
        if (q != a.k)
          all = wait_epoch(mine + q * chunks_cap + x, e, a.timeout_ns,
                           a.status) && all;
      ok = all;
    }
    __syncthreads();
    const long long lo = x * kChunk, hi = min(a.nbytes, (x + 1) * kChunk);
    if (ok) {
      if (a.mode == kSumF32) {
        add_chunk<float>(a, s, lo, hi);
      } else if (a.mode == kSumF64) {
        add_chunk<double>(a, s, lo, hi);
      } else {
        uint32_t* out = reinterpret_cast<uint32_t*>(a.out);
        const long long row = a.nbytes / 4;
        for (long long w = lo / 4 + threadIdx.x; w < hi / 4; w += kThreads)
          for (int q = 0; q < a.K; ++q)
            out[q * row + w] = q == a.k ? a.src[w]
                                        : __ldcg(slot(a, a.k, s, q) + w);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(counter + 1, 1u) == gridDim.x - 1) {
      counter[1] = 0;
      counter[0] = e;
    }
  }
}

}  // namespace

// One collective of block k of K. The call is 11 + kMaxBlocks fields of 64
// bits: src, out, nbytes, k, K, mode, cap, timeout_ns, status, stream, the
// grid, then every block's allocation base (its own at k). Returns a
// cudaError_t.
struct CollectiveCall {
  const void* src;
  void* out;
  long long nbytes, k, K, mode, cap, timeout_ns;
  int* status;
  void* stream;
  long long grid;
  void* bases[kMaxBlocks];
};
static_assert(sizeof(CollectiveCall) == (11 + kMaxBlocks) * 8,
              "11 + kMaxBlocks fields of 64 bits");

extern "C" int amg_peer_collective(const CollectiveCall* c) {
  const long long es = c->mode == kSumF64 ? 8 : 4;
  if (c->K < 2 || c->K > kMaxBlocks || c->k < 0 || c->k >= c->K ||
      c->mode < kGather || c->mode > kSumF64 || c->nbytes < 4 ||
      c->nbytes % es || c->nbytes > c->cap || c->cap % kChunk ||
      c->src == nullptr || c->out == nullptr || c->status == nullptr ||
      c->timeout_ns <= 0 || c->grid < 1 || c->grid > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.src = static_cast<const uint32_t*>(c->src);
  a.out = c->out;
  a.nbytes = c->nbytes;
  a.cap = c->cap;
  a.timeout_ns = c->timeout_ns;
  a.k = (int)c->k;
  a.K = (int)c->K;
  a.mode = (int)c->mode;
  a.status = c->status;
  for (int q = 0; q < kMaxBlocks; ++q) {
    a.bases[q] = static_cast<char*>(c->bases[q]);
    if (q < a.K && a.bases[q] == nullptr) return (int)cudaErrorInvalidValue;
  }
  peer_collective_kernel<<<(unsigned)c->grid, kThreads, 0,
                           (cudaStream_t)c->stream>>>(a);
  return (int)cudaGetLastError();
}
