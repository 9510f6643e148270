// K7: the ghost-strip exchange of the row-partitioned distributed solve, as
// a put. Each of D row slabs (B rows) sends its last G rows into the next
// slab's receive strip rows [0, G) and its first G rows into the previous
// slab's rows [G, 2G); the strips no slab writes (rows [0, G) of slab 0,
// rows [G, 2G) of slab D-1) are zero, the Dirichlet edge of the line.
//
// Replaces the TPU kernel amg_tpu/ops/pallas/halo.py rdma_halo_exchange
// (pallas_call :113, body _halo_kernel :32), where each chip pushes its
// boundary strips into its neighbours' VMEM receive buffers by remote DMA
// under semaphores. Here the D slabs of the card are one tensor with a
// uniform slab stride: the kernel takes one base pointer per part (u and b,
// or one stacked u|b slab) with the slab stride and row pitch they share,
// and the receive strips' base and slab stride, and computes every slab's
// address itself. One launch moves every strip; the launch and the stream
// order replace the TPU kernel's barrier and semaphores: the strips are read
// by the ops that follow on the same stream.
//
// The receive strip row is the parts side by side, (2G, P * w), rows
// contiguous. Elements are copied as bits (4 or 8 bytes: f32, f64), so the
// kernel equals its plain version bitwise.
//
// Bound on the card: device memory, each sent element read once and each
// receive element written once: 2 (D-1) G P w elements read, 2 D G P w
// written (the zero strips are writes only). At D = 4, G = 10, P * w = 8190
// (u and b at n = 4095), f32: 2.0 MB read, 2.6 MB written, 1.4 us at
// 3.35 TB/s -- less than a launch, so the call's host cost is what a caller
// sees. The host side is one C call with one argument, the packed scalars
// (no pointer tables). Design: block (x, d, dir) copies a column chunk of
// all G rows of one direction of slab d; neighbouring threads take
// neighbouring columns (coalesced). A thread moves 16 bytes (uint4) when
// the width, the pitches, the strides and the bases allow it, else one
// element; one kernel template covers both.
//
// Across blocks (amg_halo_exchange_peer, below), each of P blocks holds
// D/P consecutive slabs, and the strips at the ends of a block go straight
// into the receive memory of blocks p-1 and p+1: the put of the TPU
// kernel, on the same card or on another one over NVLink. A block is a
// process (the neighbours' memory mapped through CUDA IPC) or a thread of
// a card group in one process (the neighbours' own pointers, with peer
// access between their cards): the same kernel.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SLABS = 65535;       // gridDim.y

// V: uint32_t / uint64_t (one f32 / f64 element) or uint4 (16 bytes). All
// strides and widths are in V units.
template <typename V>
__global__ void __launch_bounds__(THREADS)
halo_put_kernel(const V* __restrict__ src0, const V* __restrict__ src1,
                long long slab, long long pitch, V* __restrict__ dst,
                long long dst_slab, int D, int B, int G, int w, int P) {
  const int d = blockIdx.y;
  const int up = blockIdx.z;  // 0: last G rows down to d + 1; 1: first G up
  const int W = P * w;        // receive strip row width
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= W) return;
  const int p = c >= w;       // P <= 2
  const int col = c - p * w;

  int to;       // receiving slab
  int dst_row;  // first receive row written
  int src_row;  // first source row read; -1: zero fill
  if (!up) {
    if (d + 1 < D) { to = d + 1; dst_row = 0; src_row = B - G; }
    else           { to = d;     dst_row = G; src_row = -1; }
  } else {
    if (d > 0)     { to = d - 1; dst_row = G; src_row = 0; }
    else           { to = d;     dst_row = 0; src_row = -1; }
  }
  V* out = dst + to * dst_slab + (long long)dst_row * W + c;
  if (src_row < 0) {
    for (int r = 0; r < G; ++r) out[(long long)r * W] = V{};
    return;
  }
  const V* in = (p ? src1 : src0) + d * slab + src_row * pitch + col;
#pragma unroll 5
  for (int r = 0; r < G; ++r) out[(long long)r * W] = in[r * pitch];
}

template <typename V>
void launch(const void* src0, const void* src1, long long slab,
            long long pitch, void* dst, long long dst_slab, int D, int B,
            int G, int w, int P, cudaStream_t stream) {
  const dim3 grid((P * w + THREADS - 1) / THREADS, D, 2);
  halo_put_kernel<V><<<grid, THREADS, 0, stream>>>(
      static_cast<const V*>(src0), static_cast<const V*>(src1), slab, pitch,
      static_cast<V*>(dst), dst_slab, D, B, G, w, P);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// One call's arguments, 13 fields of 64 bits in this order (the wrapper
// packs them into one int64 array: one ctypes argument in place of 13,
// which halves the call's host cost). src0, src1: the parts' bases (src1
// unused when n_parts == 1), each (D, B, w) with slab stride `slab` and row
// pitch `pitch` elements and contiguous rows; dst: the (D, 2G, n_parts * w)
// receive strips, rows contiguous, slab stride `dst_slab`, overlapping no
// source.
struct HaloCall {
  const void* src0;
  const void* src1;
  long long slab, pitch;
  void* dst;
  long long dst_slab;
  long long D, B, G, w, n_parts, elsize;
  cudaStream_t stream;
};
static_assert(sizeof(HaloCall) == 13 * 8, "13 fields of 64 bits");

// Returns a cudaError_t.
extern "C" int amg_halo_exchange(const HaloCall* a) {
  const long long D = a->D, B = a->B, G = a->G, w = a->w, P = a->n_parts;
  if (D < 1 || D > MAX_SLABS || P < 1 || P > 2 || G < 1 || G > B ||
      B > INT_MAX || w < 1 || P * w > INT_MAX || a->pitch < 0 ||
      a->slab < 0 || a->dst_slab < 2 * G * P * w ||
      (a->elsize != 4 && a->elsize != 8) || (P == 2 && a->src1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long v = 16 / a->elsize;  // elements per 16-byte vector
  const bool vec = w % v == 0 && a->pitch % v == 0 && a->slab % v == 0 &&
                   a->dst_slab % v == 0 && aligned16(a->src0) &&
                   aligned16(a->dst) && (P == 1 || aligned16(a->src1));
  if (vec)
    launch<uint4>(a->src0, a->src1, a->slab / v, a->pitch / v, a->dst,
                  a->dst_slab / v, (int)D, (int)B, (int)G, (int)(w / v),
                  (int)P, a->stream);
  else if (a->elsize == 4)
    launch<uint32_t>(a->src0, a->src1, a->slab, a->pitch, a->dst,
                     a->dst_slab, (int)D, (int)B, (int)G, (int)w, (int)P,
                     a->stream);
  else
    launch<uint64_t>(a->src0, a->src1, a->slab, a->pitch, a->dst,
                     a->dst_slab, (int)D, (int)B, (int)G, (int)w, (int)P,
                     a->stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7 across blocks: the peer form.
//
// Block p of P (a process, or a thread of a card group) holds slabs
// [p D/P, (p+1) D/P) of the line. Its K7 launch puts the strips between
// its own slabs as above, and the two at the ends of its block into its
// neighbours' memory: slab 0's first G rows into block p-1, the last
// slab's last G rows into block p+1 (none at the line's ends, where the
// strips stay zero). Each block owns one allocation per exchange shape,
// which its neighbours reach (through CUDA IPC across processes, by peer
// access between the cards of one process):
//
//   out    (D/P, 2G, W)  the receive strips the caller reads, as above;
//   slots  [2][2][G][W]  the neighbours' strips, by epoch parity s, then
//                        side (0: from p-1, the rows above slab 0; 1: from
//                        p+1, the rows below the last slab);
//   flags  [2][chunks]   by side and column chunk: the epoch of the last
//                        strip chunk put there; then the epoch counter and
//                        the count of finished blocks.
//
// One launch is one epoch e = counter + 1, read from device memory and
// advanced by the launch's last block, so a CUDA graph of exchanges
// replays right. Block (x, d, dir) handles column chunk x (THREADS
// columns) of one strip. An edge block with a neighbour: (1) puts its
// chunk into the neighbour's slot (e & 1) and fences at system scope;
// (2) after the block's barrier, one thread stores e into the
// neighbour's flag of that side and chunk (release, system scope); (3) it
// waits for its own flag of the other side and chunk to reach e (acquire,
// system scope), bounded by %globaltimer; (4) it copies that chunk of the
// slot into out. Put, then signal, then wait, as the TPU kernel's remote
// copies and DMA semaphores; a block waits only on the neighbour's block
// of the same chunk, never on a block of its own launch.
//
// Buffer reuse: a put at epoch e writes slot e & 1, last written at epoch
// e - 2 and read by the neighbour's launch e - 2 (step 4). The putting
// launch e follows, on its stream, launch e - 1, which waited for the
// neighbour's flag of epoch e - 1; the neighbour stored that flag in its
// launch e - 1, which follows on its stream its launch e - 2 and so that
// read. So a put at epoch e can only follow the neighbour's reads of the
// slot it overwrites, with no barrier before the put. A flag that has run
// ahead to e + 1 still means epoch e's chunk is in slot e & 1: slot
// e & 1 is not written again before epoch e + 2, which needs this
// process's flag of epoch e + 1. Epochs are compared as (int)(f - e) >= 0,
// so they may wrap. tests/test_torch_halo_peer.py models the protocol.
//
// A wait that times out writes 1 and its epoch into the status words
// (host memory the wrapper reads); the launch's other waits, started with
// it, end by the same bound, and later launches skip their waits once the
// status is set, so a lost neighbour costs one timeout, not one a launch.
// The wrapper raises on the status.
//
// Two processes on one card time-slice its SMs (no MPS): a block waiting
// for a neighbour whose launch has not been scheduled holds the card
// until the scheduler switches contexts. The other choice, the waits as
// stream memory operations between a put kernel and a copy kernel, took
// as long a call on one card and on four (PERF.md) and could not bound
// its waits, so the waits stay in the kernel. Two blocks of one card
// group on one card share its context: their launches run on two streams
// (a thread's own), both resident at once, with no time slice.
//
// Bound: the out strips written once and the sent rows read once at the
// device memory's rate, and the two end strips over NVLink (450 GB/s each
// way) when the neighbour is on another card; at n = 4095, G = 10 a strip
// is 0.33 MB, so the flags' round trip is the cost.

namespace {

template <typename V>
struct PeerArgs {
  const V* src0;
  const V* src1;
  long long slab, pitch;
  V* out;
  long long out_slab;
  V* slots;
  V* above_slots;   // process p-1's slots (null at p = 0)
  V* below_slots;   // process p+1's (null at p = P-1)
  unsigned* flags;
  unsigned* above_flags;
  unsigned* below_flags;
  volatile int* status;
  long long timeout_ns;
  int D, B, G, w, P;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool reached(unsigned f, unsigned e) {
  return (int)(f - e) >= 0;
}

// true once *flag reaches epoch e; false after timeout_ns, or at once
// when an earlier wait of this process has timed out
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

template <typename V>
__global__ void __launch_bounds__(THREADS)
halo_peer_kernel(const PeerArgs<V> a) {
  const int x = blockIdx.x, d = blockIdx.y;
  const int up = blockIdx.z;  // 0: last G rows down to d + 1; 1: first G up
  const int chunks = gridDim.x;
  const int W = a.P * a.w;
  const int c = x * THREADS + threadIdx.x;
  const bool live = c < W;
  const int part = c >= a.w;  // P <= 2
  const int col = c - part * a.w;
  const long long G = a.G;
  unsigned* counter = a.flags + 2 * chunks;   // epoch, finished blocks
  const unsigned e = *counter + 1;
  const V* in = (part ? a.src1 : a.src0) + d * a.slab
                + (up ? 0 : a.B - a.G) * a.pitch + col;
  const bool edge = up ? d == 0 : d == a.D - 1;
  V* peer = up ? a.above_slots : a.below_slots;
  if (!edge) {
    if (live) {
      V* o = a.out + (d + (up ? -1 : 1)) * a.out_slab + (up ? G : 0) * W + c;
#pragma unroll 5
      for (int r = 0; r < a.G; ++r) o[r * W] = in[r * a.pitch];
    }
  } else {
    // the strip this block fills: rows [0, G) of slab 0 (from p-1) or
    // rows [G, 2G) of the last slab (from p+1)
    V* o = a.out + (up ? 0 : (a.D - 1) * a.out_slab + G * W) + c;
    if (peer == nullptr) {
      if (live)
        for (int r = 0; r < a.G; ++r) o[r * W] = V{};
    } else {
      const long long strip = G * W;
      const int s = e & 1u;
      const int there = up;       // my first rows arrive below p-1's slabs
      const int here = 1 - up;    // and p-1's last rows above mine
      if (live) {
        V* dst = peer + (2 * s + there) * strip + c;
#pragma unroll 5
        for (int r = 0; r < a.G; ++r) dst[r * W] = in[r * a.pitch];
      }
      __threadfence_system();
      __syncthreads();
      __shared__ bool ok;
      if (threadIdx.x == 0) {
        unsigned* f = (up ? a.above_flags : a.below_flags)
                      + there * chunks + x;
        cuda::atomic_ref<unsigned, cuda::thread_scope_system>(*f).store(
            e, cuda::memory_order_release);
        ok = wait_epoch(a.flags + here * chunks + x, e, a.timeout_ns,
                        a.status);
      }
      __syncthreads();
      if (ok && live) {
        const V* from = a.slots + (2 * s + here) * strip + c;
#pragma unroll 5
        for (int r = 0; r < a.G; ++r) o[r * W] = __ldcg(from + r * W);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
    if (atomicAdd(counter + 1, 1u) == blocks - 1) {
      counter[1] = 0;
      counter[0] = e;
    }
  }
}

template <typename V>
void launch_peer(const PeerArgs<V>& a, int chunks, cudaStream_t stream) {
  halo_peer_kernel<V><<<dim3(chunks, a.D, 2), THREADS, 0, stream>>>(a);
}

}  // namespace

// The peer call: HaloCall (dst: this process's out, D: its slabs), then
// its own and its neighbours' slots and flags (the neighbours' mapped
// here; null at the line's ends), the status words (host memory the
// device can write) and the wait's bound in ns. 21 fields of 64 bits.
struct HaloPeerCall {
  HaloCall local;
  void* slots;
  void* above_slots;
  void* below_slots;
  unsigned* flags;
  unsigned* above_flags;
  unsigned* below_flags;
  int* status;
  long long timeout_ns;
};
static_assert(sizeof(HaloPeerCall) == 21 * 8, "21 fields of 64 bits");

namespace {

int peer_chunks(const HaloCall& h) {
  return (int)((h.n_parts * h.w + THREADS - 1) / THREADS);
}

// Returns cudaSuccess and fills the kernel's arguments, or an error.
template <typename V>
int peer_args(const HaloPeerCall* a, PeerArgs<V>* k) {
  const HaloCall& h = a->local;
  const long long D = h.D, B = h.B, G = h.G, w = h.w, P = h.n_parts;
  if (D < 1 || D > MAX_SLABS || P < 1 || P > 2 || G < 1 || G > B ||
      B > INT_MAX || w < 1 || P * w > INT_MAX || h.pitch < 0 || h.slab < 0 ||
      h.dst_slab != 2 * G * P * w || (P == 2 && h.src1 == nullptr) ||
      a->slots == nullptr || a->flags == nullptr || a->status == nullptr ||
      a->timeout_ns <= 0 || (a->above_slots == nullptr) !=
      (a->above_flags == nullptr) || (a->below_slots == nullptr) !=
      (a->below_flags == nullptr))
    return (int)cudaErrorInvalidValue;
  *k = PeerArgs<V>{
      static_cast<const V*>(h.src0), static_cast<const V*>(h.src1), h.slab,
      h.pitch, static_cast<V*>(h.dst), h.dst_slab,
      static_cast<V*>(a->slots), static_cast<V*>(a->above_slots),
      static_cast<V*>(a->below_slots), a->flags, a->above_flags,
      a->below_flags, a->status, a->timeout_ns, (int)D, (int)B, (int)G,
      (int)w, (int)P};
  return (int)cudaSuccess;
}

template <typename V>
int peer_launch(const HaloPeerCall* a) {
  PeerArgs<V> k;
  const int err = peer_args<V>(a, &k);
  if (err != (int)cudaSuccess) return err;
  launch_peer<V>(k, peer_chunks(a->local), a->local.stream);
  return (int)cudaGetLastError();
}

}  // namespace

// One exchange across processes. Returns a cudaError_t.
extern "C" int amg_halo_exchange_peer(const HaloPeerCall* a) {
  if (a->local.elsize == 4) return peer_launch<unsigned int>(a);
  if (a->local.elsize == 8) return peer_launch<unsigned long long>(a);
  return (int)cudaErrorInvalidValue;
}

// Card memory the neighbour blocks address: `bytes` zeroed bytes on card
// `dev`, a whole cudaMalloc (an IPC handle names a whole allocation, and
// PyTorch's caching allocator never reuses it).
extern "C" int amg_peer_alloc(int dev, long long bytes, void** ptr) {
  *ptr = nullptr;
  cudaError_t err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return (int)err;
}

// Across processes: amg_peer_alloc, and the allocation's IPC handle (64
// bytes) into `handle`.
extern "C" int amg_ipc_alloc(int dev, long long bytes, void** ptr,
                             void* handle) {
  const int err = amg_peer_alloc(dev, bytes, ptr);
  if (err != (int)cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, *ptr);
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return (int)e;
  }
  memcpy(handle, &h, sizeof h);
  return (int)cudaSuccess;
}

// In one process (a card group): let card `dev`'s kernels address card
// `peer`'s memory. Peer access that is already on (PyTorch's own copies
// between the cards turn it on) is accepted; a pair of cards without it
// is an error.
extern "C" int amg_peer_enable(int dev, int peer) {
  cudaError_t err = cudaSetDevice(dev);
  int can = 0;
  if (err == cudaSuccess) err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // not sticky: clear it
    return (int)cudaSuccess;
  }
  return (int)err;
}

// Map another process's memory, named by its 64-byte IPC handle, into card
// `dev`'s address space (with peer access when it lies on another card).
extern "C" int amg_ipc_open(int dev, const void* handle, void** ptr) {
  *ptr = nullptr;
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int amg_ipc_close(int dev, void* ptr) {
  cudaError_t err = cudaSetDevice(dev);
  return (int)(err != cudaSuccess ? err : cudaIpcCloseMemHandle(ptr));
}

extern "C" int amg_peer_free(int dev, void* ptr) {
  cudaError_t err = cudaSetDevice(dev);
  return (int)(err != cudaSuccess ? err : cudaFree(ptr));
}
