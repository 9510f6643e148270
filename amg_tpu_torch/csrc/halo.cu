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

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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
