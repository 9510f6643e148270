// K7: the ghost-strip exchange of the row-partitioned distributed solve, as
// a put. Each of D row slabs (B rows) sends its last G rows into the next
// slab's receive strip rows [0, G) and its first G rows into the previous
// slab's rows [G, 2G); the strips no slab writes (rows [0, G) of slab 0,
// rows [G, 2G) of slab D-1) are zero, the Dirichlet edge of the line.
//
// Replaces the TPU kernel amg_tpu/ops/pallas/halo.py rdma_halo_exchange
// (pallas_call :113, body _halo_kernel :32), where each chip pushes its
// boundary strips into its neighbours' VMEM receive buffers by remote DMA
// under semaphores. Here every slab's source and receive strip is reached
// through a pointer in per-slab tables passed in the kernel's parameter
// space, so a slab may live anywhere the card can address: on this card
// now, on a peer card (unified addressing, peer access over NVLink) in a
// later slice, with the same kernel. One launch moves every strip; the
// launch and the stream order replace the TPU kernel's barrier and
// semaphores: the strips are read by the ops that follow on the same stream.
//
// A slab may be given as several parts of equal width w (u and b, or one
// stacked u|b slab): the receive strip row is the parts side by side,
// (2G, P * w), contiguous. Sources are (B, w) row-major with row pitch
// src_pitch elements. Elements are copied as bits (4 or 8 bytes: f32, f64),
// so the kernel equals its plain version bitwise.
//
// Bound on the card: device memory, each sent element read once and each
// receive element written once: 2 (D-1) G P w elements read, 2 D G P w
// written (the zero strips are writes only). At D = 4, G = 10, P * w = 8190
// (u and b at n = 4095), f32: 2.0 MB read, 2.6 MB written, 1.4 us at
// 3.35 TB/s -- less than a launch, so the launch dominates. Design, simple first: block
// (x, d, dir) copies a 256-column chunk of all G rows of one direction of
// slab d; neighbouring threads take neighbouring columns (coalesced); plain
// element loads, so odd widths and odd pitches need no alignment case.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SLABS = 128;
constexpr int MAX_PARTS = 2;
constexpr int THREADS = 256;

// 128 * 2 * 8 + 128 * 8 = 3 KB, inside the 4 KB parameter space.
struct Tables {
  const void* src[MAX_SLABS][MAX_PARTS];
  void* dst[MAX_SLABS];
};

template <typename E>  // uint32_t or uint64_t: a bit copy
__global__ void __launch_bounds__(THREADS)
halo_put_kernel(Tables t, int D, int P, int B, int G, int w,
                long long src_pitch) {
  const int d = blockIdx.y;
  const int up = blockIdx.z;  // 0: last G rows down to d + 1; 1: first G up
  const int W = P * w;        // receive strip row width
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= W) return;
  const int p = c / w;
  const int q = c - p * w;

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
  E* out = static_cast<E*>(t.dst[to]) + (size_t)dst_row * W + c;
  if (src_row < 0) {
    for (int r = 0; r < G; ++r) out[(size_t)r * W] = E(0);
    return;
  }
  const E* in = static_cast<const E*>(t.src[d][p])
                + (size_t)src_row * src_pitch + q;
  for (int r = 0; r < G; ++r) out[(size_t)r * W] = in[(size_t)r * src_pitch];
}

}  // namespace

// src: D * n_parts source pointers, slab-major; dst: D receive-strip
// pointers. Returns a cudaError_t.
extern "C" int amg_halo_exchange(const void* const* src, int n_parts,
                                 long long src_pitch, void* const* dst,
                                 int D, int B, int G, int w, int elsize,
                                 cudaStream_t stream) {
  if (D < 1 || D > MAX_SLABS || n_parts < 1 || n_parts > MAX_PARTS ||
      G < 1 || G > B || w < 1 || src_pitch < w ||
      (elsize != 4 && elsize != 8))
    return (int)cudaErrorInvalidValue;
  Tables t = {};
  for (int d = 0; d < D; ++d) {
    for (int p = 0; p < n_parts; ++p) t.src[d][p] = src[d * n_parts + p];
    t.dst[d] = dst[d];
  }
  const int W = n_parts * w;
  const dim3 grid((W + THREADS - 1) / THREADS, D, 2);
  if (elsize == 4)
    halo_put_kernel<uint32_t><<<grid, THREADS, 0, stream>>>(
        t, D, n_parts, B, G, w, src_pitch);
  else
    halo_put_kernel<uint64_t><<<grid, THREADS, 0, stream>>>(
        t, D, n_parts, B, G, w, src_pitch);
  return (int)cudaGetLastError();
}
