// K2 and K3: the two fused V-cycle legs on the packed (4, M, M) f32 layout;
// K8: the residual + restriction without the sweep.
//
// K2 replaces the TPU kernel amg_tpu/ops/pallas/packed_cycle.py
// fused_down_leg_packed (bodies _down_kernel, _residual_quarters): the
// pre-smoothing sweep, the residual b - A u and the full-weighting
// restriction (sparse/packed.py restrict_packed algebra) in one pass. It
// writes the smoothed u and the (M, M) coarse right-hand side bc_pad, whose
// pad row and column (index m = M-1) are exactly 0.
//
// K3 replaces packed_cycle.py fused_up_leg_packed (bodies _up_kernel,
// _uc_dma): the bilinear prolongation correction from the (M, M) padded
// coarse solution (prolong_add_packed algebra), then the post-smoothing
// sweep.
//
// K8 replaces packed_cycle.py fused_residual_restrict_packed (body
// _rr_kernel): the residual and restriction of K2 on an already smoothed u,
// the down half of the TPU's split V-cycle level (side >= 8191, where its
// full down leg does not fit VMEM). Its floor is u and b read once and the
// quarter-size bc written once: 9 bytes per packed cell.
//
// Bound on the card: device-memory traffic. K2's floor is u and b read
// once, u and a quarter-size bc written once: 13 bytes per packed cell;
// K3's is u, b and the quarter-size coarse field read, u written: 13 too.
//
// K2 and K3 are windowed blocks (packed_common.cuh Tiling): a 32 x 64 tile
// of all four quarters, u and b's windows in shared memory, a thread per
// window column and 8 row phases, two blocks an SM so that one block's
// loads overlap the other's color steps.
//
// K2: a 44 x 80 window (ring 6 rows / 8 columns; 3 / 5 would be exact, see
// packed_common.cuh; the columns take 8 for 16-byte rows), 640 threads,
// 112,640 B of shared memory. (4 + 4) * (44 * 80) / (32 * 64) + 4 + 1 =
// 18.75 bytes per packed cell; each color step sweeps 42 x 78 cells for the
// tile's 32 x 64. After the color steps the residual goes in place of b on
// the 33 x 65 cells the restriction reads, then the u tile (16-byte stores
// where the tile lies inside) and the restriction are stored.
//
// K3: a 36 x 72 window (the exact ring, 2 rows / 4 columns), 576 threads,
// 82,944 B. (4 + 4) * (36 * 72) / (32 * 64) + 4 + 1 = 15.1 bytes per packed
// cell (the coarse field's quarter through L2). The correction cannot ride
// on an asynchronous copy: each thread reads the coarse values of a strip
// of rows of one window column into registers through the read-only path
// while the copies are in flight, waits for u's window alone, and adds the
// four quarters' corrections to their real cells while b's copies are
// still in flight.
//
// What bounds them: the SM's instruction issue in the color steps (about
// 20 instructions a cell update) and, without a second block, the window
// load's latency. A 64 x 64 tile of K2 (one block an SM) moves fewer bytes
// but leaves the SM idle while it loads: on the H100 it was 13-16 % slower
// (PERF.md lists the variants). The zero pattern of the weights is a
// template parameter (5-point, 9-point, other): the plain version skips
// zero weights, and a run-time test per term made K2 1.39x slower.
//
// - Loads: u and b go to shared memory through cp.async, all in flight at
//   once, zero-filled outside [0, M)^2 by the copy's source size: 16-byte
//   copies when M % 4 == 0 and the fields are 16-byte aligned (every M of
//   the solver's plans), 4-byte copies otherwise, in the same kernel.
// - Color steps: compile-time trip counts and no divide per cell; only
//   blocks whose window touches the domain's last rows or columns (or lies
//   outside [0, M - 1)^2) test each cell for being real.
//
// K8 is K2's block without the color steps, on K3's tiling (Up): a 32 x 64
// tile in a 36 x 72 window (ring 2 rows / 4 columns; 1 / 1 would be exact, see
// packed_common.cuh, but the residual of every quarter on the tile's 33 x
// 65 cells reads 2 rows and columns past it, and the columns take 4 for
// 16-byte rows), 576 threads, 82,944 B; u and b through cp.async, the
// residual in place of b, the restriction stored coalesced. With no color
// steps it is a pure stream: (4 + 4) * (36 * 72) / (32 * 64) + 1 = 11.1
// bytes per packed cell, two blocks an SM so that one block's loads
// overlap the other's residual and stores (a 64 x 64 tile, one block an
// SM, and 16- to 32-wide tiles were slower on the H100; PERF.md).
//
// Every kernel sets its shared-memory attribute once per process.

#include "packed_common.cuh"

namespace {

using Down = amg::Tiling<32, 64, 6, 8, 8>;   // K2
using Up = amg::Tiling<32, 64, 2, 4, 8>;     // K3 and K8

// K2's color steps, then the residual in place of b on window rows [GJ,
// GJ + TJ] and columns [GI, GI + TI], the cells the tile's restriction
// reads.
template <bool kEdge, int kPat>
__device__ void down_sweep_residual(float* U, float* B,
                                    const amg::Stencil& st, int M, int J0,
                                    int I0, int symmetric) {
  amg::window_sweep<Down, kEdge, kPat>(U, B, st, M, J0, I0, symmetric);
  amg::tile_residual<Down, kEdge, kPat>(U, B, st, M, J0, I0);
}

template <int kPat>
__global__ void __launch_bounds__(Down::NT, Down::kBlocks)
down_leg_kernel(const float* __restrict__ u, const float* __restrict__ b,
                float* __restrict__ u_out, float* __restrict__ bc, int M,
                amg::Stencil st, int symmetric, int vec) {
  extern __shared__ float down_smem[];
  float* U = down_smem;
  float* B = down_smem + 4 * Down::H * Down::W;
  const int Jt = blockIdx.y * Down::TJ;
  const int It = blockIdx.x * Down::TI;
  const int J0 = Jt - Down::GJ;
  const int I0 = It - Down::GI;
  amg::load_window<Down>(U, u, M, J0, I0, vec);
  amg::load_window<Down>(B, b, M, J0, I0, vec);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (amg::window_inside<Down>(M, J0, I0))
    down_sweep_residual<false, kPat>(U, B, st, M, J0, I0, symmetric);
  else
    down_sweep_residual<true, kPat>(U, B, st, M, J0, I0, symmetric);
  __syncthreads();
  amg::store_tile<Down>(U, u_out, M, Jt, It, vec);
  amg::store_restriction<Down>(B, bc, M, Jt, It);
}

// K8: the residual in place of b on the cells the tile's restriction
// reads, then the restriction.
template <int kPat>
__global__ void __launch_bounds__(Up::NT, Up::kBlocks)
residual_restrict_kernel(const float* __restrict__ u,
                         const float* __restrict__ b, float* __restrict__ bc,
                         int M, amg::Stencil st, int vec) {
  extern __shared__ float rr_smem[];
  float* U = rr_smem;
  float* B = rr_smem + 4 * Up::H * Up::W;
  const int Jt = blockIdx.y * Up::TJ;
  const int It = blockIdx.x * Up::TI;
  const int J0 = Jt - Up::GJ;
  const int I0 = It - Up::GI;
  amg::load_window<Up>(U, u, M, J0, I0, vec);
  amg::load_window<Up>(B, b, M, J0, I0, vec);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (amg::window_inside<Up>(M, J0, I0))
    amg::tile_residual<Up, false, kPat>(U, B, st, M, J0, I0);
  else
    amg::tile_residual<Up, true, kPat>(U, B, st, M, J0, I0);
  __syncthreads();
  amg::store_restriction<Up>(B, bc, M, Jt, It);
}

// K3's block after its copies are issued (u's window as the first commit
// group, b's as the second): the correction of u's window from the padded
// coarse solution uc (sparse/packed.py prolong_add_packed: with U the
// coarse field, 0 outside [0, m)^2, quarter 3 takes U[J,I], quarter 1
// (U[J-1,I] + U)/2, quarter 2 (U[J,I-1] + U)/2 and quarter 0 (U[J-1,I-1] +
// U[J-1,I] + U[J,I-1] + U)/4, summed in that order) on real cells only,
// then the color steps. Thread (x, y) corrects window column x, rows R y
// ... R y + R - 1; it reads its coarse values U[J, I] and U[J, I-1] for
// rows J0 + R y - 1 ... into registers while the copies are in flight.
// kEdge: test the coarse reads and the cells (without it every read lies
// in [0, m)^2, since an inside window starts at row and column >= 1, and
// every cell is real).
template <bool kEdge, int kPat>
__device__ void up_block(float* U, const float* B,
                         const float* __restrict__ uc,
                         const amg::Stencil& st, int M, int J0, int I0,
                         int symmetric) {
  constexpr int R = (Up::H + Up::NY - 1) / Up::NY;
  constexpr int Q = Up::H * Up::W;     // one quarter's window
  const int m = M - 1;
  const int c = threadIdx.x;
  const int I = I0 + c;
  const int r0 = R * threadIdx.y;
  // U[J, I] and U[J, I-1] at rows J = J0 + r0 - 1 + k
  float cu[R + 1], cw[R + 1];
#pragma unroll
  for (int k = 0; k <= R; ++k) {
    const int J = J0 + r0 - 1 + k;
    const bool in_j = r0 - 1 + k < Up::H && (!kEdge || (J >= 0 && J < m));
    cu[k] = in_j && (!kEdge || (I >= 0 && I < m))
                ? __ldg(uc + (size_t)J * M + I) : 0.f;
    cw[k] = in_j && (!kEdge || (I >= 1 && I <= m))
                ? __ldg(uc + (size_t)J * M + I - 1) : 0.f;
  }
  amg::cp_async_wait<1>();             // u's window is in; b's in flight
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = r0 + k;
    if (r >= Up::H) break;
    const int J = J0 + r;
    const float n = cu[k], nw = cw[k], u0 = cu[k + 1], w = cw[k + 1];
    float* x = U + r * Up::W + c;
    if (!kEdge || amg::real_cell(0, J, I, M))
      x[0] = x[0] + 0.25f * (((nw + n) + w) + u0);
    if (!kEdge || amg::real_cell(1, J, I, M)) x[Q] = x[Q] + 0.5f * (n + u0);
    if (!kEdge || amg::real_cell(2, J, I, M))
      x[2 * Q] = x[2 * Q] + 0.5f * (w + u0);
    if (!kEdge || amg::real_cell(3, J, I, M)) x[3 * Q] = x[3 * Q] + u0;
  }
  amg::cp_async_wait<0>();
  __syncthreads();
  amg::window_sweep<Up, kEdge, kPat>(U, B, st, M, J0, I0, symmetric);
}

template <int kPat>
__global__ void __launch_bounds__(Up::NT, Up::kBlocks)
up_leg_kernel(const float* __restrict__ u, const float* __restrict__ b,
              const float* __restrict__ uc, float* __restrict__ u_out, int M,
              amg::Stencil st, int symmetric, int vec) {
  extern __shared__ float up_smem[];
  float* U = up_smem;
  float* B = up_smem + 4 * Up::H * Up::W;
  const int Jt = blockIdx.y * Up::TJ;
  const int It = blockIdx.x * Up::TI;
  const int J0 = Jt - Up::GJ;
  const int I0 = It - Up::GI;
  amg::load_window<Up>(U, u, M, J0, I0, vec);
  amg::cp_async_commit();
  amg::load_window<Up>(B, b, M, J0, I0, vec);
  amg::cp_async_commit();
  if (amg::window_inside<Up>(M, J0, I0))
    up_block<false, kPat>(U, B, uc, st, M, J0, I0, symmetric);
  else
    up_block<true, kPat>(U, B, uc, st, M, J0, I0, symmetric);
  amg::store_tile<Up>(U, u_out, M, Jt, It, vec);
}

template <int kPat>
int launch_down_leg(const float* u, const float* b, float* u_out, float* bc,
                    int M, const float* w9, float inv_diag, float omega,
                    int symmetric, int vec, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(down_leg_kernel<kPat>,
                                             Down::kSmem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + Down::TI - 1) / Down::TI,
                  (M + Down::TJ - 1) / Down::TJ);
  down_leg_kernel<kPat><<<grid, dim3(Down::NX, Down::NY), Down::kSmem,
                          stream>>>(
      u, b, u_out, bc, M, amg::make_stencil(w9, inv_diag, omega), symmetric,
      vec);
  return (int)cudaGetLastError();
}

template <int kPat>
int launch_up_leg(const float* u, const float* b, const float* uc,
                  float* u_out, int M, const float* w9, float inv_diag,
                  float omega, int symmetric, int vec, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(up_leg_kernel<kPat>, Up::kSmem,
                                             attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + Up::TI - 1) / Up::TI, (M + Up::TJ - 1) / Up::TJ);
  up_leg_kernel<kPat><<<grid, dim3(Up::NX, Up::NY), Up::kSmem, stream>>>(
      u, b, uc, u_out, M, amg::make_stencil(w9, inv_diag, omega), symmetric,
      vec);
  return (int)cudaGetLastError();
}

template <int kPat>
int launch_residual_restrict(const float* u, const float* b, float* bc,
                             int M, const float* w9, int vec,
                             cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(residual_restrict_kernel<kPat>,
                                             Up::kSmem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + Up::TI - 1) / Up::TI, (M + Up::TJ - 1) / Up::TJ);
  residual_restrict_kernel<kPat><<<grid, dim3(Up::NX, Up::NY), Up::kSmem,
                                   stream>>>(
      u, b, bc, M, amg::make_stencil(w9, 0.f, 0.f), vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int amg_down_leg(const float* u, const float* b, float* u_out,
                            float* bc, int M, const float* w9, float inv_diag,
                            float omega, int symmetric, cudaStream_t stream) {
  const int vec = M % 4 == 0 && amg::aligned16(u) && amg::aligned16(b)
                  && amg::aligned16(u_out);
  return amg::by_weight_pattern(w9, [&](auto pat) {
    return launch_down_leg<decltype(pat)::value>(
        u, b, u_out, bc, M, w9, inv_diag, omega, symmetric, vec, stream);
  });
}

extern "C" int amg_up_leg(const float* u, const float* b, const float* uc,
                          float* u_out, int M, const float* w9,
                          float inv_diag, float omega, int symmetric,
                          cudaStream_t stream) {
  const int vec = M % 4 == 0 && amg::aligned16(u) && amg::aligned16(b)
                  && amg::aligned16(u_out);
  return amg::by_weight_pattern(w9, [&](auto pat) {
    return launch_up_leg<decltype(pat)::value>(
        u, b, uc, u_out, M, w9, inv_diag, omega, symmetric, vec, stream);
  });
}

extern "C" int amg_residual_restrict(const float* u, const float* b,
                                     float* bc, int M, const float* w9,
                                     cudaStream_t stream) {
  const int vec = M % 4 == 0 && amg::aligned16(u) && amg::aligned16(b);
  return amg::by_weight_pattern(w9, [&](auto pat) {
    return launch_residual_restrict<decltype(pat)::value>(u, b, bc, M, w9,
                                                          vec, stream);
  });
}
