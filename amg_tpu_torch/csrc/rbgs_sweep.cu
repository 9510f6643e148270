// K5: one fused (symmetric) four-color Gauss-Seidel sweep on the unpacked
// (n, n) f32 layout with a constant 3x3 stencil (K6, the same sweep with
// coefficient planes, is rbgs_var.cu).
//
// Replaces the TPU kernel amg_tpu/ops/pallas/rbgs.py fused_gs4_sweep,
// pallas_call :544 (const; bodies _sweep_kernel_const,
// _sweep_kernel_const_db). The TPU frame (G1 ghost rows, lane-padded
// columns) exists only for Mosaic and is dropped: fields are used as they
// are.
//
// What it computes (rbgs.py:86-174): colors (0,0) (0,1) (1,0) (1,1) by row
// and column parity, then reversed when symmetric; a cell of the current
// color becomes u + omega * ((b - sum_off c * u_nbr) * inv_diag - u), with
// neighbours outside the grid reading 0 (Dirichlet).
//
// Bound on the card: device memory. Each input read once and the output
// written once: u and b read and u written, 12 B per cell; at n = 4095
// (16.8 M cells) 201 MB -> 0.060 ms at the 3.35 TB/s data-sheet rate. This
// design moves more: each block loads a (50/32)^2 = 2.4x window of u, and
// its ghost cells update too, so b is read at (48/32)^2 = 2.25x: about 23 B
// per cell, where L2 does not catch the neighbouring blocks' overlap.
//
// Design, simple and right first:
// - Temporal blocking as in K1: a block owns a T x T output tile and holds
//   the u window with a ghost ring of G = (number of color steps) cells, plus
//   a one-cell frame that is loaded but never updated, in shared memory
//   (50 x 50 x 4 B = 10 KB for T = 32, G = 8). A window cell next to the
//   frame goes wrong after the first step, and the error front moves in one
//   cell per step, so after G steps the T x T interior is exact.
// - One thread per 2 x 2 block of the window: at each step it updates the
//   one cell of the current color, so the stencil is evaluated on n^2 / 4
//   cells per step (the TPU kernel's full-width masked update evaluates it
//   everywhere). Cells of one color never neighbour each other, so the
//   in-place update of the window is race-free within a step.
// - b is used only when the cell updates: it is read from global memory
//   (through L2, __ldg) into a register, never staged in shared memory. The
//   second visit of a cell (symmetric sweep) finds it in L2.
// - Out of place: ghost cells read the pre-sweep input, so the output is a
//   separate buffer. Only real cells are written.
// - Operation order is the plain version's (amg_tpu_torch/ops/kernels/
//   rbgs.py fused_gs4_sweep_plain): di outer, dj inner, skipping zero
//   weights; built with -fmad=false, so the kernel gives the plain
//   version's bits.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T = 32;  // output tile side; even, so window parity is real

// w33 rounded to f32 (row-major [dj+1][di+1]) and 1/w33[1][1] computed in
// f64 and rounded to f32 on the host.
struct ConstStencil {
  float w[9];
  float inv_diag;
};

template <int G>
__global__ void __launch_bounds__((T / 2 + G) * (T / 2 + G))
rbgs_sweep_kernel(const float* __restrict__ u, const float* __restrict__ b,
                  float* __restrict__ out, int n, ConstStencil st,
                  float omega, int nsteps) {
  constexpr int W = T + 2 * G;  // updated window side
  constexpr int S = W + 2;      // stored side: a never-updated frame cell
  constexpr int H = W / 2;      // threads per side
  __shared__ float U[S * S];

  // window cell (r, q) is the grid cell (jw + r, iw + q); jw + 1 is even
  const int jw = (int)blockIdx.y * T - G - 1;
  const int iw = (int)blockIdx.x * T - G - 1;
  const int tid = threadIdx.y * H + threadIdx.x;
  for (int L = tid; L < S * S; L += H * H) {
    const int r = L / S;
    const int q = L - r * S;
    const int j = jw + r;
    const int i = iw + q;
    U[L] = (j >= 0 && j < n && i >= 0 && i < n) ? u[(size_t)j * n + i] : 0.f;
  }
  __syncthreads();

  for (int k = 0; k < nsteps; ++k) {
    const int color = k < 4 ? k : 7 - k;
    const int r = 1 + 2 * (int)threadIdx.y + (color >> 1);
    const int q = 1 + 2 * (int)threadIdx.x + (color & 1);
    const int j = jw + r;
    const int i = iw + q;
    if (j >= 0 && j < n && i >= 0 && i < n) {
      const size_t g = (size_t)j * n + i;
      float acc = 0.f;
#pragma unroll
      for (int di = -1; di <= 1; ++di) {
#pragma unroll
        for (int dj = -1; dj <= 1; ++dj) {
          if (dj == 0 && di == 0) continue;
          const float w = st.w[(dj + 1) * 3 + di + 1];
          if (w == 0.f) continue;
          acc = acc + w * U[(r + dj) * S + q + di];
        }
      }
      const float uu = U[r * S + q];
      const float delta = (__ldg(b + g) - acc) * st.inv_diag - uu;
      U[r * S + q] = uu + omega * delta;
    }
    __syncthreads();
  }

  // the T x T interior: window rows and columns G+1 .. G+T
  for (int L = tid; L < T * T; L += H * H) {
    const int r = L / T;
    const int q = L - r * T;
    const int j = (int)blockIdx.y * T + r;
    const int i = (int)blockIdx.x * T + q;
    if (j < n && i < n) out[(size_t)j * n + i] = U[(G + 1 + r) * S + G + 1 + q];
  }
}

// G = the number of color steps: 8 symmetric, 4 forward.
int launch(const float* u, const float* b, float* out, int n,
           const ConstStencil& st, float omega, int symmetric,
           cudaStream_t stream) {
  const int nt = (n + T - 1) / T;
  if (symmetric) {
    constexpr int H = T / 2 + 8;
    rbgs_sweep_kernel<8><<<dim3(nt, nt), dim3(H, H), 0, stream>>>(
        u, b, out, n, st, omega, 8);
  } else {
    constexpr int H = T / 2 + 4;
    rbgs_sweep_kernel<4><<<dim3(nt, nt), dim3(H, H), 0, stream>>>(
        u, b, out, n, st, omega, 4);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int amg_rbgs_sweep_const(const float* u, const float* b,
                                    float* out, int n, const float* w9,
                                    float inv_diag, float omega,
                                    int symmetric, cudaStream_t stream) {
  ConstStencil st;
  for (int k = 0; k < 9; ++k) st.w[k] = w9[k];
  st.inv_diag = inv_diag;
  return launch(u, b, out, n, st, omega, symmetric, stream);
}
