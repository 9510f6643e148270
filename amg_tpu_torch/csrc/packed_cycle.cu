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
// Bound on the card: device-memory traffic, as K1 (packed_sweep.cu). K2
// reads u and b with a ghost ring of G = 10 (8 color steps, one cell for the
// residual, one for the restriction's J+1 / I+1 reads) and writes u and a
// quarter-size bc: (4 + 4) * (52/32)^2 + 4 + 1 = 26 bytes per packed cell;
// unfused, sweep + residual + restriction move about 30 field passes. K3
// reads u and b with G = 8 plus the coarse field (about 1 byte per packed
// cell, from L2) and writes u: about 23 bytes per packed cell.
//
// K8 replaces packed_cycle.py fused_residual_restrict_packed (body
// _rr_kernel): the residual and restriction of K2 on an already smoothed u,
// the down half of the TPU's split V-cycle level (side >= 8191, where its
// full down leg does not fit VMEM). It reads u and b with a ghost ring of
// G = 2 and writes bc: (4 + 4) * (36/32)^2 + 1 = 11.1 bytes per packed cell,
// against a floor of 9 (u and b once, bc once).
//
// Design: K2 and K8 compute the residual in place of b in shared memory (a
// cell's residual reads b only at that cell), on the (T+1)^2 window the
// restriction reads (packed_common.cuh residual_window, restrict_store);
// K3 applies the correction while loading u, since it is a local function
// of the coarse field at (J-1..J, I-1..I).

#include "packed_common.cuh"

namespace {

constexpr int T = 32;
constexpr int GD = 10;                 // down-leg ghost ring
constexpr int WD = T + 2 * GD;
constexpr int GU = 8;                  // up-leg ghost ring
constexpr int WU = T + 2 * GU;
constexpr size_t kSmemDown = 2 * 4 * WD * WD * sizeof(float);
constexpr int GR = 2;                  // residual+restrict ghost ring
constexpr int WR = T + 2 * GR;
constexpr size_t kSmemUp = 2 * 4 * WU * WU * sizeof(float);
constexpr size_t kSmemRR = 2 * 4 * WR * WR * sizeof(float);

__global__ void __launch_bounds__(amg::kThreads)
down_leg_kernel(const float* __restrict__ u, const float* __restrict__ b,
                float* __restrict__ u_out, float* __restrict__ bc, int M,
                amg::Stencil st, int symmetric) {
  extern __shared__ float smem[];
  float* U = smem;
  float* B = smem + 4 * WD * WD;
  const int Jt = blockIdx.y * T;
  const int It = blockIdx.x * T;
  const int J0 = Jt - GD;
  const int I0 = It - GD;
  amg::load_tile<WD>(U, u, M, J0, I0);
  amg::load_tile<WD>(B, b, M, J0, I0);
  __syncthreads();
  amg::color_steps<WD>(U, B, st, M, J0, I0, symmetric);

  amg::residual_window<T, GD>(U, B, st, M, J0, I0);
  __syncthreads();
  amg::store_interior<T, GD>(U, u_out, M, Jt, It);
  amg::restrict_store<T, GD>(B, bc, M, Jt, It);
}

// K8: the residual in place of b on the (T+1)^2 cells the tile's
// restriction reads, then the restriction; no color steps, so a ring of
// GR = 2 covers the residual's and the restriction's one-cell reach.
__global__ void __launch_bounds__(amg::kThreads)
residual_restrict_kernel(const float* __restrict__ u,
                         const float* __restrict__ b, float* __restrict__ bc,
                         int M, amg::Stencil st) {
  extern __shared__ float smem[];
  float* U = smem;
  float* B = smem + 4 * WR * WR;
  const int Jt = blockIdx.y * T;
  const int It = blockIdx.x * T;
  const int J0 = Jt - GR;
  const int I0 = It - GR;
  amg::load_tile<WR>(U, u, M, J0, I0);
  amg::load_tile<WR>(B, b, M, J0, I0);
  __syncthreads();
  amg::residual_window<T, GR>(U, B, st, M, J0, I0);
  __syncthreads();
  amg::restrict_store<T, GR>(B, bc, M, Jt, It);
}

// Bilinear correction of quarter a at (J, I) from the padded coarse field
// (sparse/packed.py prolong_add_packed: c11 = U, c01 = (U[J-1,I] + U)/2,
// c10 = (U[J,I-1] + U)/2, c00 = (U[J-1,I-1] + U[J-1,I] + U[J,I-1] + U)/4).
__device__ __forceinline__ float coarse_at(const float* __restrict__ uc,
                                           int J, int I, int M) {
  return (J >= 0 && I >= 0) ? uc[(size_t)J * M + I] : 0.f;
}

__device__ __forceinline__ float correction(const float* __restrict__ uc,
                                            int a, int J, int I, int M) {
  const float u0 = coarse_at(uc, J, I, M);
  switch (a) {
    case 3: return u0;
    case 1: return 0.5f * (coarse_at(uc, J - 1, I, M) + u0);
    case 2: return 0.5f * (coarse_at(uc, J, I - 1, M) + u0);
    default:
      return 0.25f * (((coarse_at(uc, J - 1, I - 1, M)
                        + coarse_at(uc, J - 1, I, M))
                       + coarse_at(uc, J, I - 1, M)) + u0);
  }
}

__global__ void __launch_bounds__(amg::kThreads)
up_leg_kernel(const float* __restrict__ u, const float* __restrict__ b,
              const float* __restrict__ uc, float* __restrict__ u_out,
              int M, amg::Stencil st, int symmetric) {
  extern __shared__ float smem[];
  float* U = smem;
  float* B = smem + 4 * WU * WU;
  const int Jt = blockIdx.y * T;
  const int It = blockIdx.x * T;
  const int J0 = Jt - GU;
  const int I0 = It - GU;
  for (int L = threadIdx.x; L < 4 * WU * WU; L += blockDim.x) {
    const int q = L / (WU * WU);
    const int rem = L - q * WU * WU;
    const int r = rem / WU;
    const int c = rem - r * WU;
    const int J = J0 + r;
    const int I = I0 + c;
    float v = 0.f;
    if (J >= 0 && J < M && I >= 0 && I < M) v = u[amg::gidx(q, J, I, M)];
    if (amg::real_cell(q, J, I, M)) v = v + correction(uc, q, J, I, M);
    U[L] = v;
  }
  amg::load_tile<WU>(B, b, M, J0, I0);
  __syncthreads();
  amg::color_steps<WU>(U, B, st, M, J0, I0, symmetric);
  amg::store_interior<T, GU>(U, u_out, M, Jt, It);
}

}  // namespace

extern "C" int amg_down_leg(const float* u, const float* b, float* u_out,
                            float* bc, int M, const float* w9, float inv_diag,
                            float omega, int symmetric, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      down_leg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemDown);
  if (err != cudaSuccess) return (int)err;
  const int nt = (M + T - 1) / T;
  down_leg_kernel<<<dim3(nt, nt), amg::kThreads, kSmemDown, stream>>>(
      u, b, u_out, bc, M, amg::make_stencil(w9, inv_diag, omega), symmetric);
  return (int)cudaGetLastError();
}

extern "C" int amg_up_leg(const float* u, const float* b, const float* uc,
                          float* u_out, int M, const float* w9,
                          float inv_diag, float omega, int symmetric,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      up_leg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemUp);
  if (err != cudaSuccess) return (int)err;
  const int nt = (M + T - 1) / T;
  up_leg_kernel<<<dim3(nt, nt), amg::kThreads, kSmemUp, stream>>>(
      u, b, uc, u_out, M, amg::make_stencil(w9, inv_diag, omega), symmetric);
  return (int)cudaGetLastError();
}

extern "C" int amg_residual_restrict(const float* u, const float* b,
                                     float* bc, int M, const float* w9,
                                     cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      residual_restrict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemRR);
  if (err != cudaSuccess) return (int)err;
  const int nt = (M + T - 1) / T;
  residual_restrict_kernel<<<dim3(nt, nt), amg::kThreads, kSmemRR, stream>>>(
      u, b, bc, M, amg::make_stencil(w9, 0.f, 0.f));
  return (int)cudaGetLastError();
}
