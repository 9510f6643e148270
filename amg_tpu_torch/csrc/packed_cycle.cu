// K2 and K3: the two fused V-cycle legs on the packed (4, M, M) f32 layout.
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
// Design: K2 computes the residual in place of b in shared memory (a cell's
// residual reads b only at that cell), on the (T+1)^2 window the
// restriction reads; K3 applies the correction while loading u, since it is
// a local function of the coarse field at (J-1..J, I-1..I).

#include "packed_common.cuh"

namespace {

constexpr int T = 32;
constexpr int GD = 10;                 // down-leg ghost ring
constexpr int WD = T + 2 * GD;
constexpr int GU = 8;                  // up-leg ghost ring
constexpr int WU = T + 2 * GU;
constexpr size_t kSmemDown = 2 * 4 * WD * WD * sizeof(float);
constexpr size_t kSmemUp = 2 * 4 * WU * WU * sizeof(float);

// Residual of color (PJ, PI) at window cell (r, c), overwriting b there:
// sparse/packed.py residual_packed, acc = _acc + w_c * u_a, r = b - acc on
// real cells, 0 elsewhere.
template <int PJ, int PI>
__device__ __forceinline__ void residual_cell(const float* U, float* B,
                                              const amg::Stencil& st, int M,
                                              int J0, int I0, int r, int c) {
  constexpr int a = 2 * PJ + PI;
  const int L = (a * WD + r) * WD + c;
  const float acc =
      amg::neighbour_acc<WD, PJ, PI>(U, st, r, c) + st.w[4] * U[L];
  B[L] = amg::real_cell(a, J0 + r, I0 + c, M) ? B[L] - acc : 0.f;
}

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

  // residual on window rows/cols [GD, GD + T], all four quarters
  constexpr int R = T + 1;
  for (int L = threadIdx.x; L < 4 * R * R; L += blockDim.x) {
    const int q = L / (R * R);
    const int rem = L - q * R * R;
    const int r = GD + rem / R;
    const int c = GD + rem % R;
    switch (q) {
      case 0: residual_cell<0, 0>(U, B, st, M, J0, I0, r, c); break;
      case 1: residual_cell<0, 1>(U, B, st, M, J0, I0, r, c); break;
      case 2: residual_cell<1, 0>(U, B, st, M, J0, I0, r, c); break;
      default: residual_cell<1, 1>(U, B, st, M, J0, I0, r, c); break;
    }
  }
  __syncthreads();
  amg::store_interior<T, GD>(U, u_out, M, Jt, It);

  // restriction: coarse (J, I) <- r11 + 0.5*(r01[J,I] + r01[J+1,I] +
  // r10[J,I] + r10[J,I+1]) + 0.25*(r00 at J..J+1 x I..I+1), in the
  // restrict_packed summation order; 0 on the pad row and column
  const int m = M - 1;
  for (int L = threadIdx.x; L < T * T; L += blockDim.x) {
    const int jj = L / T;
    const int ii = L - jj * T;
    const int J = Jt + jj;
    const int I = It + ii;
    if (J >= M || I >= M) continue;
    float v = 0.f;
    if (J < m && I < m) {
      const int r = GD + jj;
      const int c = GD + ii;
      auto R_ = [&](int q, int rr, int cc) { return B[(q * WD + rr) * WD + cc]; };
      v = R_(3, r, c);
      v = v + 0.5f * (((R_(1, r, c) + R_(1, r + 1, c)) + R_(2, r, c))
                      + R_(2, r, c + 1));
      v = v + 0.25f * (((R_(0, r, c) + R_(0, r, c + 1)) + R_(0, r + 1, c))
                       + R_(0, r + 1, c + 1));
    }
    bc[(size_t)J * M + I] = v;
  }
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
