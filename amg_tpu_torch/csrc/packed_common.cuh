// Shared device code of the color-packed kernels. One copy of each piece,
// used as follows:
//
//   piece                               K1  K2  K3  K8  K9
//   gidx / real_cell / set_smem_once    x   x   x   x   x
//   load_tile / store_interior          x       x   x   x   (layout: K9 rows)
//   neighbour_acc / gs_update           x   x   x       x   (K2: kPat)
//   color_steps (the GS color steps)    x       x       x
//   sweep_block (K1's whole block)      x                x
//   residual_cell / restrict_cell           x       x
//   residual_window / restrict_store                x
//
// K1 packed_sweep.cu, K2/K3/K8 packed_cycle.cu, K9 packed_rm.cu. K2 has
// its own window, loads and thread map (packed_cycle.cu) around the shared
// arithmetic.
//
// Layout (amg_tpu_torch/sparse/packed.py): a field holds four (M, M) f32
// quarters, quarter a = 2*pj + pi holding the points (2J+pj, 2I+pi). With
// kQuarterMajor (the (4, M, M) packed field) quarter q, row J, column I
// sit at (q*M + J)*M + I; with kRowGrouped (the (M, 4M) row-grouped field
// of ops/kernels/packed_rm.py) at J*4M + q*M + I. Quarter a's real cells
// are J < Mj, I < Mi with Mj = M - pj, Mi = M - pi; every other cell is a
// pad cell that stays exactly 0, and a read outside [0, M)^2 reads 0.
// Together they are the Dirichlet boundary. Shared-memory tiles are always
// [4][W][W], whatever the layout in device memory.
//
// Temporal blocking: a block holds a T x T tile of all four quarters plus a
// ghost ring of G cells on all four sides in shared memory. Each color step
// updates every real cell of the (T+2G)^2 window, reading neighbours inside
// the window only (0 outside it). A cell on the window's edge therefore goes
// wrong, and the error front moves inward by one cell per step in J and I.
// After 8 steps the cells at distance >= 8 from the edge hold exactly the
// sequential color-ordered iterate; G >= 8 keeps the interior exact. (The
// front moves one fine grid point, half a packed cell, per step, so this G
// is twice what exactness needs; K2 takes the tighter ring.)
//
// Arithmetic order equals the plain PyTorch version term by term, and the
// library is built with -fmad=false, so no product is contracted into an
// FMA: on equal inputs the kernels give the plain version's bits.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

namespace amg {

constexpr int kThreads = 256;

// Device-memory layouts of a packed field (see above).
constexpr int kQuarterMajor = 0;
constexpr int kRowGrouped = 1;

// w33 rounded to f32 (row-major [dj+1][di+1]), 1/w33[1][1] computed in f64
// and rounded to f32 on the host, omega rounded to f32.
struct Stencil {
  float w[9];
  float inv_diag;
  float omega;
};

// Which off-diagonal weights are 0, as a compile-time parameter (the plain
// version skips a zero weight's term): kAnyWeights tests each weight at run
// time; kFivePoint has zero corners and nonzero edges; kNinePoint no zero.
constexpr int kAnyWeights = 0;
constexpr int kFivePoint = 1;
constexpr int kNinePoint = 2;

inline int weight_pattern(const float* w9) {
  const bool corners = w9[0] == 0.f && w9[2] == 0.f && w9[6] == 0.f
                       && w9[8] == 0.f;
  const bool edges = w9[1] != 0.f && w9[3] != 0.f && w9[5] != 0.f
                     && w9[7] != 0.f;
  if (corners && edges) return kFivePoint;
  if (edges && w9[0] != 0.f && w9[2] != 0.f && w9[6] != 0.f && w9[8] != 0.f)
    return kNinePoint;
  return kAnyWeights;
}

inline Stencil make_stencil(const float* w9, float inv_diag, float omega) {
  Stencil st;
  for (int k = 0; k < 9; ++k) st.w[k] = w9[k];
  st.inv_diag = inv_diag;
  st.omega = omega;
  return st;
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once per
// process and device (devices 0-63; others set it at every launch): the
// entry points call this on every launch, and after the first it costs a
// cudaGetDevice and an atomic load.
template <typename Kernel>
inline cudaError_t set_smem_once(Kernel* kernel, size_t bytes,
                                 std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit & done.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ __forceinline__ bool real_cell(int a, int J, int I, int M) {
  const int Mj = M - (a >> 1);
  const int Mi = M - (a & 1);
  return J >= 0 && J < Mj && I >= 0 && I < Mi;
}

template <int Lay = kQuarterMajor>
__device__ __forceinline__ size_t gidx(int q, int J, int I, int M) {
  if (Lay == kRowGrouped) return ((size_t)J * 4 + q) * M + I;
  return ((size_t)q * M + J) * M + I;
}

// S[4][W][W] <- the four quarters' [J0, J0+W) x [I0, I0+W) windows, zero
// outside [0, M)^2. Neighbouring threads read neighbouring columns, which
// are contiguous in both layouts.
template <int W, int Lay = kQuarterMajor>
__device__ void load_tile(float* S, const float* __restrict__ g, int M,
                          int J0, int I0) {
  for (int L = threadIdx.x; L < 4 * W * W; L += blockDim.x) {
    const int q = L / (W * W);
    const int rem = L - q * W * W;
    const int r = rem / W;
    const int c = rem - r * W;
    const int J = J0 + r;
    const int I = I0 + c;
    float v = 0.f;
    if (J >= 0 && J < M && I >= 0 && I < M) v = g[gidx<Lay>(q, J, I, M)];
    S[L] = v;
  }
}

// Off-diagonal accumulation at cell (r, c) of color (PJ, PI) of a [4][H][W]
// window, in the sparse/packed.py _neighbors order, starting from 0 like
// _acc. kBounds: a read outside the window is 0; without it the caller
// keeps (r, c) off the window's edge. kPat: the weights' zero pattern.
template <int H, int W, int PJ, int PI, bool kBounds = true,
          int kPat = kAnyWeights>
__device__ __forceinline__ float neighbour_acc(const float* U,
                                               const Stencil& st, int r,
                                               int c) {
  float acc = 0.f;
#pragma unroll
  for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
      if (dj == 0 && di == 0) continue;
      if (kPat == kFivePoint && dj != 0 && di != 0) continue;
      const float w = st.w[(dj + 1) * 3 + (di + 1)];
      if (kPat == kAnyWeights && w == 0.f) continue;
      const int bj = (PJ + dj + 2) & 1;
      const int bi = (PI + di + 2) & 1;
      const int src = 2 * bj + bi;
      const int rr = r + (PJ + dj - bj) / 2;
      const int cc = c + (PI + di - bi) / 2;
      float x = 0.f;
      if (!kBounds || (rr >= 0 && rr < H && cc >= 0 && cc < W))
        x = U[(src * H + rr) * W + cc];
      acc = acc + w * x;
    }
  }
  return acc;
}

// The GS update of one cell, u + omega * ((b - acc)/diag - u), in the
// plain version's order.
__device__ __forceinline__ float gs_update(float u, float b, float acc,
                                           const Stencil& st) {
  const float delta = (b - acc) * st.inv_diag - u;
  return u + st.omega * delta;
}

// One GS color step on the window: u_a += omega * ((b_a - acc)/diag - u_a)
// at every real cell of quarter a. The step reads only the other three
// quarters, so updating quarter a in place is race-free.
template <int W, int PJ, int PI>
__device__ void color_step(float* U, const float* B, const Stencil& st,
                           int M, int J0, int I0) {
  constexpr int a = 2 * PJ + PI;
  float* Ua = U + a * W * W;
  const float* Ba = B + a * W * W;
  for (int L = threadIdx.x; L < W * W; L += blockDim.x) {
    const int r = L / W;
    const int c = L - r * W;
    if (!real_cell(a, J0 + r, I0 + c, M)) continue;
    const float acc = neighbour_acc<W, W, PJ, PI>(U, st, r, c);
    Ua[L] = gs_update(Ua[L], Ba[L], acc, st);
  }
}

// The 4 (or, symmetric, 8) color steps 00 01 10 11 [11 10 01 00].
template <int W>
__device__ void color_steps(float* U, const float* B, const Stencil& st,
                            int M, int J0, int I0, int symmetric) {
  const int n = symmetric ? 8 : 4;
  for (int k = 0; k < n; ++k) {
    switch (k < 4 ? k : 7 - k) {
      case 0: color_step<W, 0, 0>(U, B, st, M, J0, I0); break;
      case 1: color_step<W, 0, 1>(U, B, st, M, J0, I0); break;
      case 2: color_step<W, 1, 0>(U, B, st, M, J0, I0); break;
      default: color_step<W, 1, 1>(U, B, st, M, J0, I0); break;
    }
    __syncthreads();
  }
}

// The four quarters' [Jt, Jt+T) x [It, It+T) <- the T x T interior of the
// window (offset G).
template <int T, int G, int Lay = kQuarterMajor>
__device__ void store_interior(const float* U, float* __restrict__ g, int M,
                               int Jt, int It) {
  constexpr int W = T + 2 * G;
  for (int L = threadIdx.x; L < 4 * T * T; L += blockDim.x) {
    const int q = L / (T * T);
    const int rem = L - q * T * T;
    const int r = rem / T;
    const int c = rem - r * T;
    const int J = Jt + r;
    const int I = It + c;
    if (J < M && I < M) g[gidx<Lay>(q, J, I, M)] = U[(q * W + G + r) * W + G + c];
  }
}

// The whole block of the standalone sweep (K1, K9): load u and b with the
// ghost ring, run the color steps, store the tile. The block's tile is
// (blockIdx.y, blockIdx.x); shared memory holds 2 * 4 * (T+2G)^2 floats.
template <int T, int G, int Lay>
__device__ void sweep_block(const float* __restrict__ u,
                            const float* __restrict__ b,
                            float* __restrict__ out, int M,
                            const Stencil& st, int symmetric) {
  constexpr int W = T + 2 * G;
  extern __shared__ float smem[];
  float* U = smem;
  float* B = smem + 4 * W * W;
  const int Jt = blockIdx.y * T;
  const int It = blockIdx.x * T;
  load_tile<W, Lay>(U, u, M, Jt - G, It - G);
  load_tile<W, Lay>(B, b, M, Jt - G, It - G);
  __syncthreads();
  color_steps<W>(U, B, st, M, Jt - G, It - G, symmetric);
  store_interior<T, G, Lay>(U, out, M, Jt, It);
}

// Residual of color (PJ, PI) at cell (r, c) of a [4][H][W] window,
// overwriting b there: sparse/packed.py residual_packed, acc = _acc + w_c *
// u_a, r = b - acc on real cells, 0 elsewhere. A cell's residual reads b
// only at that cell. kEdge false: the caller knows the cell is real.
template <int H, int W, int PJ, int PI, bool kBounds = true,
          bool kEdge = true, int kPat = kAnyWeights>
__device__ __forceinline__ void residual_cell(const float* U, float* B,
                                              const Stencil& st, int M,
                                              int J0, int I0, int r, int c) {
  constexpr int a = 2 * PJ + PI;
  const int L = (a * H + r) * W + c;
  const float acc = neighbour_acc<H, W, PJ, PI, kBounds, kPat>(U, st, r, c)
                    + st.w[4] * U[L];
  B[L] = (!kEdge || real_cell(a, J0 + r, I0 + c, M)) ? B[L] - acc : 0.f;
}

// The residual in place of b on window rows and columns [G, G + T] of all
// four quarters: the (T+1)^2 cells the restriction of the tile reads. It
// reads u one cell further out, so the ghost ring must be >= 2.
template <int T, int G>
__device__ void residual_window(const float* U, float* B, const Stencil& st,
                                int M, int J0, int I0) {
  constexpr int W = T + 2 * G;
  constexpr int R = T + 1;
  for (int L = threadIdx.x; L < 4 * R * R; L += blockDim.x) {
    const int q = L / (R * R);
    const int rem = L - q * R * R;
    const int r = G + rem / R;
    const int c = G + rem % R;
    switch (q) {
      case 0: residual_cell<W, W, 0, 0>(U, B, st, M, J0, I0, r, c); break;
      case 1: residual_cell<W, W, 0, 1>(U, B, st, M, J0, I0, r, c); break;
      case 2: residual_cell<W, W, 1, 0>(U, B, st, M, J0, I0, r, c); break;
      default: residual_cell<W, W, 1, 1>(U, B, st, M, J0, I0, r, c); break;
    }
  }
}

// The full-weighting restriction at window cell (r, c) of the residual R,
// a [4][H][W] window: r11 + 0.5*(r01[r,c] + r01[r+1,c] + r10[r,c] +
// r10[r,c+1]) + 0.25*(r00 at r..r+1 x c..c+1), in the restrict_packed
// summation order.
template <int H, int W>
__device__ __forceinline__ float restrict_cell(const float* R, int r, int c) {
  auto R_ = [&](int q, int rr, int cc) { return R[(q * H + rr) * W + cc]; };
  float v = R_(3, r, c);
  v = v + 0.5f * (((R_(1, r, c) + R_(1, r + 1, c)) + R_(2, r, c))
                  + R_(2, r, c + 1));
  v = v + 0.25f * (((R_(0, r, c) + R_(0, r, c + 1)) + R_(0, r + 1, c))
                   + R_(0, r + 1, c + 1));
  return v;
}

// bc[Jt:Jt+T, It:It+T] of the (M, M) padded coarse rhs <- the restriction
// of the residual R (window offset G); 0 on the pad row and column (index
// m = M-1).
template <int T, int G>
__device__ void restrict_store(const float* R, float* __restrict__ bc, int M,
                               int Jt, int It) {
  constexpr int W = T + 2 * G;
  const int m = M - 1;
  for (int L = threadIdx.x; L < T * T; L += blockDim.x) {
    const int jj = L / T;
    const int ii = L - jj * T;
    const int J = Jt + jj;
    const int I = It + ii;
    if (J >= M || I >= M) continue;
    const float v = (J < m && I < m) ? restrict_cell<W, W>(R, G + jj, G + ii)
                                     : 0.f;
    bc[(size_t)J * M + I] = v;
  }
}

}  // namespace amg
