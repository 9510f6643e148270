// K6: one fused (symmetric) four-color Gauss-Seidel sweep on the unpacked
// (n, n) f32 layout with nine (n, n) coefficient planes (the contiguous
// (3, 3, n, n) planes, plane p = 3 * (dj + 1) + (di + 1)).
//
// Replaces the TPU kernel amg_tpu/ops/pallas/rbgs.py fused_gs4_sweep,
// pallas_call :584 (var; bodies _sweep_kernel, _sweep_kernel_db). What it
// computes (rbgs.py:86-174): colors (0,0) (0,1) (1,0) (1,1) by row and
// column parity, then reversed when symmetric; a cell of the current color
// becomes u + omega * ((b - sum_off c * u_nbr) * (1 / c_diag) - u), the
// off-diagonal terms summed dj outer, di inner, none skipped, neighbours
// outside the grid reading 0 (Dirichlet). Built with -fmad=false and an
// IEEE 1/c_diag, so the kernel gives the plain version's bits
// (amg_tpu_torch/ops/kernels/rbgs.py fused_gs4_sweep_plain).
//
// Bound on the card: device memory. u, b and the nine planes read once and
// u written once: 48 B a cell, 0.240 ms at n = 4095 (3.35 TB/s).
//
// Design. A block owns a 32 x 64 tile of grid cells and holds u's and b's
// windows, with a ring of TOP / BOT rows and LEFT / RIGHT columns, in
// shared memory (cp.async, 4-byte copies: a row of an odd n is not 16-byte
// aligned; zero-filled outside [0, n)^2). A thread owns one window column
// and every NY-th row pair, so a warp reads 32 neighbouring cells of a
// plane: every sector it pulls is used whole. 78 x 9 = 702 threads, two
// blocks an SM; a thread holds the coefficients of at most 2 rows.
//
// The ring, its even alignment and the per-step update regions are
// rbgs_common.cuh's, shared with K5 (rbgs_sweep.cu).
//
// The planes. Each step updates only the cells of its color that can still
// reach the tile (the trapezoid of temporal blocking; rbgs::margin).
// A row of one parity is updated twice in a row of steps by the two column
// parities (steps 0-1: row parity 0; 2-5: row parity 1; 6-7: row parity 0
// again), so the block loads a row's coefficients for both column parities
// in one step, through the read-only path into registers, and keeps them
// (8 off-diagonal values and 1 / c_diag, computed once) for the steps that
// need them: the planes are read at steps 0, 2 and (symmetric) 6, the last
// only on the tile's own rows. Design bytes at n = 4095 with a 32 x 64
// tile (38 x 78 window): u and b windows 2 x 4 x 1.45, planes 36 x 1.26
// where L2 catches the step-6 reread, u written 4: about 61 B a cell.
// Loads for steps 2 and 6 are issued before the barrier that ends the step
// before, while the other block of the SM computes. Other tiles, row
// phases and blocks an SM were slower on the H100 (PERF.md lists them).
//
// K12 (masked_var_sweep_kernel): the same block with the update rule of
// the plain masked sweep, sparse/stencil.py gs4_sweep_masked (the port's
// own kernel; JAX sweeps these levels with plain jnp ops). A cell of the
// step's color becomes u + omega * ((b - sum_all c * u) * (1 / c_diag)):
// all nine terms summed dj outer, di inner, the diagonal in its place, as
// Stencil2D.matvec2 orders them, and an IEEE 1 / c_diag as torch's
// reciprocal rounds it. The other cells keep u (the plain sweep adds 0 *
// g there: the same value up to the sign of a zero). A thread keeps the
// nine coefficients of a row in registers, as many as K6 keeps, and 1 /
// c_diag, divided once at the load, in a third window array in shared
// memory, a slot a cell that only the loading thread reads: a division at
// each update spilled under K6's bound of 40 registers a thread.
// Built as K6 is, the kernel gives gs4_sweep_masked's bits with parity
// masks; the ring and the regions hold for it as for any 3x3 rule of
// this reach (tests/test_torch_tiling_rbgs.py).

#include "rbgs_common.cuh"

namespace {

// The tile (rows, columns), the row phases and the blocks an SM.
constexpr int kTJ = 32;
constexpr int kTI = 64;
constexpr int kNY = 9;
constexpr int kBlocks = 2;

using rbgs::margin;
using rbgs::Phase;

// The update rules. load keeps a row's coefficients of one cell in cf (and
// may keep what it derives in the window slot X[L] of the cell, a slot
// only the thread that loaded the row reads); update returns the cell's
// new value.

// K6's rule: the eight off-diagonal coefficients (dj outer, di inner) and
// 1 / c_diag, computed once at the load.
struct FusedRule {
  __device__ __forceinline__ static void load(float (&cf)[9],
                                              const float* __restrict__ p,
                                              size_t nn, float*, int) {
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      if (m == 4) continue;
      cf[m < 4 ? m : m - 1] = __ldg(p + m * nn);
    }
    cf[8] = 1.0f / __ldg(p + 4 * nn);
  }

  template <int W>
  __device__ __forceinline__ static float update(const float (&cf)[9],
                                                 const float* U,
                                                 const float* B,
                                                 const float*, int r, int x,
                                                 float omega) {
    float acc = 0.f;
    int m = 0;
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
      for (int di = -1; di <= 1; ++di) {
        if (dj == 0 && di == 0) continue;
        acc = acc + cf[m++] * U[(r + dj) * W + x + di];
      }
    }
    const int L = r * W + x;
    const float uu = U[L];
    const float delta = (B[L] - acc) * cf[8] - uu;
    return uu + omega * delta;
  }
};

// K12's rule: the nine coefficients in the planes' order (c_diag at 4) in
// registers, 1 / c_diag computed once at the load and kept in the cell's
// slot (a division at each update spilled under K6's register bound).
struct MaskedRule {
  __device__ __forceinline__ static void load(float (&cf)[9],
                                              const float* __restrict__ p,
                                              size_t nn, float* X, int L) {
#pragma unroll
    for (int m = 0; m < 9; ++m) cf[m] = __ldg(p + m * nn);
    X[L] = 1.0f / cf[4];
  }

  template <int W>
  __device__ __forceinline__ static float update(const float (&cf)[9],
                                                 const float* U,
                                                 const float* B,
                                                 const float* X, int r,
                                                 int x, float omega) {
    float acc = 0.f;
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
      for (int di = -1; di <= 1; ++di)
        acc = acc + cf[3 * (dj + 1) + di + 1] * U[(r + dj) * W + x + di];
    }
    const int L = r * W + x;
    const float g = (B[L] - acc) * X[L];
    return U[L] + omega * g;
  }
};

// Per-thread state of one load phase: the coefficients of rows R0 +
// 2 (y + NY k) of the thread's column (the rule's nine values a row), and
// whether each cell is updated.
template <int K>
struct Rows {
  float cf[K][9];
  bool on[K];
};

template <class V, class R, int PH>
__device__ __forceinline__ void load_rows(Rows<Phase<V, PH>::K>& s,
                                          const float* __restrict__ c,
                                          int n, int Jt, int It, float* X) {
  using F = Phase<V, PH>;
  const int t = (int)threadIdx.x - V::LEFT;    // tile column
  constexpr int l0 = margin(V::kSym, PH, 2), r0 = margin(V::kSym, PH, 3);
  constexpr int l1 = margin(V::kSym, PH, 4), r1 = margin(V::kSym, PH, 5);
  const bool col = (t & 1) ? t >= -l1 && t <= V::TI - 1 + r1
                           : t >= -l0 && t <= V::TI - 1 + r0;
  const int i = It + t;
  const size_t nn = (size_t)n * n;
#pragma unroll
  for (int k = 0; k < F::K; ++k) {
    const int q = (int)threadIdx.y + V::NY * k;
    const int j = Jt + F::R0 + 2 * q;
    const bool on = col && q < F::NR && j >= 0 && j < n && i >= 0 && i < n;
    s.on[k] = on;
    if (on)
      R::load(s.cf[k], c + (size_t)j * n + i, nn, X,
              (V::TOP + F::R0 + 2 * q) * V::W + (int)threadIdx.x);
  }
}

// One color step, column parity PI, on the rows of load phase PH.
template <class V, class R, int PH, int PI>
__device__ __forceinline__ void update_rows(float* U, const float* B,
                                            const float* X,
                                            const Rows<Phase<V, PH>::K>& s,
                                            float omega) {
  using F = Phase<V, PH>;
  if (((int)threadIdx.x & 1) != PI) return;    // LEFT is even
  const int x = threadIdx.x;
#pragma unroll
  for (int k = 0; k < F::K; ++k) {
    if (!s.on[k]) continue;
    const int r = V::TOP + F::R0 + 2 * ((int)threadIdx.y + V::NY * k);
    U[r * V::W + x] = R::template update<V::W>(s.cf[k], U, B, X, r, x,
                                               omega);
  }
}

// The block: load the windows, run the color steps, write the tile.
template <class V, class R>
__device__ __forceinline__ void sweep_block(
    const float* __restrict__ u, const float* __restrict__ b,
    const float* __restrict__ c, float* __restrict__ out, int n, float omega,
    float* U, float* Bw, float* X) {
  const int Jt = (int)blockIdx.y * V::TJ;
  const int It = (int)blockIdx.x * V::TI;
  const int j0 = Jt - V::TOP;
  const int i0 = It - V::LEFT;
  {
    const int i = i0 + (int)threadIdx.x;
    const bool in_i = i >= 0 && i < n;
#pragma unroll
    for (int k = 0; k < (V::H + V::NY - 1) / V::NY; ++k) {
      const int r = (int)threadIdx.y + V::NY * k;
      if (r >= V::H) break;
      const int j = j0 + r;
      const bool in = in_i && j >= 0 && j < n;
      const size_t g = in ? (size_t)j * n + i : 0;
      const int L = r * V::W + (int)threadIdx.x;
      const unsigned su = (unsigned)__cvta_generic_to_shared(U + L);
      const unsigned sb = (unsigned)__cvta_generic_to_shared(Bw + L);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(su), "l"(u + g), "r"(in ? 4 : 0) : "memory");
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(sb), "l"(b + g), "r"(in ? 4 : 0) : "memory");
    }
  }
  {
    Rows<Phase<V, 0>::K> a;
    load_rows<V, R, 0>(a, c, n, Jt, It, X);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    update_rows<V, R, 0, 0>(U, Bw, X, a, omega);          // step 0: 00
    __syncthreads();
    update_rows<V, R, 0, 1>(U, Bw, X, a, omega);          // step 1: 01
  }
  Rows<Phase<V, 1>::K> bs;
  load_rows<V, R, 1>(bs, c, n, Jt, It, X);
  __syncthreads();
  update_rows<V, R, 1, 0>(U, Bw, X, bs, omega);           // step 2: 10
  __syncthreads();
  update_rows<V, R, 1, 1>(U, Bw, X, bs, omega);           // step 3: 11
  __syncthreads();
  if constexpr (V::kSym) {
    update_rows<V, R, 1, 1>(U, Bw, X, bs, omega);         // step 4: 11
    __syncthreads();
    update_rows<V, R, 1, 0>(U, Bw, X, bs, omega);         // step 5: 10
    Rows<Phase<V, 2>::K> cs;
    load_rows<V, R, 2>(cs, c, n, Jt, It, X);
    __syncthreads();
    update_rows<V, R, 2, 1>(U, Bw, X, cs, omega);         // step 6: 01
    __syncthreads();
    update_rows<V, R, 2, 0>(U, Bw, X, cs, omega);         // step 7: 00
    __syncthreads();
  }

  // the tile: window rows TOP .. TOP + TJ - 1, columns LEFT .. LEFT + TI - 1
  const int t = (int)threadIdx.x - V::LEFT;
  const int i = It + t;
  if (t < 0 || t >= V::TI || i >= n) return;
#pragma unroll
  for (int k = 0; k < (V::TJ + V::NY - 1) / V::NY; ++k) {
    const int r = (int)threadIdx.y + V::NY * k;
    if (r >= V::TJ || Jt + r >= n) break;
    out[(size_t)(Jt + r) * n + i] = U[(V::TOP + r) * V::W + threadIdx.x];
  }
}

template <class V>
__global__ void __launch_bounds__(V::NT, kBlocks)
rbgs_var_kernel(const float* __restrict__ u, const float* __restrict__ b,
                const float* __restrict__ c, float* __restrict__ out, int n,
                float omega) {
  __shared__ float U[V::H * V::W];
  __shared__ float Bw[V::H * V::W];
  sweep_block<V, FusedRule>(u, b, c, out, n, omega, U, Bw, nullptr);
}

template <class V>
__global__ void __launch_bounds__(V::NT, kBlocks)
masked_var_sweep_kernel(const float* __restrict__ u,
                        const float* __restrict__ b,
                        const float* __restrict__ c, float* __restrict__ out,
                        int n, float omega) {
  __shared__ float U[V::H * V::W];
  __shared__ float Bw[V::H * V::W];
  __shared__ float Inv[V::H * V::W];   // 1 / c_diag of the loaded rows
  static_assert(3 * V::H * V::W * sizeof(float) <= 48 * 1024, "static smem");
  sweep_block<V, MaskedRule>(u, b, c, out, n, omega, U, Bw, Inv);
}

template <bool kSym, bool kMasked>
int launch(const float* u, const float* b, const float* c, float* out, int n,
           float omega, cudaStream_t stream) {
  using V = rbgs::Tiling<kTJ, kTI, kNY, kSym>;
  const dim3 grid((n + V::TI - 1) / V::TI, (n + V::TJ - 1) / V::TJ);
  if constexpr (kMasked)
    masked_var_sweep_kernel<V><<<grid, dim3(V::NX, V::NY), 0, stream>>>(
        u, b, c, out, n, omega);
  else
    rbgs_var_kernel<V><<<grid, dim3(V::NX, V::NY), 0, stream>>>(
        u, b, c, out, n, omega);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int amg_rbgs_sweep_var(const float* u, const float* b,
                                  const float* c, float* out, int n,
                                  float omega, int symmetric,
                                  cudaStream_t stream) {
  return symmetric ? launch<true, false>(u, b, c, out, n, omega, stream)
                   : launch<false, false>(u, b, c, out, n, omega, stream);
}

// K12: the plain masked sweep's rule on K6's block.
extern "C" int amg_masked_sweep_var(const float* u, const float* b,
                                    const float* c, float* out, int n,
                                    float omega, int symmetric,
                                    cudaStream_t stream) {
  return symmetric ? launch<true, true>(u, b, c, out, n, omega, stream)
                   : launch<false, true>(u, b, c, out, n, omega, stream);
}
