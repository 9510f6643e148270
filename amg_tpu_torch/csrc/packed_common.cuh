// Shared device code of the color-packed kernels. One copy of each piece,
// used as follows:
//
//   piece                               K1  K2  K3  K8  K9
//   gidx / real_cell / set_smem_once    x   x   x   x   x
//   neighbour_acc                       x   x   x   x   x
//   gs_update                           x   x   x       x
//   Tiling, load_window, window_inside  x   x   x   x   x
//     (the windowed block)
//   window_sweep, store_tile            x   x   x       x
//   residual_cell / restrict_cell,          x       x
//     tile_residual, store_restriction
//
// K1 and K9 packed_sweep.cu (one kernel, two layouts), K2/K3/K8
// packed_cycle.cu.
//
// Layout (amg_tpu_torch/sparse/packed.py): a field holds four (M, M) f32
// quarters, quarter a = 2*pj + pi holding the points (2J+pj, 2I+pi). With
// kQuarterMajor (the (4, M, M) packed field) quarter q, row J, column I
// sit at (q*M + J)*M + I; with kRowGrouped (the (M, 4M) row-grouped field
// of ops/kernels/packed_rm.py) at J*4M + q*M + I. Quarter a's real cells
// are J < Mj, I < Mi with Mj = M - pj, Mi = M - pi; every other cell is a
// pad cell that stays exactly 0, and a read outside [0, M)^2 reads 0.
// Together they are the Dirichlet boundary. Shared-memory windows are
// always [4][H][W], whatever the layout in device memory.
//
// Temporal blocking: a block holds a tile of all four quarters plus a ghost
// ring in shared memory and runs all the color steps there. The window's
// edge cells cannot be updated exactly (their neighbours lie outside), and
// the wrong values spread inwards with the color steps; the ring keeps them
// off the cells the block stores.
//
// The windowed block (Tiling; every kernel here): a TJ x TI tile in a
// window of H = TJ + 2 GJ rows and W = TI + 2 GI columns. The color steps
// update the window's inner (H-2) x (W-2) cells and never its outermost
// ones, so every update reads inside the window without a bounds test. How
// far do the wrong values reach? A color step of parity (pj, pi) reads fine
// neighbours at most one fine row and column away, so along a chain of
// steps a wrong value moves one fine row only where the row parity changes
// and one fine column where the column parity changes. In the 8 steps 00
// 01 10 11 11 10 01 00 the row parity changes twice and the column parity
// up to six times (9-point weights; twice with 5-point ones). From the
// frozen outer cells (fine rows and columns 0-1 of each edge) the wrong
// values therefore stay in the outer 2 packed rows and 4 packed columns:
// GJ = 2, GI = 4 keep a sweep's tile exact (K1, K3, K9). K2's residual
// reads one fine point further and its restriction one cell past the tile:
// GJ >= 3, GI >= 5 (it takes 6 and 8). K8 has no color steps: the
// restriction reads the residual one cell past the tile, and the residual
// it reads reads u one more cell out at most, so GJ = GI = 1 is exact; it
// takes 2 and 4, because it computes every quarter's residual on the
// tile's (TJ+1) x (TI+1) cells without a bounds test (2 cells past the
// tile) and keeps 16-byte rows. The layout changes only the addresses of
// the window's rows in device memory, not what the block computes.
// tests/test_torch_tiling.py emulates the blocks on the CPU: these rings
// are bitwise exact, one row or one column less is not.
//
// Arithmetic order equals the plain PyTorch version term by term, and the
// library is built with -fmad=false, so no product is contracted into an
// FMA: on equal inputs the kernels give the plain version's bits.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>
#include <type_traits>

namespace amg {

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

// ---------------------------------------------------------------------------
// The windowed block (see the note at the top). A block of NX x NY threads,
// a thread per window column and NY row phases, holds u and b's windows:
// 2 x 4 x H x W floats of shared memory. Window row 0 is packed row J0 =
// Jt - GJ, column 0 is I0 = It - GI, for the block's tile (Jt, It) =
// (blockIdx.y * TJ, blockIdx.x * TI).
template <int TJ_, int TI_, int GJ_, int GI_, int NY_>
struct Tiling {
  static constexpr int TJ = TJ_;         // tile rows, cells of each quarter
  static constexpr int TI = TI_;         // tile columns
  static constexpr int GJ = GJ_;         // ghost rows above and below
  static constexpr int GI = GI_;         // ghost columns left and right
  static constexpr int H = TJ + 2 * GJ;  // window rows
  static constexpr int W = TI + 2 * GI;  // window columns
  static constexpr int NX = W;
  static constexpr int NY = NY_;
  static constexpr int NT = NX * NY;
  static constexpr size_t kSmem = 2 * 4 * H * W * sizeof(float);
  // blocks an SM holds (228 KB of shared memory, 1 KB reserved a block)
  static constexpr int kBlocks = (233472 / (kSmem + 1024)) > 1 ? 2 : 1;
  static_assert(W % 4 == 0 && GI % 4 == 0 && TI % 4 == 0,
                "16-byte window rows");
  static_assert(TJ > GJ && TI > GI, "only the first tiles' windows start "
                "before row or column 1");
  static_assert(kSmem <= 232448, "one block's shared memory");
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async(float* s, const float* g, int bytes,
                                         bool in) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(sa), "l"(g), "r"(in ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(sa), "l"(g), "r"(in ? 4 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// S[4][H][W] <- the four quarters' [J0, J0+H) x [I0, I0+W) windows of g
// in layout Lay, 0 outside [0, M)^2, as cp.async copies in flight (the
// caller waits). vec: 16-byte copies (M % 4 == 0, I0 % 4 == 0, g 16-byte
// aligned), so a chunk lies wholly inside or outside [0, M); a quarter's
// row segment starts at a multiple of 4 floats in both layouts.
template <class Tl, int Lay = kQuarterMajor>
__device__ __forceinline__ void load_window(float* S,
                                            const float* __restrict__ g,
                                            int M, int J0, int I0, bool vec) {
  const int tid = threadIdx.x + Tl::NX * threadIdx.y;
  if (vec) {
    constexpr int CH = Tl::W / 4;      // chunks per window row
    constexpr int N = 4 * Tl::H * CH;
#pragma unroll
    for (int k = 0; k < (N + Tl::NT - 1) / Tl::NT; ++k) {
      const int L = tid + Tl::NT * k;
      if (L >= N) break;
      const int qr = L / CH;           // quarter * H + row
      const int ch = L - qr * CH;
      const int q = qr / Tl::H;
      const int J = J0 + qr - q * Tl::H;
      const int I = I0 + 4 * ch;
      const bool in = J >= 0 && J < M && I >= 0 && I < M;
      cp_async(S + qr * Tl::W + 4 * ch,
               in ? g + gidx<Lay>(q, J, I, M) : g, 16, in);
    }
  } else {
    const int I = I0 + threadIdx.x;
#pragma unroll 4
    for (int k = 0; k < (4 * Tl::H + Tl::NY - 1) / Tl::NY; ++k) {
      const int qr = threadIdx.y + Tl::NY * k;
      if (qr >= 4 * Tl::H) break;
      const int q = qr / Tl::H;
      const int J = J0 + qr - q * Tl::H;
      const bool in = J >= 0 && J < M && I >= 0 && I < M;
      cp_async(S + qr * Tl::W + threadIdx.x,
               in ? g + gidx<Lay>(q, J, I, M) : g, 4, in);
    }
  }
}

// Every window cell real in every quarter: the color steps test no cell.
// The condition is uniform over the block.
template <class Tl>
__device__ __forceinline__ bool window_inside(int M, int J0, int I0) {
  return J0 >= 0 && I0 >= 0 && J0 + Tl::H <= M - 1 && I0 + Tl::W <= M - 1;
}

// One color step on the window's inner (H-2) x (W-2) cells: column 1 + x,
// rows 1 + y + NY k. kEdge: test each cell for being real.
template <class Tl, int PJ, int PI, bool kEdge, int kPat>
__device__ __forceinline__ void window_step(float* U, const float* B,
                                            const Stencil& st, int M,
                                            int J0, int I0) {
  constexpr int a = 2 * PJ + PI;
  const int c = 1 + threadIdx.x;
  if (c > Tl::W - 2) return;
#pragma unroll
  for (int k = 0; k < (Tl::H - 2 + Tl::NY - 1) / Tl::NY; ++k) {
    const int r = 1 + threadIdx.y + Tl::NY * k;
    if (r > Tl::H - 2) break;
    if (kEdge && !real_cell(a, J0 + r, I0 + c, M)) continue;
    const int L = (a * Tl::H + r) * Tl::W + c;
    const float acc =
        neighbour_acc<Tl::H, Tl::W, PJ, PI, false, kPat>(U, st, r, c);
    U[L] = gs_update(U[L], B[L], acc, st);
  }
}

// The 4 (or, symmetric, 8) color steps 00 01 10 11 [11 10 01 00], each
// followed by a barrier.
template <class Tl, bool kEdge, int kPat>
__device__ void window_sweep(float* U, const float* B, const Stencil& st,
                             int M, int J0, int I0, int symmetric) {
  const int n = symmetric ? 8 : 4;
  for (int k = 0; k < n; ++k) {
    switch (k < 4 ? k : 7 - k) {
      case 0: window_step<Tl, 0, 0, kEdge, kPat>(U, B, st, M, J0, I0); break;
      case 1: window_step<Tl, 0, 1, kEdge, kPat>(U, B, st, M, J0, I0); break;
      case 2: window_step<Tl, 1, 0, kEdge, kPat>(U, B, st, M, J0, I0); break;
      default: window_step<Tl, 1, 1, kEdge, kPat>(U, B, st, M, J0, I0); break;
    }
    __syncthreads();
  }
}

// The four quarters' [Jt, Jt+TJ) x [It, It+TI) of out (layout Lay) <- the
// window's tile: 16-byte stores where the tile lies inside [0, M)^2 and vec
// holds.
template <class Tl, int Lay = kQuarterMajor>
__device__ __forceinline__ void store_tile(const float* U,
                                           float* __restrict__ out, int M,
                                           int Jt, int It, bool vec) {
  const int tid = threadIdx.x + Tl::NX * threadIdx.y;
  if (vec && Jt + Tl::TJ <= M && It + Tl::TI <= M) {
    constexpr int N = 4 * Tl::TJ * Tl::TI / 4;  // float4s of the tile
#pragma unroll
    for (int k = 0; k < (N + Tl::NT - 1) / Tl::NT; ++k) {
      const int L = tid + Tl::NT * k;
      if (L >= N) break;
      const int q = L / (Tl::TJ * Tl::TI / 4);
      const int r = (L / (Tl::TI / 4)) % Tl::TJ;
      const int c = 4 * (L % (Tl::TI / 4));
      *reinterpret_cast<float4*>(out + gidx<Lay>(q, Jt + r, It + c, M)) =
          *reinterpret_cast<const float4*>(
              U + (q * Tl::H + Tl::GJ + r) * Tl::W + Tl::GI + c);
    }
  } else {
    constexpr int N = 4 * Tl::TJ * Tl::TI;
    for (int L = tid; L < N; L += Tl::NT) {
      const int q = L / (Tl::TJ * Tl::TI);
      const int r = (L / Tl::TI) % Tl::TJ;
      const int c = L % Tl::TI;
      if (Jt + r < M && It + c < M)
        out[gidx<Lay>(q, Jt + r, It + c, M)] =
            U[(q * Tl::H + Tl::GJ + r) * Tl::W + Tl::GI + c];
    }
  }
}

// Launch kernel<kPat> for the zero pattern of w9 (kFivePoint, kNinePoint or
// kAnyWeights): launch is a callable template taking the pattern as an
// integral_constant.
template <typename Launch>
inline int by_weight_pattern(const float* w9, Launch launch) {
  switch (weight_pattern(w9)) {
    case kFivePoint:
      return launch(std::integral_constant<int, kFivePoint>());
    case kNinePoint:
      return launch(std::integral_constant<int, kNinePoint>());
    default:
      return launch(std::integral_constant<int, kAnyWeights>());
  }
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

// The residual in place of b on window rows [GJ, GJ + TJ] and columns
// [GI, GI + TI] of all four quarters: the (TJ + 1) x (TI + 1) cells the
// tile's restriction reads. Thread (x, y) takes column GI + x, rows GJ + y
// + NY k. kEdge: test each cell for being real.
template <class Tl, bool kEdge, int kPat>
__device__ __forceinline__ void tile_residual(const float* U, float* B,
                                              const Stencil& st, int M,
                                              int J0, int I0) {
  if (threadIdx.x > Tl::TI) return;
  const int c = Tl::GI + threadIdx.x;
#pragma unroll
  for (int k = 0; k < (Tl::TJ + Tl::NY) / Tl::NY; ++k) {
    const int r = Tl::GJ + threadIdx.y + Tl::NY * k;
    if (r > Tl::GJ + Tl::TJ) break;
    residual_cell<Tl::H, Tl::W, 0, 0, false, kEdge, kPat>(U, B, st, M, J0,
                                                          I0, r, c);
    residual_cell<Tl::H, Tl::W, 0, 1, false, kEdge, kPat>(U, B, st, M, J0,
                                                          I0, r, c);
    residual_cell<Tl::H, Tl::W, 1, 0, false, kEdge, kPat>(U, B, st, M, J0,
                                                          I0, r, c);
    residual_cell<Tl::H, Tl::W, 1, 1, false, kEdge, kPat>(U, B, st, M, J0,
                                                          I0, r, c);
  }
}

// bc[Jt:Jt+TJ, It:It+TI] of the (M, M) padded coarse rhs <- the
// restriction of the residual R (the window of tile_residual), neighbouring
// threads on neighbouring columns; 0 on the pad row and column (m = M-1).
template <class Tl>
__device__ __forceinline__ void store_restriction(const float* R,
                                                  float* __restrict__ bc,
                                                  int M, int Jt, int It) {
  const int tid = threadIdx.x + Tl::NX * threadIdx.y;
  const int m = M - 1;
#pragma unroll
  for (int k = 0; k < (Tl::TJ * Tl::TI + Tl::NT - 1) / Tl::NT; ++k) {
    const int L = tid + Tl::NT * k;
    if (L >= Tl::TJ * Tl::TI) break;
    const int jj = L / Tl::TI;
    const int ii = L % Tl::TI;
    const int J = Jt + jj;
    const int I = It + ii;
    if (J >= M || I >= M) continue;
    bc[(size_t)J * M + I] =
        (J < m && I < m)
            ? restrict_cell<Tl::H, Tl::W>(R, Tl::GJ + jj, Tl::GI + ii)
            : 0.f;
  }
}

}  // namespace amg
