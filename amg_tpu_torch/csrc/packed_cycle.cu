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
// full down leg does not fit VMEM). It reads u and b with a ghost ring of
// G = 2 and writes bc: (4 + 4) * (36/32)^2 + 1 = 11.1 bytes per packed cell,
// against a floor of 9 (u and b once, bc once).
//
// Bound on the card: device-memory traffic. The floor is u and b read once,
// u and a quarter-size bc written once: 13 bytes per packed cell. K3 reads u
// and b with G = 8 plus the coarse field (about 1 byte per packed cell, from
// L2) and writes u: about 23 bytes per packed cell.
//
// K2's design. A block of 640 threads (80 x 8) holds a tile of 32 rows x 64
// columns of all four quarters in a 44 x 80 window (rows J0 = Jt - 6 ...,
// columns I0 = It - 8 ...): 2 fields x 4 quarters x 44 x 80 x 4 B =
// 112,640 B of shared memory, so two blocks share an SM and one block's
// loads overlap the other's color steps. The ring is what exactness needs,
// not one cell per color step: a color step reads neighbours one fine grid
// point away, so the wrong values next to the window's edge advance one
// fine point (half a packed cell) per step. The window's outermost cells
// are never updated, so every update reads inside the window without a
// bounds test; after 8 steps the wrong points reach fine distance 1 + 8
// from the edge, the residual one more, and the restriction of tile row Jt
// reads fine rows 2 Jt to 2 Jt + 2 DTJ: a ring of 6 packed cells is the
// least that keeps every stored value exact. The columns take 8 so that
// each window row starts on a 16-byte boundary. That is (4 + 4) * (44 *
// 80) / (32 * 64) + 4 + 1 = 18.75 bytes per packed cell; each color step
// sweeps 42 x 78 cells for the tile's 32 x 64, 1.60x (the earlier 32 x 32
// tile with a ring of 10 read 26 bytes per cell and swept 2.64x).
//
// What bounds it: the SM's instruction issue in the color steps (about 20
// instructions a cell update) and, without a second block, the window
// load's latency. A 64 x 64 tile (76 x 80 window, 194,560 B, one block an
// SM, 16.9 bytes per cell) moves fewer bytes but leaves the SM idle while it
// loads: on the H100 it is 13-16 % slower at M = 2048 and 4096, and tiles
// of 16 or 24 rows, or 4 or 6 row phases, are slower too (PERF.md lists
// the variants). The zero pattern of the weights is a template parameter
// (5-point, 9-point, other): the plain version skips zero weights, and a
// run-time test per term made the kernel 1.39x slower at M = 2048.
//
// - Loads: u and b go to shared memory through cp.async, all in flight at
//   once, zero-filled outside [0, M)^2 by the copy's source size: 16-byte
//   copies when M % 4 == 0 and the fields are 16-byte aligned (every M of
//   the solver's plans), 4-byte copies otherwise, in the same kernel.
// - Color steps: thread (x, y) updates window column 1 + x of rows 1 + y,
//   9 + y, ...: compile-time trip counts and no divide per cell. Only
//   blocks whose window touches the domain's last rows or columns (or lies
//   outside [0, M - 1)^2) test each cell for being real; the branch is
//   uniform over the block.
// - The residual (in place of b, on the 33 x 65 cells the restriction
//   reads), the u tile (16-byte stores where the tile lies inside) and the
//   restriction are stored from shared memory (packed_common.cuh
//   residual_cell, restrict_cell).
// K3 and K8 use packed_common.cuh's 32 x 32 tiles (load_tile,
// residual_window, restrict_store); K3 applies the correction while loading
// u, since it is a local function of the coarse field at (J-1..J, I-1..I).
// Every kernel sets its shared-memory attribute once per process.

#include "packed_common.cuh"

namespace {

constexpr int T = 32;
constexpr int GU = 8;                  // up-leg ghost ring
constexpr int WU = T + 2 * GU;
constexpr int GR = 2;                  // residual+restrict ghost ring
constexpr int WR = T + 2 * GR;
constexpr size_t kSmemUp = 2 * 4 * WU * WU * sizeof(float);
constexpr size_t kSmemRR = 2 * 4 * WR * WR * sizeof(float);

// K2's tiling (see the note above)
constexpr int DTJ = 32;                // tile rows, cells of each quarter
constexpr int DTI = 64;                // tile columns
constexpr int DGJ = 6;                 // ghost rows above and below
constexpr int DGI = 8;                 // ghost columns left and right
constexpr int DH = DTJ + 2 * DGJ;      // window rows
constexpr int DW = DTI + 2 * DGI;      // window columns
constexpr int DNX = DW;                // block: a thread per window column
constexpr int DNY = 8;                 //   x DNY row phases
constexpr int DNT = DNX * DNY;
constexpr size_t kSmemDown = 2 * 4 * DH * DW * sizeof(float);
// blocks an SM holds (228 KB of shared memory, 1 KB reserved a block)
constexpr int kDownBlocks = (233472 / (kSmemDown + 1024)) > 1 ? 2 : 1;
static_assert(DW % 4 == 0 && DGI % 4 == 0 && DTI % 4 == 0,
              "16-byte window rows");
static_assert(kSmemDown <= 232448, "one block's shared memory");

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

// S[4][DH][DW] <- the four quarters' [J0, J0+DH) x [I0, I0+DW) windows of
// g, 0 outside [0, M)^2, as cp.async copies in flight (the caller waits).
// vec: 16-byte copies (M % 4 == 0, I0 % 4 == 0, g 16-byte aligned), so a
// chunk lies wholly inside or outside [0, M).
__device__ __forceinline__ void load_window(float* S,
                                            const float* __restrict__ g,
                                            int M, int J0, int I0, bool vec) {
  const int tid = threadIdx.x + DNX * threadIdx.y;
  if (vec) {
    constexpr int CH = DW / 4;         // chunks per window row
    constexpr int N = 4 * DH * CH;
#pragma unroll
    for (int k = 0; k < (N + DNT - 1) / DNT; ++k) {
      const int L = tid + DNT * k;
      if (L >= N) break;
      const int qr = L / CH;           // quarter * DH + row
      const int ch = L - qr * CH;
      const int q = qr / DH;
      const int J = J0 + qr - q * DH;
      const int I = I0 + 4 * ch;
      const bool in = J >= 0 && J < M && I >= 0 && I < M;
      cp_async(S + qr * DW + 4 * ch, in ? g + amg::gidx(q, J, I, M) : g, 16,
               in);
    }
  } else {
    const int I = I0 + threadIdx.x;
#pragma unroll 4
    for (int k = 0; k < (4 * DH + DNY - 1) / DNY; ++k) {
      const int qr = threadIdx.y + DNY * k;
      if (qr >= 4 * DH) break;
      const int q = qr / DH;
      const int J = J0 + qr - q * DH;
      const bool in = J >= 0 && J < M && I >= 0 && I < M;
      cp_async(S + qr * DW + threadIdx.x, in ? g + amg::gidx(q, J, I, M) : g,
               4, in);
    }
  }
}

// One color step on the window's inner (DH-2) x (DW-2) cells: column 1 + x,
// rows 1 + y + DNY k. kEdge: test each cell for being real.
template <int PJ, int PI, bool kEdge, int kPat>
__device__ __forceinline__ void down_step(float* U, const float* B,
                                          const amg::Stencil& st, int M,
                                          int J0, int I0) {
  constexpr int a = 2 * PJ + PI;
  const int c = 1 + threadIdx.x;
  if (c > DW - 2) return;
#pragma unroll
  for (int k = 0; k < (DH - 2 + DNY - 1) / DNY; ++k) {
    const int r = 1 + threadIdx.y + DNY * k;
    if (r > DH - 2) break;
    if (kEdge && !amg::real_cell(a, J0 + r, I0 + c, M)) continue;
    const int L = (a * DH + r) * DW + c;
    const float acc =
        amg::neighbour_acc<DH, DW, PJ, PI, false, kPat>(U, st, r, c);
    U[L] = amg::gs_update(U[L], B[L], acc, st);
  }
}

// The 4 (or, symmetric, 8) color steps 00 01 10 11 [11 10 01 00], then the
// residual in place of b on window rows [DGJ, DGJ + DTJ] and columns
// [DGI, DGI + DTI], the cells the tile's restriction reads.
template <bool kEdge, int kPat>
__device__ void down_sweep_residual(float* U, float* B,
                                    const amg::Stencil& st, int M, int J0,
                                    int I0, int symmetric) {
  const int n = symmetric ? 8 : 4;
  for (int k = 0; k < n; ++k) {
    switch (k < 4 ? k : 7 - k) {
      case 0: down_step<0, 0, kEdge, kPat>(U, B, st, M, J0, I0); break;
      case 1: down_step<0, 1, kEdge, kPat>(U, B, st, M, J0, I0); break;
      case 2: down_step<1, 0, kEdge, kPat>(U, B, st, M, J0, I0); break;
      default: down_step<1, 1, kEdge, kPat>(U, B, st, M, J0, I0); break;
    }
    __syncthreads();
  }
  if (threadIdx.x > DTI) return;
  const int c = DGI + threadIdx.x;
#pragma unroll
  for (int k = 0; k < (DTJ + DNY) / DNY; ++k) {
    const int r = DGJ + threadIdx.y + DNY * k;
    if (r > DGJ + DTJ) break;
    amg::residual_cell<DH, DW, 0, 0, false, kEdge, kPat>(U, B, st, M, J0, I0,
                                                         r, c);
    amg::residual_cell<DH, DW, 0, 1, false, kEdge, kPat>(U, B, st, M, J0, I0,
                                                         r, c);
    amg::residual_cell<DH, DW, 1, 0, false, kEdge, kPat>(U, B, st, M, J0, I0,
                                                         r, c);
    amg::residual_cell<DH, DW, 1, 1, false, kEdge, kPat>(U, B, st, M, J0, I0,
                                                         r, c);
  }
}

template <int kPat>
__global__ void __launch_bounds__(DNT, kDownBlocks)
down_leg_kernel(const float* __restrict__ u, const float* __restrict__ b,
                float* __restrict__ u_out, float* __restrict__ bc, int M,
                amg::Stencil st, int symmetric, int vec) {
  extern __shared__ float down_smem[];
  float* U = down_smem;
  float* B = down_smem + 4 * DH * DW;
  const int Jt = blockIdx.y * DTJ;
  const int It = blockIdx.x * DTI;
  const int J0 = Jt - DGJ;
  const int I0 = It - DGI;
  load_window(U, u, M, J0, I0, vec);
  load_window(B, b, M, J0, I0, vec);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // every window cell real in every quarter: no per-cell test
  const bool inside = J0 >= 0 && I0 >= 0 && J0 + DH <= M - 1
                      && I0 + DW <= M - 1;
  if (inside)
    down_sweep_residual<false, kPat>(U, B, st, M, J0, I0, symmetric);
  else
    down_sweep_residual<true, kPat>(U, B, st, M, J0, I0, symmetric);
  __syncthreads();

  const int tid = threadIdx.x + DNX * threadIdx.y;
  if (vec && Jt + DTJ <= M && It + DTI <= M) {
    constexpr int N = 4 * DTJ * DTI / 4;  // float4s of the u tile
#pragma unroll
    for (int k = 0; k < (N + DNT - 1) / DNT; ++k) {
      const int L = tid + DNT * k;
      if (L >= N) break;
      const int q = L / (DTJ * DTI / 4);
      const int r = (L / (DTI / 4)) % DTJ;
      const int c = 4 * (L % (DTI / 4));
      *reinterpret_cast<float4*>(u_out + amg::gidx(q, Jt + r, It + c, M)) =
          *reinterpret_cast<const float4*>(
              U + (q * DH + DGJ + r) * DW + DGI + c);
    }
  } else {
    constexpr int N = 4 * DTJ * DTI;
    for (int L = tid; L < N; L += DNT) {
      const int q = L / (DTJ * DTI);
      const int r = (L / DTI) % DTJ;
      const int c = L % DTI;
      if (Jt + r < M && It + c < M)
        u_out[amg::gidx(q, Jt + r, It + c, M)] =
            U[(q * DH + DGJ + r) * DW + DGI + c];
    }
  }
  const int m = M - 1;
#pragma unroll
  for (int k = 0; k < (DTJ * DTI + DNT - 1) / DNT; ++k) {
    const int L = tid + DNT * k;
    if (L >= DTJ * DTI) break;
    const int jj = L / DTI;
    const int ii = L % DTI;
    const int J = Jt + jj;
    const int I = It + ii;
    if (J >= M || I >= M) continue;
    bc[(size_t)J * M + I] =
        (J < m && I < m) ? amg::restrict_cell<DH, DW>(B, DGJ + jj, DGI + ii)
                         : 0.f;
  }
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

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <int kPat>
int launch_down_leg(const float* u, const float* b, float* u_out, float* bc,
                    int M, const float* w9, float inv_diag, float omega,
                    int symmetric, int vec, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(down_leg_kernel<kPat>,
                                             kSmemDown, attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + DTI - 1) / DTI, (M + DTJ - 1) / DTJ);
  down_leg_kernel<kPat><<<grid, dim3(DNX, DNY), kSmemDown, stream>>>(
      u, b, u_out, bc, M, amg::make_stencil(w9, inv_diag, omega), symmetric,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int amg_down_leg(const float* u, const float* b, float* u_out,
                            float* bc, int M, const float* w9, float inv_diag,
                            float omega, int symmetric, cudaStream_t stream) {
  const int vec = M % 4 == 0 && aligned16(u) && aligned16(b)
                  && aligned16(u_out);
  switch (amg::weight_pattern(w9)) {
    case amg::kFivePoint:
      return launch_down_leg<amg::kFivePoint>(u, b, u_out, bc, M, w9,
                                              inv_diag, omega, symmetric,
                                              vec, stream);
    case amg::kNinePoint:
      return launch_down_leg<amg::kNinePoint>(u, b, u_out, bc, M, w9,
                                              inv_diag, omega, symmetric,
                                              vec, stream);
    default:
      return launch_down_leg<amg::kAnyWeights>(u, b, u_out, bc, M, w9,
                                               inv_diag, omega, symmetric,
                                               vec, stream);
  }
}

extern "C" int amg_up_leg(const float* u, const float* b, const float* uc,
                          float* u_out, int M, const float* w9,
                          float inv_diag, float omega, int symmetric,
                          cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(up_leg_kernel, kSmemUp,
                                             attr_set);
  if (err != cudaSuccess) return (int)err;
  const int nt = (M + T - 1) / T;
  up_leg_kernel<<<dim3(nt, nt), amg::kThreads, kSmemUp, stream>>>(
      u, b, uc, u_out, M, amg::make_stencil(w9, inv_diag, omega), symmetric);
  return (int)cudaGetLastError();
}

extern "C" int amg_residual_restrict(const float* u, const float* b,
                                     float* bc, int M, const float* w9,
                                     cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t err = amg::set_smem_once(residual_restrict_kernel,
                                             kSmemRR, attr_set);
  if (err != cudaSuccess) return (int)err;
  const int nt = (M + T - 1) / T;
  residual_restrict_kernel<<<dim3(nt, nt), amg::kThreads, kSmemRR, stream>>>(
      u, b, bc, M, amg::make_stencil(w9, 0.f, 0.f));
  return (int)cudaGetLastError();
}
