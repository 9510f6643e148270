// K10 and K11: the masked V-cycle of the coarse levels as two one-block
// kernels, the down leg (K10) and the up leg (K11), with the coarsest
// level's direct solve between them.
//
// The port's own kernels: they replace no TPU kernel. JAX runs these
// levels as plain jnp ops (amg_tpu/structured.py cycle_stencil with
// gs4_sweep_masked, matvec2, restrict_mm and prolong_mm), and so did the
// port, one PyTorch kernel an op: a V-cycle entered at 127^2 ran 2,378
// kernels, about 475 a level, on levels that hold 21,333 cells in all.
// Here every level of the cycle from the entry level l0 down to the
// coarsest but one runs in one block, its fields in shared memory:
//
// K10: from level l0 down, on each level the pre-sweeps (masked four-color
//   Gauss-Seidel: colors (0,0) (0,1) (1,0) (1,1), reversed again when
//   symmetric), the residual r = b - A u and the restriction P1^T r P1 into
//   the next level's b, whose u starts at 0. Each level's smoothed u, and
//   each b below l0, go to a workspace in device memory; the coarsest
//   level's b goes to `out`.
// K11: from the coarsest level's solution back up, on each level u +=
//   P1 uc P1^T, then the post-sweeps; level l0's u goes to `out`.
//
// What it computes, bit for bit (the plain twin is
// amg_tpu_torch/ops/kernels/masked_cycle.py masked_down_leg_plain /
// masked_up_leg_plain, the existing ops):
// - a color step updates the cells of one parity class: r = b - sum w u
//   over the nonzero weights in matvec2's order (dj outer, di inner, from
//   0), then u + omega * (r * inv_diag), omega and 1/w_c rounded to f32 on
//   the host; the masked plain form adds exactly 0 * delta elsewhere;
// - the transfers are dense GEMMs on the card (cuBLAS, f32, no TF32), whose
//   every product here is exact (weights 1/2 and 1): an entry of P1^T r,
//   (P1^T r) P1, P1 uc and (P1 uc) P1^T is its nonzero products summed in
//   ascending k, one fused multiply-add a term from 0, the order in which
//   cuBLAS's SGEMM accumulates (checked against torch.mm on the H100 at
//   every side from 255 down); P1^T r is rounded to f32 before the second
//   product, as between the two GEMMs.
// Built with -fmad=false, so no other product is contracted into an FMA.
//
// What bounds it: neither bytes nor operations (a 127^2 cycle moves about
// 0.47 MB, 0.14 us at the memory's 3.35 TB/s) but the ~105
// block-wide barriers between dependent steps, each step's chain of
// dependent instructions on the small levels (~0.3 us a color step at 7^2)
// and the instruction issue of the 127^2 level's color steps (4,096 cells
// a step over 1,024 threads, ~1 us). One block on one SM: the rest of the
// card idles for the cycle's ~80 us of kernel time, in place of ~2,400
// graph nodes at about 1.4 us each. The thread map needs no division: a
// thread takes one column of a quarter (its low bits) and every
// (1024 >> bits)-th row; a color step's neighbour offsets are compile-time
// multiples of the pitch; the loads of a level's fields run four quarters
// and four rows a thread in flight. (A map by division and run-time
// offsets took 66.5 / 57.7 us for K10 / K11 at 127^2, this one 44.2 /
// 35.0 us; PERF.md.)
//
// Shared memory: a level's u and b in the packed layout of
// sparse/packed.py (quarter q = 2 pj + pi holds the points (2J+pj, 2I+pi)),
// each quarter with one ring of zero cells before its first row and column
// (pitch P = M + 1, M = (n+1)/2), so that every neighbour of a real cell,
// -1 <= j, i <= n, reads a real cell or a zero without a bounds test
// (j = n falls on an odd quarter's pad row; b's pad cells are never read).
// Consecutive threads update consecutive cells of one quarter: no bank
// conflict. Then a scratch of n * (n-1)/2 floats for P1^T r (K10) or P1 uc
// (K11). At l0 = 127^2: 2 * 4 * 65^2 + 127 * 63 floats, 167,204 B of the
// 232,448 a block may use; 255^2 would need 662 KB, so the caller's rule
// (fits) keeps l0 <= 127^2 on 2^k - 1 hierarchies. Each level's fields are
// laid out from the start of the region again: the next level's u and b
// are written only once the level's own u is in the workspace and its
// residual consumed.

#include "packed_common.cuh"

constexpr int kMaxLevels = 8;

// What the host passes (ctypes: amg_tpu_torch/ops/kernels/masked_cycle.py
// MaskedCall, field for field); outside the unnamed namespace, so that the
// entry points that take it keep their external names.
struct MaskedCall {
  const float* u;      // K10: level l0's u on entry (n x n)
  const float* b;      // level l0's b (n x n)
  const float* uc;     // K11: the coarsest level's solution
  float* ws;           // the workspace (workspace_floats)
  float* out;          // K10: the coarsest b; K11: level l0's u
  cudaStream_t stream;
  int side;            // n at l0
  int levels;          // levels smoothed: l0 .. l0 + levels - 1
  int sweeps;          // K10: pre-sweeps; K11: post-sweeps
  int symmetric;
  float omega;
  float w[kMaxLevels][9];      // each level's w33, row-major
  float inv_diag[kMaxLevels];  // 1 / w33[1][1]
};

namespace {

constexpr int kThreads = 1024;

struct Params {
  const float* u;
  const float* b;
  const float* uc;
  float* ws;
  float* out;
  int side, levels, sweeps, symmetric;
  float omega;
  float w[kMaxLevels][9];
  float inv_diag[kMaxLevels];
  int pattern[kMaxLevels];     // amg::weight_pattern of each level
};

// log2 of the least power of two >= x (x >= 1)
__device__ __forceinline__ int log2_up(int x) { return 32 - __clz(x - 1); }

// One level's fields in shared memory (see the note at the top).
struct Grid {
  int n, M, P, P2;
  int S;  // log2_up(M): a thread's column in a quarter is its low S bits
  __device__ explicit Grid(int side)
      : n(side), M((side + 1) / 2), P((side + 1) / 2 + 1),
        P2(((side + 1) / 2 + 1) * ((side + 1) / 2 + 1)),
        S(log2_up((side + 1) / 2)) {}
  __device__ int cells() const { return 4 * P2; }
  // fine point (j, i), -1 <= j, i <= n: arithmetic shifts and two's
  // complement parity put j = -1 on the ring row
  __device__ int at(int j, int i) const {
    return (((j & 1) << 1) | (i & 1)) * P2 + ((j >> 1) + 1) * P + (i >> 1)
           + 1;
  }
};

// f(c, j, i) on every real cell c of quarter (PJ, PI), point (j, i): a
// thread takes column I (its low S bits) of rows J, J + kThreads >> S, ...
// (no division; the threads of a warp on neighbouring cells).
template <int PJ, int PI, class F>
__device__ __forceinline__ void each_real(const Grid& g, F f) {
  const int I = threadIdx.x & ((1 << g.S) - 1);
  if (I >= g.M - PI) return;
#pragma unroll 4
  for (int J = threadIdx.x >> g.S; J < g.M - PJ; J += kThreads >> g.S)
    f((2 * PJ + PI) * g.P2 + (J + 1) * g.P + I + 1, 2 * J + PJ, 2 * I + PI);
}

// each_real over the four quarters, the loads of all four in flight
template <class F>
__device__ __forceinline__ void each_real4(const Grid& g, F f) {
  each_real<0, 0>(g, f);
  each_real<0, 1>(g, f);
  each_real<1, 0>(g, f);
  each_real<1, 1>(g, f);
}

// The cells of U that no real cell holds, set to 0: each quarter's ring
// row and column, and an odd quarter's last row or column (packed.py's pad
// cells). Disjoint from the real cells, so in the same step as them.
__device__ __forceinline__ void zero_pads(float* U, const Grid& g) {
  const int x = threadIdx.x;
  if (x >= g.P) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float* Q = U + q * g.P2;
    Q[x] = 0.f;
    Q[x * g.P] = 0.f;
    if (q >> 1) Q[g.M * g.P + x] = 0.f;
    if (q & 1) Q[x * g.P + g.M] = 0.f;
  }
}

// Workspace: level l0's u (n^2 floats), then each lower level's u and b
// (n_k^2 each), level after level; ws_offset(side, k) is level k's start.
__device__ int ws_offset(int side, int k) {
  int off = 0;
  for (int l = 0; l < k; ++l) {
    off += (l == 0 ? 1 : 2) * side * side;
    side = (side - 1) / 2;
  }
  return off;
}

// off[k]: neighbour k = (dj+1) * 3 + (di+1) of a cell of quarter (PJ, PI),
// its index less the cell's (compile-time multiples of P^2, P and 1).
template <int PJ, int PI>
__device__ __forceinline__ void neighbour_offsets(const Grid& g, int* off) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int a = PJ + k / 3 - 1;
    const int c = PI + k % 3 - 1;
    off[k] = ((((a & 1) << 1) | (c & 1)) - (2 * PJ + PI)) * g.P2
             + (a >> 1) * g.P + (c >> 1);
  }
}

// sum w u over the nonzero weights at the cell at index c of U, in
// matvec2's order from 0.
template <int kPat>
__device__ __forceinline__ float stencil_sum(const float* U, const float* w,
                                             const int* off, int c) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (kPat == amg::kFivePoint && (k & 1) == 0 && k != 4) continue;
    if (kPat == amg::kAnyWeights && w[k] == 0.f) continue;
    acc = acc + w[k] * U[c + off[k]];
  }
  return acc;
}

// One level's constants: its weights, 1 / w_c and omega.
struct Op {
  float w[9];
  float inv_diag, omega;
};

// One color step: the cells of quarter (PJ, PI), then a barrier.
template <int kPat, int PJ, int PI>
__device__ void color_step(float* U, const float* B, const Grid& g,
                           const Op& op) {
  int off[9];
  neighbour_offsets<PJ, PI>(g, off);
  each_real<PJ, PI>(g, [&](int c, int, int) {
    const float r = B[c] - stencil_sum<kPat>(U, op.w, off, c);
    U[c] = U[c] + op.omega * (r * op.inv_diag);
  });
  __syncthreads();
}

template <int kPat>
__device__ void sweeps_at(float* U, const float* B, const Grid& g,
                          const Op& op, int sweeps, int symmetric) {
  for (int s = 0; s < sweeps; ++s) {
    color_step<kPat, 0, 0>(U, B, g, op);
    color_step<kPat, 0, 1>(U, B, g, op);
    color_step<kPat, 1, 0>(U, B, g, op);
    color_step<kPat, 1, 1>(U, B, g, op);
    if (symmetric) {
      color_step<kPat, 1, 1>(U, B, g, op);
      color_step<kPat, 1, 0>(U, B, g, op);
      color_step<kPat, 0, 1>(U, B, g, op);
      color_step<kPat, 0, 0>(U, B, g, op);
    }
  }
}

// B <- b - A u on the real cells of quarter (PJ, PI), u to the workspace.
template <int kPat, int PJ, int PI>
__device__ __forceinline__ void residual_quarter(const float* U, float* B,
                                                 const Grid& g, const Op& op,
                                                 float* ws_u) {
  int off[9];
  neighbour_offsets<PJ, PI>(g, off);
  each_real<PJ, PI>(g, [&](int c, int j, int i) {
    B[c] = B[c] - stencil_sum<kPat>(U, op.w, off, c);
    ws_u[j * g.n + i] = U[c];
  });
}

template <int kPat>
__device__ void residual_at(const float* U, float* B, const Grid& g,
                            const Op& op, float* ws_u) {
  residual_quarter<kPat, 0, 0>(U, B, g, op, ws_u);
  residual_quarter<kPat, 0, 1>(U, B, g, op, ws_u);
  residual_quarter<kPat, 1, 0>(U, B, g, op, ws_u);
  residual_quarter<kPat, 1, 1>(U, B, g, op, ws_u);
  __syncthreads();
}

__device__ Op level_op(const Params& p, int k) {
  Op op;
#pragma unroll
  for (int m = 0; m < 9; ++m) op.w[m] = p.w[k][m];
  op.inv_diag = p.inv_diag[k];
  op.omega = p.omega;
  return op;
}

__device__ void level_sweeps(const Params& p, int k, float* U,
                             const float* B, const Grid& g, int sweeps) {
  const Op op = level_op(p, k);
  switch (p.pattern[k]) {
    case amg::kFivePoint:
      sweeps_at<amg::kFivePoint>(U, B, g, op, sweeps, p.symmetric);
      break;
    case amg::kNinePoint:
      sweeps_at<amg::kNinePoint>(U, B, g, op, sweeps, p.symmetric);
      break;
    default:
      sweeps_at<amg::kAnyWeights>(U, B, g, op, sweeps, p.symmetric);
  }
}

__device__ void level_residual(const Params& p, int k, const float* U,
                               float* B, const Grid& g, float* ws_u) {
  const Op op = level_op(p, k);
  switch (p.pattern[k]) {
    case amg::kFivePoint:
      residual_at<amg::kFivePoint>(U, B, g, op, ws_u);
      break;
    case amg::kNinePoint:
      residual_at<amg::kNinePoint>(U, B, g, op, ws_u);
      break;
    default:
      residual_at<amg::kAnyWeights>(U, B, g, op, ws_u);
  }
}

// x[0] / 2 + x[s] + x[2 s] / 2 as a GEMM accumulates it (see the top)
__device__ __forceinline__ float restrict3(const float* x, int s) {
  float acc = 0.f;
  acc = __fmaf_rn(0.5f, x[0], acc);
  acc = __fmaf_rn(1.f, x[s], acc);
  return __fmaf_rn(0.5f, x[2 * s], acc);
}

// Row j of P1 x, P1 (n x nc): x(a) is the coarse value a (0 <= a < nc).
template <class X>
__device__ __forceinline__ float prolong_at(int j, int nc, X x) {
  if (j & 1) return x((j - 1) / 2);
  const int a = j / 2;
  float acc = 0.f;
  if (a >= 1) acc = __fmaf_rn(0.5f, x(a - 1), acc);
  if (a < nc) acc = __fmaf_rn(0.5f, x(a), acc);
  return acc;
}

// f(row, col) over a rows x cols row-major array, a thread a column (its
// low log2_up(cols) bits) of every kThreads >> log2_up(cols)-th row.
template <class F>
__device__ __forceinline__ void each_entry(int rows, int cols, F f) {
  const int s = log2_up(cols);
  const int col = threadIdx.x & ((1 << s) - 1);
  if (col >= cols) return;
  for (int row = threadIdx.x >> s; row < rows; row += kThreads >> s)
    f(row, col);
}

__global__ void __launch_bounds__(kThreads, 1)
masked_down_leg_kernel(const __grid_constant__ Params p) {
  extern __shared__ float masked_smem[];
  float* U = masked_smem;
  Grid g(p.side);
  float* T = masked_smem + 2 * g.cells();   // P1^T r, (n-1)/2 x n
  float* B = U + g.cells();
  zero_pads(U, g);
  each_real4(g, [&](int c, int j, int i) {
    U[c] = p.u[j * g.n + i];
    B[c] = p.b[j * g.n + i];
  });
  __syncthreads();
  for (int k = 0; k < p.levels; ++k) {
    level_sweeps(p, k, U, B, g, p.sweeps);
    level_residual(p, k, U, B, g, p.ws + ws_offset(p.side, k));
    const int n = g.n;
    const int nc = (n - 1) / 2;
    each_entry(nc, n, [&](int a, int i) {
      T[a * n + i] = __fmaf_rn(
          0.5f, B[g.at(2 * a + 2, i)],
          __fmaf_rn(1.f, B[g.at(2 * a + 1, i)],
                    __fmaf_rn(0.5f, B[g.at(2 * a, i)], 0.f)));
    });
    __syncthreads();
    if (k == p.levels - 1) {
      each_entry(nc, nc, [&](int a, int b) {
        p.out[a * nc + b] = restrict3(T + a * n + 2 * b, 1);
      });
      break;
    }
    // the next level: u = 0, b = (P1^T r) P1, also to the workspace
    g = Grid(nc);
    B = U + g.cells();
    for (int c = threadIdx.x; c < g.cells(); c += kThreads) U[c] = 0.f;
    float* ws_b = p.ws + ws_offset(p.side, k + 1) + nc * nc;
    each_real4(g, [&](int c, int a, int b) {
      const float v = restrict3(T + a * n + 2 * b, 1);
      B[c] = v;
      ws_b[a * nc + b] = v;
    });
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
masked_up_leg_kernel(const __grid_constant__ Params p) {
  extern __shared__ float masked_smem[];
  float* U = masked_smem;
  const Grid g0(p.side);
  float* V = masked_smem + 2 * g0.cells();  // P1 uc, n x (n-1)/2
  int side = p.side;
  for (int k = 0; k < p.levels - 1; ++k) side = (side - 1) / 2;
  for (int k = p.levels - 1; k >= 0; --k) {
    const Grid g(side);
    const int n = g.n;
    const int nc = (n - 1) / 2;
    const Grid gc(nc);
    const bool coarsest = k == p.levels - 1;
    each_entry(n, nc, [&](int j, int b) {
      V[j * nc + b] = prolong_at(j, nc, [&](int a) {
        return coarsest ? p.uc[a * nc + b] : U[gc.at(a, b)];
      });
    });
    __syncthreads();
    const int off = ws_offset(p.side, k);
    const float* ws_u = p.ws + off;
    const float* b_k = k == 0 ? p.b : p.ws + off + n * n;
    float* B = U + g.cells();
    zero_pads(U, g);
    each_real4(g, [&](int c, int j, int i) {
      const float* v = V + j * nc;
      const float corr = prolong_at(i, nc, [&](int a) { return v[a]; });
      U[c] = ws_u[j * n + i] + corr;
      B[c] = b_k[j * n + i];
    });
    __syncthreads();
    level_sweeps(p, k, U, B, g, p.sweeps);
    side = 2 * side + 1;
  }
  each_real4(g0, [&](int c, int j, int i) { p.out[j * g0.n + i] = U[c]; });
}

// Shared memory of a cycle entered at side n: u and b, then the scratch.
size_t smem_bytes(int n) {
  const size_t P = (n + 1) / 2 + 1;
  return (2 * 4 * P * P + (size_t)n * ((n - 1) / 2)) * sizeof(float);
}

int launch(const MaskedCall* a, bool down) {
  if (a->levels < 1 || a->levels > kMaxLevels || a->sweeps < 0)
    return (int)cudaErrorInvalidValue;
  int n = a->side;
  for (int k = 0; k < a->levels; ++k) {
    if (n < 3 || n % 2 == 0) return (int)cudaErrorInvalidValue;
    n = (n - 1) / 2;
  }
  const size_t smem = smem_bytes(a->side);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  Params p;
  p.u = a->u;
  p.b = a->b;
  p.uc = a->uc;
  p.ws = a->ws;
  p.out = a->out;
  p.side = a->side;
  p.levels = a->levels;
  p.sweeps = a->sweeps;
  p.symmetric = a->symmetric;
  p.omega = a->omega;
  for (int k = 0; k < kMaxLevels; ++k) {
    for (int m = 0; m < 9; ++m) p.w[k][m] = a->w[k][m];
    p.inv_diag[k] = a->inv_diag[k];
    // the patterns leave out a term only where its weight is 0; the
    // diagonal is always summed
    p.pattern[k] = a->w[k][4] != 0.f ? amg::weight_pattern(a->w[k])
                                     : amg::kAnyWeights;
  }
  static std::atomic<unsigned long long> down_set{0}, up_set{0};
  cudaError_t err = down
      ? amg::set_smem_once(masked_down_leg_kernel, 232448, down_set)
      : amg::set_smem_once(masked_up_leg_kernel, 232448, up_set);
  if (err != cudaSuccess) return (int)err;
  if (down)
    masked_down_leg_kernel<<<1, kThreads, smem, a->stream>>>(p);
  else
    masked_up_leg_kernel<<<1, kThreads, smem, a->stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int amg_masked_down_leg(const MaskedCall* a) {
  return launch(a, true);
}

extern "C" int amg_masked_up_leg(const MaskedCall* a) {
  return launch(a, false);
}
