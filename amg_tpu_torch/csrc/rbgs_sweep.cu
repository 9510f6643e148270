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
// color becomes u + omega * ((b - sum_off w * u_nbr) * inv_diag - u), with
// neighbours outside the grid reading 0 (Dirichlet). Operation order is
// the plain version's (amg_tpu_torch/ops/kernels/rbgs.py
// fused_gs4_sweep_plain, constant operand): di outer, dj inner, zero
// weights skipped; built with -fmad=false, so the kernel gives the plain
// version's bits.
//
// Bound on the card: device memory. u and b read once and u written once:
// 12 B a cell; at n = 4095 (16.8 M cells) 201 MB -> 0.060 ms at the
// 3.35 TB/s data-sheet rate.
//
// Design: K6's window and regions (rbgs_common.cuh: the exact
// even-aligned ring, 4 / 2 / 8 / 6 symmetric and 2 / 2 / 4 / 4 forward,
// and the per-step update regions, 2.34 updates a cell for the symmetric
// sweep's 2), with a thread map of its own. With no planes to hold in
// registers, a step is bound by the SM's instruction issue and
// shared-memory reads, and a step updates the cells of one column parity
// only: on K6's map (a thread per window column) half of every warp's
// lanes idle at every step. Here u's and b's windows sit in shared memory
// split by column parity (even columns in one array, odd in the other, 16
// banks apart), and a thread owns a column pair: at each step all 32
// lanes of a warp update 32 neighbouring cells of one row and parity,
// reading each neighbour from one of the two arrays, conflict-free. A
// 32 x 114 tile makes the symmetric window 128 columns wide, two warps a
// row (forward: 122); 2 row phases, so a thread updates up to 9 rows a
// step (independent work while shared memory answers); 128 threads, 5
// blocks an SM. Design bytes: u and b windows 2 x 4 x 1.33, u written 4:
// about 14.7 B a cell, 0.073 ms at n = 4095 (L2 catches most of the
// ring's reread). The weights and the host-rounded inv_diag are kernel
// arguments (the constant bank); the weights' zero pattern (5-point,
// 9-point, other) is a template parameter, so no term tests its weight at
// run time on the fine levels.
// Out of place: the ring reads the pre-sweep input, so the output is a
// separate buffer. Other tiles (32 x 50, 40 x 114), row phases (1, 4, 8,
// 16) and blocks an SM, and K6's own map, were slower on the H100
// (PERF.md lists them).

#include "packed_common.cuh"
#include "rbgs_common.cuh"

namespace {

// The tile (rows, columns), the row phases and the blocks an SM.
constexpr int kTJ = 32;
constexpr int kTI = 114;
constexpr int kNY = 2;
constexpr int kBlocks = 5;

using rbgs::Phase;

// K6's window with the column-parity split: a parity array holds the
// window's even (or odd) columns, row stride S; the odd array starts OFF
// words after the even one, 16 banks apart. A thread per column pair:
// NX lanes, a multiple of 32.
template <int TJ_, int TI_, int NY_, bool kSym_>
struct Split : rbgs::Tiling<TJ_, TI_, NY_, kSym_> {
  using Base = rbgs::Tiling<TJ_, TI_, NY_, kSym_>;
  static constexpr int HW = (Base::W + 1) / 2;   // columns of one parity
  static constexpr int NX = (HW + 31) / 32 * 32;
  static constexpr int NT = NX * NY_;
  static constexpr int S = NX;
  static constexpr int OFF = Base::H * S + 16;
  static constexpr int FIELD = 2 * OFF;
  static_assert(2 * FIELD * sizeof(float) <= 48 * 1024, "static smem");
};

// Window column x of row r in the split layout.
template <class V>
__device__ __forceinline__ int split_at(int r, int x) {
  return (x & 1) * V::OFF + r * V::S + (x >> 1);
}

// U, Bw <- u's and b's windows of the block's tile (Jt, It) in the split
// layout, 0 outside [0, n)^2, as 4-byte cp.async copies in flight (a row
// of an odd n is not 16-byte aligned); neighbouring threads read
// neighbouring columns.
template <class V>
__device__ __forceinline__ void load_split(float* U, float* Bw,
                                           const float* __restrict__ u,
                                           const float* __restrict__ b,
                                           int n, int Jt, int It) {
  const int tid = threadIdx.x + V::NX * threadIdx.y;
  const int j0 = Jt - V::TOP;
  const int i0 = It - V::LEFT;
  constexpr int N = V::H * V::W;
#pragma unroll 4
  for (int L = tid; L < N; L += V::NT) {
    const int r = L / V::W;
    const int x = L - r * V::W;
    const int j = j0 + r;
    const int i = i0 + x;
    const bool in = j >= 0 && j < n && i >= 0 && i < n;
    const size_t g = in ? (size_t)j * n + i : 0;
    const int s = split_at<V>(r, x);
    const unsigned su = (unsigned)__cvta_generic_to_shared(U + s);
    const unsigned sb = (unsigned)__cvta_generic_to_shared(Bw + s);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(su), "l"(u + g), "r"(in ? 4 : 0) : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(sb), "l"(b + g), "r"(in ? 4 : 0) : "memory");
  }
}

// One color step, column parity PI, on the rows of load phase PH: thread
// (cp, y) updates window column 2 cp + PI of rows R0 + 2 (y + NY k).
template <class V, int PH, int PI, int kPat>
__device__ __forceinline__ void const_step(float* U, const float* B,
                                           const amg::Stencil& st, int n,
                                           int Jt, int It) {
  using F = Phase<V, PH>;
  constexpr int lm = rbgs::margin(V::kSym, PH, PI ? 4 : 2);
  constexpr int rm = rbgs::margin(V::kSym, PH, PI ? 5 : 3);
  const int cp = threadIdx.x;
  const int t = 2 * cp + PI - V::LEFT;           // tile column
  const int i = It + t;
  if (t < -lm || t > V::TI - 1 + rm || i < 0 || i >= n) return;
  float* X = U + PI * V::OFF;                    // this parity's columns
  const float* Y = U + (1 - PI) * V::OFF;        // the other parity's
  const float* BX = B + PI * V::OFF;
#pragma unroll
  for (int k = 0; k < F::K; ++k) {
    const int q = (int)threadIdx.y + V::NY * k;
    const int j = Jt + F::R0 + 2 * q;
    if (q >= F::NR || j >= n) break;
    if (j < 0) continue;
    const int r = V::TOP + F::R0 + 2 * q;
    float acc = 0.f;
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj) {
        if (dj == 0 && di == 0) continue;
        if (kPat == amg::kFivePoint && dj != 0 && di != 0) continue;
        const float w = st.w[(dj + 1) * 3 + di + 1];
        if (kPat == amg::kAnyWeights && w == 0.f) continue;
        // column 2 cp + PI + di: this parity at cp (di = 0), else the
        // other parity at cp - 1 + PI (di = -1) or cp + PI (di = +1)
        const float x = di == 0
            ? X[(r + dj) * V::S + cp]
            : Y[(r + dj) * V::S + cp + PI + (di < 0 ? -1 : 0)];
        acc = acc + w * x;
      }
    }
    const int L = r * V::S + cp;
    const float uu = X[L];
    const float delta = (BX[L] - acc) * st.inv_diag - uu;
    X[L] = uu + st.omega * delta;
  }
}

// The tile: window rows TOP .. TOP + TJ - 1, columns LEFT .. LEFT + TI - 1
// to out, neighbouring threads on neighbouring columns.
template <class V>
__device__ __forceinline__ void store_split(const float* U,
                                            float* __restrict__ out, int n,
                                            int Jt, int It) {
  const int tid = threadIdx.x + V::NX * threadIdx.y;
  constexpr int N = V::TJ * V::TI;
#pragma unroll 4
  for (int L = tid; L < N; L += V::NT) {
    const int r = L / V::TI;
    const int t = L - r * V::TI;
    const int j = Jt + r;
    const int i = It + t;
    if (j < n && i < n)
      out[(size_t)j * n + i] = U[split_at<V>(V::TOP + r, V::LEFT + t)];
  }
}

template <class V, int kPat>
__global__ void __launch_bounds__(V::NT, kBlocks)
rbgs_const_kernel(const float* __restrict__ u, const float* __restrict__ b,
                  float* __restrict__ out, int n, amg::Stencil st) {
  __shared__ float U[V::FIELD];
  __shared__ float Bw[V::FIELD];
  const int Jt = (int)blockIdx.y * V::TJ;
  const int It = (int)blockIdx.x * V::TI;
  load_split<V>(U, Bw, u, b, n, Jt, It);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const_step<V, 0, 0, kPat>(U, Bw, st, n, Jt, It);         // step 0: 00
  __syncthreads();
  const_step<V, 0, 1, kPat>(U, Bw, st, n, Jt, It);         // step 1: 01
  __syncthreads();
  const_step<V, 1, 0, kPat>(U, Bw, st, n, Jt, It);         // step 2: 10
  __syncthreads();
  const_step<V, 1, 1, kPat>(U, Bw, st, n, Jt, It);         // step 3: 11
  __syncthreads();
  if constexpr (V::kSym) {
    const_step<V, 1, 1, kPat>(U, Bw, st, n, Jt, It);       // step 4: 11
    __syncthreads();
    const_step<V, 1, 0, kPat>(U, Bw, st, n, Jt, It);       // step 5: 10
    __syncthreads();
    const_step<V, 2, 1, kPat>(U, Bw, st, n, Jt, It);       // step 6: 01
    __syncthreads();
    const_step<V, 2, 0, kPat>(U, Bw, st, n, Jt, It);       // step 7: 00
    __syncthreads();
  }
  store_split<V>(U, out, n, Jt, It);
}

template <bool kSym, int kPat>
int launch(const float* u, const float* b, float* out, int n,
           const amg::Stencil& st, cudaStream_t stream) {
  using V = Split<kTJ, kTI, kNY, kSym>;
  const dim3 grid((n + V::TI - 1) / V::TI, (n + V::TJ - 1) / V::TJ);
  rbgs_const_kernel<V, kPat><<<grid, dim3(V::NX, V::NY), 0, stream>>>(
      u, b, out, n, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int amg_rbgs_sweep_const(const float* u, const float* b,
                                    float* out, int n, const float* w9,
                                    float inv_diag, float omega,
                                    int symmetric, cudaStream_t stream) {
  const amg::Stencil st = amg::make_stencil(w9, inv_diag, omega);
  return amg::by_weight_pattern(w9, [&](auto pat) {
    constexpr int kPat = decltype(pat)::value;
    return symmetric ? launch<true, kPat>(u, b, out, n, st, stream)
                     : launch<false, kPat>(u, b, out, n, st, stream);
  });
}
